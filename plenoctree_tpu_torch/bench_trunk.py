"""The noise floor of the fused trunk's gradient check, per variant.

    python -m plenoctree_tpu_torch.bench_trunk [--rows 10000] [--seeds 6] [--device cpu]
    python -m plenoctree_tpu_torch.bench_trunk --decode_check [--rows 4096]

For each variant of the trunk (the default, the in-kernel posenc, the SH
decode, both) at the flagship width (8x256, skip 4, d_in 63, head 1 + 48,
N(0, 0.05) biases) and --rows rows, over --seeds input draws made as
chip_smoke.py's phase 7 makes them (seed + rows): the per-array max
relative gradient error (max |dW - dW_ref| / max |dW_ref|, the measure of
chip_smoke.py's TRUNK_GRAD_RTOL) of the plain f32 version, and on the card
of the backward kernel, each against an f64 evaluation of the same
algorithm (the same bf16 rounding points, every sum in float64), and of
the kernel against the plain version. Where the plain version's own
distance from the f64 evaluation reaches the bound, the check at that row
count measures rounding noise, not the kernel. (chip_smoke.py times the
kernels.)

Prints one JSON line per variant.

--decode_check asks where the SH decode's backward rounds: for each seed,
on the SH16 head with a basis of N(0, 1) values (tests/test_torch_gpu.py's
draws) and with a degree-3 SH basis of random unit directions, the kernel
with the in-kernel decode against the default kernel fed the decoded
cotangent g_rgb[:, c] * basis[:, k] formed in f32 beforehand (the JAX
kernel's rounding points: that f32 product, then bf16 at each matmul, the
bias sum in f32), bitwise; and each one's distance from the f64 evaluation
beside the plain version's. One JSON line per basis.
"""

import argparse
import json
import sys

import numpy as np
import torch

from plenoctree_tpu_torch.kernels import fused_mlp
from plenoctree_tpu_torch.models.params import init_trunk_params, trunk_weights
from plenoctree_tpu_torch.ops.posenc import posenc
from plenoctree_tpu_torch.ops.sh import sh_basis

VARIANTS = {"default": (None, 0), "posenc": ((0, 10), 0), "sh": (None, 16),
            "posenc+sh": ((0, 10), 16)}
# The gradient check at small row counts (the 10,000-row sparsity pass).
# There a fixed bound measures rounding noise: the plain f32 version itself
# lies 1.1-2.8e-2 from the f64 evaluation over six seeds (PERF.md),
# against chip_smoke.py's TRUNK_GRAD_RTOL of 2e-2. So the kernel's distance
# from the f64 evaluation may be at most this many times the plain
# version's distance on the same draws: both round at the same bf16
# points, so a sound kernel is as close to the exact algorithm as the plain
# version, seed by seed either may be closer, and over 12 seed x variant
# pairs on the H100 the largest kernel/plain ratio was 1.73 (the SH decode,
# seed 4: 1.89e-2 against 1.09e-2). A dropped or 5%-scaled gradient array
# moves the kernel's distance far past it at small widths.
TRUNK_SMALL_ROW_FACTOR = 2.0


def bwd_f64(flat_w, x, g_sigma, g_rgb, meta, basis=None):
    """fused_trunk_bwd_reference with every product and sum in float64: the
    same bf16 roundings of the encoded x, the activations and every
    cotangent; f32 where the algorithm holds f32 (the activations' f32
    pre-activation before their bf16 rounding)."""
    depth, skip, width = meta["depth"], meta["skip_layer"], meta["width"]
    sh = meta.get("sh_dim") or 0
    bf = lambda t: t.to(torch.bfloat16).double()
    dot = lambda a, b: bf(a) @ bf(b)
    xb = bf(fused_mlp._encoded(x, meta))
    h, acts = xb, []
    for i in range(depth):
        pre = dot(h, flat_w[2 * i]) + flat_w[2 * i + 1].double().reshape(1, -1)
        h = bf(torch.relu(pre).float())
        acts.append(h)
        if i % skip == 0 and i > 0:
            h = torch.cat([h, xb], -1)
    g_rgb = g_rgb.double()
    if sh:
        g_rgb = (g_rgb[:, :, None] * basis.double()[:, None, :]).reshape(g_rgb.shape[0], -1)
    g = torch.cat([g_sigma.double(), g_rgb], -1)
    grads = [None] * len(flat_w)

    def accum(i, dpre):
        h_in = acts[i - 1] if i > 0 else xb
        if i > 0 and fused_mlp._layer_has_x(i, skip):
            h_in = torch.cat([h_in, xb], -1)
        grads[2 * i] = dot(h_in.t(), dpre)
        grads[2 * i + 1] = dpre.sum(0).reshape(flat_w[2 * i + 1].shape)

    accum(depth, g)
    dh = dot(g, flat_w[2 * depth].t())[:, :width]
    for i in range(depth - 1, -1, -1):
        dpre = dh * (acts[i] > 0)
        accum(i, dpre)
        if i > 0:
            dh = dot(dpre, flat_w[2 * i].t())[:, :width]
    return grads


def rel_errs(got, want):
    """Per-array max |got - want| / max |want| (float64)."""
    return [float((a.double() - b.double()).abs().max() / b.double().abs().max())
            for a, b in zip(got, want)]


def within_noise_floor(got, plain, exact, factor=TRUNK_SMALL_ROW_FACTOR):
    """The small-row gradient check: (distance of `got` from the f64
    evaluation `exact`, the plain version's distance, whether the first is
    at most `factor` times the second); distances are the max over arrays
    of rel_errs."""
    d_got, d_plain = max(rel_errs(got, exact)), max(rel_errs(plain, exact))
    return d_got, d_plain, d_got <= factor * d_plain


def inputs(n, seed, pe, sh, device, n_rgb=48):
    """Phase 7's draws: points, the basis of random directions (degree
    sqrt(sh) - 1: 3 for sh 16, 4 for sh 25), cotangents of the n_rgb head
    columns (3 decoded colours with the SH decode)."""
    rng = np.random.default_rng(seed + n)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    pts = t(rng.uniform(-1.5, 1.5, (n, 3)))
    x = pts if pe else posenc(pts, 0, 10)
    basis = None
    if sh:
        dirs = t(rng.normal(size=(n, 3)))
        basis = sh_basis(int(round(sh ** 0.5)) - 1, dirs / dirs.norm(dim=-1, keepdim=True))
    gs = t(rng.normal(size=(n, 1)) * 1e-3)
    gr = t(rng.normal(size=(n, 3 if sh else n_rgb)) * 1e-3)
    return x, basis, gs, gr


def run(rows, seeds, device):
    on_card = device.type == "cuda"
    params = init_trunk_params(np.random.default_rng(0), 63, 8, 256, 4, 1, 48, bias_std=0.05)
    out = []
    for name, (pe, sh) in VARIANTS.items():
        flat, meta = trunk_weights(params, 4, device, pe, sh)
        res = {"variant": name, "rows": rows, "device": str(device),
               "plain_vs_f64": [], "kernel_vs_f64": [], "kernel_vs_plain": []}
        for seed in range(seeds):
            x, basis, gs, gr = inputs(rows, seed, pe, sh, device)
            exact = bwd_f64(flat, x, gs, gr, meta, basis)
            plain = fused_mlp.fused_trunk_bwd_reference(flat, x, gs, gr, meta, basis)
            res["plain_vs_f64"].append(max(rel_errs(plain, exact)))
            if on_card:
                kern = fused_mlp.fused_trunk_bwd(flat, x, gs, gr, meta, basis)
                res["kernel_vs_f64"].append(max(rel_errs(kern, exact)))
                res["kernel_vs_plain"].append(max(rel_errs(kern, plain)))
        if on_card:
            res["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(res), flush=True)
        out.append(res)
    return out


def decoded_cotangent(g_rgb, basis):
    """g_rgb[:, c] * basis[:, k] in f32, column c * K + k: the cotangent of
    the raw head columns that the SH decode's backward forms."""
    return (g_rgb[:, :, None] * basis[:, None, :]).reshape(g_rgb.shape[0], -1)


def decode_check(rows, seeds, device):
    """The --decode_check lines (see the module docstring)."""
    params = init_trunk_params(np.random.default_rng(rows), 63, 8, 256, 4, 1, 48, bias_std=0.05)
    flat_sh, meta_sh = trunk_weights(params, 4, device, None, 16)
    flat, meta = trunk_weights(params, 4, device, None, 0)
    out = []
    for basis_kind in ("normal", "sh3"):
        res = {"basis": basis_kind, "rows": rows, "device": str(device), "bitwise": [],
               "ratio_decode": [], "ratio_default": [], "plain_vs_f64": []}
        for seed in range(seeds):
            rng = np.random.default_rng(rows + 1 + seed)
            t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
            x = t(rng.normal(size=(rows, 63)))
            if basis_kind == "normal":
                basis = t(rng.normal(size=(rows, 16)))
            else:
                dirs = t(rng.normal(size=(rows, 3)))
                basis = sh_basis(3, dirs / dirs.norm(dim=-1, keepdim=True))
            gs, gr = t(rng.normal(size=(rows, 1))), t(rng.normal(size=(rows, 3)))
            g48 = decoded_cotangent(gr, basis)
            exact = bwd_f64(flat_sh, x, gs, gr, meta_sh, basis)
            plain = fused_mlp.fused_trunk_bwd_reference(flat_sh, x, gs, gr, meta_sh, basis)
            k_sh = fused_mlp.fused_trunk_bwd(flat_sh, x, gs, gr, meta_sh, basis)
            k_def = fused_mlp.fused_trunk_bwd(flat, x, gs, g48, meta)
            d_plain = max(rel_errs(plain, exact))
            res["bitwise"].append(all(torch.equal(a, b) for a, b in zip(k_sh, k_def)))
            res["plain_vs_f64"].append(d_plain)
            res["ratio_decode"].append(max(rel_errs(k_sh, exact)) / d_plain)
            res["ratio_default"].append(max(rel_errs(k_def, exact)) / d_plain)
        res["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(res), flush=True)
        out.append(res)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--decode_check", action="store_true",
                    help="the SH decode's backward against the default kernel (card only)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device (use --device cpu for the plain "
                           "version's noise alone)")
    if args.decode_check:
        if device.type != "cuda":
            raise RuntimeError("--decode_check compares kernels: it needs --device cuda")
        decode_check(args.rows or 4096, args.seeds, device)
    else:
        run(args.rows or 10000, args.seeds, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
