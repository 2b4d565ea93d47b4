"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: tile serving,
NeRF-SH training, PlenOctree conversion (extraction, tile optimization),
the gather probes, and the exact march (evaluation and optimization).

    python3 chip_smoke.py

Phases, one line each with its wall time:
  1. device: the card's name and power limit;
  2. kernel build: nvcc builds csrc/tile_composite.cu, csrc/fused_mlp.cu
     and csrc/gather_sum.cu into build/kernels/, in parallel (registers and
     spills per kernel);
  3. model: bakes the synthetic scene into an SH16 (data_dim 49) octree at
     depth 7 (seeded N(0, 0.05) higher-order SH coefficients) and saves it
     as build/smoke/tree.npz; then renders the CLIs' synthetic views at
     200x200 once (memoized: every later CLI run reuses them);
  4. kernel vs plain: the CUDA tile kernel against composite_tiles_reference
     on the phase-1 inputs of one 800x800 pose, with both times and the
     time of the tile inputs (ray generation + phase 1) for that pose;
  5. main path: the eval CLI (`plenoctree_tpu_torch.cli.evaluate --fast_eval`)
     in-process on the synthetic test views at 200x200; its kernel launch
     count must be > 0;
  6. serving: a 24-pose 800x800 orbit, every frame timed (regrowth included);
  7. trunk kernel vs plain: the fused trunk's forward and backward kernels
     against their plain versions at the fine MLP's bench shape (786,432 x
     63 -> 8x256 -> 1 + 48, seeded glorot weights and N(0, 0.05) biases,
     so the bias adds are checked) and at 10,000 rows (the sparsity pass,
     a ragged tile), with errors and kernel / plain ms;
  8. train main path: the train CLI (`plenoctree_tpu_torch.cli.train`)
     in-process, 200 steps of the blender SH16 config at batch 4096 with the
     fused kernels; both launch counts must be > 0, the train PSNR must
     rise, and the checkpoint must restore with equal params;
  9. extract main path: the extract CLI (`plenoctree_tpu_torch.cli.extract`)
     in-process on phase 8's checkpoint_200 with the same model flags and
     octree/config/syn_sh16.json's extraction flags at init_grid_depth 8;
     the trunk forward kernel's launch count must be > 0 and the tree must
     save and reload; leaf count, eval PSNR (through the exact march, the
     JAX CLI's default) and wall-clock per step; then one 800x800 exact
     march frame of that tree (its accel grid is budgeted: a residual
     descent), timed;
 10. train throughput: `plenoctree_tpu_torch.bench` in-process at batch
     4096: rays/s, ms/step, peak memory, and the trunk kernels' share of
     device time from one torch.profiler window;
 11. tile bwd kernel vs plain: on the depth-7 tree in exact mode (the
     optimizer's keep_all index), one 800x800 pose: the tile kernel's
     exact-mode forward against composite_tiles_reference (KERNEL_ATOL),
     then, on that forward output and a seeded cotangent, the tile backward
     kernel against composite_tiles_bwd_reference: errors per field group,
     the difference between two kernel runs, times and the pieces total;
 12. optimize throughput: ms per optimizer step at 800x800 on that
     optimizer (median of 12 steps, CUDA events), peak memory, and the
     step's device time by kernel group (forward, backward, segment-sum,
     gather, other) from one torch.profiler window over 3 real steps, with
     the idle share and the tile inputs' time alone;
 13. optimize main path: the optimize CLI (`plenoctree_tpu_torch.cli.optimize
     --tile_opt`) in-process on the depth-7 tree with its DC colour
     coefficients washed to 0, 12 train / 4 val synthetic views at 200x200,
     syn_sh16's optimization flags for 2 epochs; the backward kernel's
     launch count must be > 0, the best val PSNR must beat the initial one
     by OPT_MIN_GAIN_DB, tree_opt.npz must load; then the eval CLI on it;
     then a control, the same CLI run at -lr (the gradient's sign flipped),
     which must not pass the gain check;
 14. gather kernel vs plain, and the probes: every gather_sum variant (the
     three Pallas probes' functions, and the shared-memory table) at K 256
     x R 8192 indices into a 32k-row table, D 56, against its plain version
     and a float64 sum (GATHER tolerance), reruns bitwise equal, with ms,
     plain ms, embedding_bag ms and bound; then the probes' entry point
     (`plenoctree_tpu_torch.bench_gather.run`) in process, its kernel
     launches counted: one ns/row line per case;
 15. march full width: VolumeRenderer on the depth-7 tree, two 800x800
     orbit poses, exact (step 1e-5) and fast: ms/frame, K estimated and
     after regrowth, segment budget, accel level and reso, peak memory; the
     fast frame of pose 0 must match the served tile frame of that pose to
     MARCH_SERVED_MIN_PSNR;
 16. exact eval main path: the eval CLI without --fast_eval on the depth-7
     tree at 200x200, 4 views, with seeded random LPIPS weights: PSNR/SSIM
     above phase 5's floor, no tile kernel launch, LPIPS finite and equal
     on the card and the CPU for one image pair within LPIPS_RTOL (TF32 off);
 17. march optimize throughput: TwoPhaseRenderer.loss_grad over chunks of
     rays (as the optimize CLI sizes them on this card) + the SGD update at
     800x800 on the depth-7 tree: median ms per step, peak memory, and the
     device time by part (march, shade forward + backward, update) and idle
     share of one chunk + update from a profiler window;
 18. march optimize main path: the optimize CLI without --tile_opt on phase
     13's washed tree with the same flags: no tile kernel launch, the best
     val PSNR beats the initial one by OPT_MIN_GAIN_DB, tree_opt_march.npz
     loads.

A "total" line gives the wall time of the run before the kernels line.
Each kernel in the final JSON line carries its bound: the larger of the
bytes it must move (each input read once, each output written once; for the
tile kernels the soa blocks its pieces name, once each; for gather_sum the
index stream and each distinct row once) over 3.35 TB/s and
the operations this run's data needs over the card's peak for their type
(989 TFLOP/s bf16 tensor cores for the trunk, 67 TFLOP/s f32 for the tile
kernels, counting only the slab tests of live rows with sigma > 0 against
the rays of their pieces' quad groups), and, for the trunk, the time of the
same MLP as a chain of bf16 torch.nn.functional.linear + relu calls, for
gather_sum the time of torch.nn.functional.embedding_bag(mode="sum").

It exits non-zero, and prints no result line, when CUDA is unavailable or
any phase fails. The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TREE_DEPTH = 7
BASIS_DIM = 16  # SH degree 3: 3 * 16 + 1 = 49 floats per leaf
SH_NOISE = 0.05
SEED = 0
RES = 800
EVAL_RES = 200
N_ORBIT = 24
# Kernel vs plain version, same inputs: outputs lie in [0, 1] and both sum
# up to a few hundred f32 terms per ray, in different orders (sequential
# in the kernel, matmul in the plain version), so they may differ by a few
# hundred f32 ulps; hit tests and precedence are computed identically.
KERNEL_ATOL = 5e-5
# Fused trunk kernel vs plain version: the same bf16 rounding points, f32
# sums in another order. An activation whose f32 pre-activation lies near
# a bf16 rounding boundary rounds the other way and the difference
# propagates through the later layers. Measured with TRUNK_BIAS_STD
# biases: 3.0e-3 max abs at 786,432 rows, 2.3e-3 at 10,000, on outputs of
# magnitude ~0.8 (H100 80GB HBM3, 700 W; the JAX tests allow 2e-2). A
# dropped or misplaced bias add moves outputs by ~0.05.
TRUNK_FWD_ATOL = 6e-3
# Per-layer max |dW_kernel - dW_plain| / max |dW_plain| (weights and
# biases): each cotangent is rounded to bf16 before every product, and a
# one-ulp difference in dh rounds a dpre element the other way, which then
# feeds every layer below. Measured with TRUNK_BIAS_STD biases: 8.2e-3 at
# 786,432 rows, 1.0e-2 at 10,000 (same card; the JAX tests allow 0.05).
TRUNK_GRAD_RTOL = 2e-2
TRUNK_BIAS_STD = 0.05  # trained biases are non-zero: a dropped bias add must show
TRUNK_ROWS = (786432, 10000)  # the fine MLP's rows at the bench config; sparsity rows
TRAIN_STEPS = 200
BENCH_BATCH = 4096
BENCH_STEPS = 100
# Tile backward kernel vs plain version, per field group relative to the
# group's largest |gradient|: the same hit tests and precedence, sums in
# another order (measured 2.0e-7 at 800x800, H100 80GB HBM3, 700 W); two
# kernel runs differ by the order of their float atomics (measured 1.2e-7).
BWD_RTOL = 1e-5
BWD_RERUN_RTOL = 2e-6
# syn_sh16's extraction flags (octree/config/syn_sh16.json) at the default
# init_grid_depth 8, and its optimization flags with 2 epochs.
EXTRACT_FLAGS = [
    "--autoscale", "--scale_alpha_thresh", "0.1", "--radius", "1.4", "--samples_per_cell", "256",
    "--no_early_stop", "--renderer_step_size", "1e-5", "--init_grid_depth", "8",
]
OPT_FLAGS = [
    "--num_epochs", "2", "--sgd", "--lr", "1e7", "--no_early_stop", "--renderer_step_size", "1e-5",
    "--val_interval", "1",
]
OPT_RES = 200
OPT_STEPS = 12
OPT_PROFILE_STEPS = 3
# The optimizer step's device-time split: the tile kernels by kernel name;
# the gather of leaf data into the soa's data rows and its autograd, the
# instance -> leaf segment-sum, by the op that launches them (the step runs
# no other index_select or index_add_).
OPT_STEP_KERNELS = {"backward_kernel": "tile_composite_bwd_kernel",
                    "forward_kernel": "tile_composite_kernel"}
OPT_STEP_OPS = {"gather": "aten::index_select", "segment_sum": "aten::index_add_"}
# Washing the DC colour coefficients turns the leaves grey; two SGD epochs
# over 12 views must win back at least this much val PSNR. It is the
# midpoint of this cell's two readings on the H100: +3.51 dB with the sound
# gradient (18.36 -> 21.87 dB in each of three runs) and +0.00 dB with the
# gradient's sign flipped (the control run below: the best snapshot stays
# the initial tree).
OPT_MIN_GAIN_DB = 1.75
# Gather kernel vs plain (phase 14), at the probes' sizes: K x R indices
# into a 32k-row (7.3 MB) table of N(0, 1) values, D = 56; the shared-memory
# variant on its first 1024 rows. Each output sums n rows; kernel and plain
# version are held to a float64 sum of the same rows: an f32 running sum
# errs by at most 2^-24 of itself per addition, and a running sum of n
# zero-mean terms stays within ~4 sqrt(n) rms, so tol = 2^-24 * L * 4
# sqrt(n) rms with L the kernel's longest chain of additions (rows per lane
# group + 16 groups + blocks): ~0.4 at these sizes.
GATHER_K, GATHER_R, GATHER_ROWS, GATHER_SMEM_ROWS, GATHER_D = 256, 8192, 1 << 15, 1024, 56
# The exact march (phases 15-18). The fast march frame and the served tile
# frame of one pose (same thresholds; the tile path's within-chunk order is
# approximate, the march's is per ray) must agree to this PSNR: predicted
# 35-50 dB before the first run (PERF.md), gated below that.
MARCH_SERVED_MIN_PSNR = 30.0
# LPIPS of one image pair on the card vs the CPU: f32 convolutions in
# another order agree to ~1e-7 relative; TF32 (cuDNN's default for f32
# convolutions) would move the distance by ~1e-3.
LPIPS_RTOL = 1e-4
# The march optimizer's step at 800x800 (chunks as the optimize CLI sizes
# them on this card), timed over this many steps; its device time by part
# (the profiler ranges of octree/optimize.py) from one profiled chunk: a
# profiler window over whole steps of ~10^5 small launches took ~130 s each.
MARCH_OPT_STEPS = 3
MARCH_STEP_RANGES = {"march": "pn_march", "shade": "pn_shade", "update": "pn_update"}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
BF16_TC_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores


def phase(label, t0, **fields):
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[phase] {label}: {time.time() - t0:.2f} s {extra}", flush=True)


def gpu_name_and_power():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def build_all(build_fns):
    """Run every kernel build at once (one nvcc each); re-raise a failure."""
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # reported below, the smoke run fails
            errors.append(e)

    threads = [threading.Thread(target=run, args=(b,)) for b in build_fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def ptxas_summary(build_logs, name):
    return "; ".join(
        line.strip() for line in build_logs.get(name, "").splitlines()
        if "registers" in line or "spill" in line
    )


def trunk_vs_plain(dev):
    """Phase 7: the fused trunk kernels against their plain versions."""
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.models.params import init_trunk_params, trunk_weights
    from plenoctree_tpu_torch.ops.posenc import posenc

    params = init_trunk_params(np.random.default_rng(SEED), 63, 8, 256, 4, 1, 48,
                               bias_std=TRUNK_BIAS_STD)
    flat, meta = trunk_weights(params, 4, dev)
    results = {}
    for n in TRUNK_ROWS:
        t0 = time.time()
        rng = np.random.default_rng(SEED + n)
        pts = torch.tensor(rng.uniform(-1.5, 1.5, (n, 3)), dtype=torch.float32, device=dev)
        x = posenc(pts, 0, 10)
        gs = torch.tensor(rng.normal(size=(n, 1)) * 1e-3, dtype=torch.float32, device=dev)
        gr = torch.tensor(rng.normal(size=(n, 48)) * 1e-3, dtype=torch.float32, device=dev)
        s, r = fused_mlp.fused_trunk(flat, x, meta)
        grads = fused_mlp.fused_trunk_bwd(flat, x, gs, gr, meta)
        torch.cuda.synchronize()
        rs, rr = fused_mlp.fused_trunk_reference(flat, x, meta)
        ref = fused_mlp.fused_trunk_bwd_reference(flat, x, gs, gr, meta)
        if not all(torch.isfinite(t).all() for t in (s, r, *grads)):
            raise RuntimeError(f"non-finite fused trunk output at {n} rows")
        fwd_err = max(float((s - rs).abs().max()), float((r - rr).abs().max()))
        rel = [float((a - b).abs().max() / (b.abs().max() + 1e-30)) for a, b in zip(grads, ref)]
        bwd_abs = max(float((a - b).abs().max()) for a, b in zip(grads, ref))
        fwd_ms = cuda_ms(lambda: fused_mlp.fused_trunk(flat, x, meta), 10)
        fwd_plain = cuda_ms(lambda: fused_mlp.fused_trunk_reference(flat, x, meta), 3)
        bwd_ms = cuda_ms(lambda: fused_mlp.fused_trunk_bwd(flat, x, gs, gr, meta), 5)
        bwd_plain = cuda_ms(lambda: fused_mlp.fused_trunk_bwd_reference(flat, x, gs, gr, meta), 3)
        lib_fwd, lib_bwd = trunk_library(flat, x, gs, gr, meta)
        phase(
            f"trunk kernel vs plain ({n} rows)", t0, fwd_max_abs_err=fwd_err,
            fwd_tol=TRUNK_FWD_ATOL, grad_max_rel_err=max(rel), grad_tol=TRUNK_GRAD_RTOL,
            grad_rel_per_array=[round(e, 6) for e in rel], fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain,
            bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain, library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
            bound_fwd=trunk_bound(flat, n, 1), bound_bwd=trunk_bound(flat, n, 3),
        )
        if not fwd_err <= TRUNK_FWD_ATOL:
            raise RuntimeError(f"trunk forward disagrees: {fwd_err} > {TRUNK_FWD_ATOL}")
        if not max(rel) <= TRUNK_GRAD_RTOL:
            raise RuntimeError(f"trunk backward disagrees: {max(rel)} > {TRUNK_GRAD_RTOL}")
        results[n] = dict(fwd_err=fwd_err, bwd_abs=bwd_abs, fwd_ms=fwd_ms,
                          fwd_plain=fwd_plain, bwd_ms=bwd_ms, bwd_plain=bwd_plain,
                          lib_fwd=lib_fwd, lib_bwd=lib_bwd, bound_fwd=trunk_bound(flat, n, 1),
                          bound_bwd=trunk_bound(flat, n, 3))
    return results


def trunk_bound(flat, n, passes):
    """The trunk's bound at n rows: 2 flops per multiply-add of every layer
    (passes=1 forward; 3 for the weight gradients: recompute, cotangents
    through the layers, dW) at the bf16 tensor-core peak, against x, the
    weights and the outputs (forward) or cotangents and weight gradients
    (backward) in f32 once each at the memory rate."""
    macs = sum(w.shape[0] * w.shape[1] for w in flat[0::2])
    flops = 2.0 * n * macs * passes
    d_in, d_out = flat[0].shape[0], flat[-1].shape[1]
    weights = sum(w.numel() for w in flat) * 4
    nbytes = 4.0 * n * (d_in + d_out) + weights * (1 if passes == 1 else 2)
    return bound_of(nbytes, flops, BF16_TC_FLOPS)


def trunk_library(flat, x, gs, gr, meta):
    """The same MLP as a chain of bf16 torch.nn.functional.linear + relu
    calls (cuBLAS): ms of the forward, and of forward + autograd backward to
    the weights (the kernel's backward recomputes the forward too)."""
    import torch.nn.functional as F

    depth, skip = meta["depth"], meta["skip_layer"]
    w = [t.t().contiguous().bfloat16().requires_grad_() for t in flat[0::2]]
    b = [t.reshape(-1).bfloat16().requires_grad_() for t in flat[1::2]]
    xb = x.bfloat16()
    g = torch.cat([gs, gr], dim=-1).bfloat16()

    def chain():
        h = xb
        for i in range(depth):
            h = F.relu(F.linear(h, w[i], b[i]))
            if i % skip == 0 and i > 0:
                h = torch.cat([h, xb], dim=-1)
        return F.linear(h, w[depth], b[depth])

    def fwd():
        with torch.no_grad():
            chain()

    def fwd_bwd():
        torch.autograd.grad(chain(), w + b, g)

    return cuda_ms(fwd, 10), cuda_ms(fwd_bwd, 5)


def tile_work(p2, soa, sigma_row, quantum, extra_bytes):
    """(bytes, flops) a tile kernel needs on these phase-1 inputs: every
    input tensor once, each soa block the pieces name once, plus
    extra_bytes (outputs); flops: the slab test (6 FMAs) of every live
    sigma > 0 row of every piece against the rays of the piece's quad
    groups."""
    meta, c0, lo, hi, mask = (t[:, 0] for t in p2[:5])
    rays = p2[5].shape[1]
    valid = torch.arange(c0.shape[-1], device=c0.device)[None] < meta[:, :1]
    c0, lo, hi, mask = c0[valid].long(), lo[valid], hi[valid], mask[valid]
    blocks = c0 // quantum
    nbytes = sum(t.numel() * t.element_size() for t in p2) + extra_bytes
    nbytes += torch.unique(blocks).numel() * soa.shape[1] * quantum * soa.element_size()
    pairs = 0
    for i in range(0, c0.numel(), 1 << 16):
        sl = slice(i, i + (1 << 16))
        rows = c0[sl, None] + torch.arange(quantum, device=c0.device)
        live = (rows >= lo[sl, None]) & (rows < hi[sl, None]) & (soa[blocks[sl], sigma_row] > 0)
        groups = sum((mask[sl] >> k) & 1 for k in range(4))
        pairs += int((live.sum(1) * groups).sum()) * (rays // 4)
    return float(nbytes), 12.0 * pairs


def bound_of(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def train_main_path(dev):
    """Phase 8: the train CLI; returns (fwd launches, bwd launches)."""
    from plenoctree_tpu_torch.cli import train as train_cli
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.utils import checkpoints as ckpt_utils
    from plenoctree_tpu_torch.utils.metrics_writer import read_scalars

    t0 = time.time()
    train_dir = tempfile.mkdtemp(prefix="train_", dir=os.path.join(ROOT, "build", "smoke"))
    fused_mlp.fwd_launches = 0
    fused_mlp.bwd_launches = 0
    # The CLI prints a line per step: keep them out of the smoke's output.
    with open(os.path.join(train_dir, "train.log"), "w") as log, contextlib.redirect_stdout(log):
        model, state = train_cli.main([
            "--config", "nerf_sh/config/blender", "--dataset", "synthetic",
            "--train_dir", train_dir, "--device", "cuda", "--use_pallas",
            "--compute_dtype", "bfloat16", "--batch_size", str(BENCH_BATCH), "--image_batching",
            "--max_steps", str(TRAIN_STEPS), "--lr_final", "5e-5", "--print_every", "1",
            "--save_every", str(TRAIN_STEPS), "--render_every", str(TRAIN_STEPS),
        ])
    torch.cuda.synchronize()
    launches = (fused_mlp.fwd_launches, fused_mlp.bwd_launches)
    psnr = [v for _, v in read_scalars(train_dir, "train_psnr")]
    test_psnr = read_scalars(train_dir, "test_psnr")
    rays_s = [v for _, v in read_scalars(train_dir, "train_rays_per_sec")]
    first, last = float(np.mean(psnr[:20])), float(np.mean(psnr[-20:]))
    ckpt_path = os.path.join(train_dir, f"checkpoint_{TRAIN_STEPS}")
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    restored = ckpt_utils.restore_checkpoint(train_dir, ckpt_utils.create_train_state(fresh))
    same = all(torch.equal(p, state.params[k]) for k, p in restored.params.items())
    phase(
        "train main path", t0, steps=len(psnr), fwd_launches=launches[0],
        bwd_launches=launches[1], psnr_first20=first, psnr_last20=last,
        test_psnr=test_psnr[-1][1] if test_psnr else None,
        rays_per_sec_median=float(np.median(rays_s[20:])) if len(rays_s) > 20 else None,
        checkpoint=os.path.basename(ckpt_path), restored_step=restored.step,
        params_equal=same,
    )
    if min(launches) <= 0:
        raise RuntimeError(f"the train CLI did not launch both trunk kernels: {launches}")
    if len(psnr) != TRAIN_STEPS or not all(math.isfinite(v) for v in psnr):
        raise RuntimeError(f"bad train PSNR trace ({len(psnr)} values)")
    if not last > first:
        raise RuntimeError(f"train PSNR did not rise: first 20 {first}, last 20 {last}")
    if not (os.path.isfile(ckpt_path) and restored.step == TRAIN_STEPS and same):
        raise RuntimeError("the checkpoint did not restore into a fresh TrainState")
    return launches, train_dir


def train_throughput():
    """Phase 9: the port's bench at batch 4096."""
    from plenoctree_tpu_torch import bench

    t0 = time.time()
    res = bench.run(BENCH_BATCH, BENCH_STEPS, profile_window=3)
    phase(
        "train throughput", t0, rays_per_sec=res["rays_per_sec"],
        ms_per_step=res["ms_per_step"], peak_mem_gib=res["peak_mem_gib"],
        device_ms_per_step=res["device_ms_per_step"],
        trunk_kernel_ms_per_step=res["trunk_kernel_ms_per_step"],
        trunk_share=res["trunk_share"], top_kernels=json.dumps(res["top_kernels"]),
        vs_baseline=res["rays_per_sec"] / bench.BASELINE_RAYS_PER_SEC,
    )
    if not (math.isfinite(res["rays_per_sec"]) and math.isfinite(res["final_psnr"])):
        raise RuntimeError(f"bad bench result {res}")
    return res


def extract_main_path(train_dir):
    """Phase 9: the extract CLI on the train phase's checkpoint."""
    from plenoctree_tpu_torch.cli import extract as extract_cli
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.octree import N3Tree
    from plenoctree_tpu_torch.octree.renderer import VolumeRenderer

    t0 = time.time()
    out = os.path.join(ROOT, "build", "smoke", "extract", "tree.npz")
    fused_mlp.fwd_launches = 0
    steps = {}
    lines = []

    def clock(text):
        for line in text.splitlines():
            if line.startswith("* "):
                steps[line[2:].strip()] = round(time.time() - t0, 2)
            lines.append(line)

    with contextlib.redirect_stdout(_Tee(clock)):
        tree = extract_cli.main([
            "--config", "nerf_sh/config/blender", "--dataset", "synthetic",
            "--train_dir", train_dir, "--device", "cuda", "--use_pallas",
            "--compute_dtype", "bfloat16", "--output", out, *EXTRACT_FLAGS,
        ])
    torch.cuda.synchronize()
    launches = fused_mlp.fwd_launches
    with open(out + ".results.json") as f:
        results = json.load(f)
    back = N3Tree.load(out)
    # One 800x800 frame of this tree through the march, in the eval's mode
    # (exact, step 1e-5); its accel grid is budgeted (a residual descent).
    t1 = time.time()
    vr = VolumeRenderer(tree, step_size=1e-5, device="cuda")
    build_s = time.time() - t1
    t1 = time.perf_counter()
    img = vr.render_persp(orbit_pose(0.0), RES, RES, 1.1 * RES, fast=False)
    frame_ms = (time.perf_counter() - t1) * 1e3
    phase(
        "extract main path", t0, fwd_launches=launches, leaves=tree.n_leaves,
        reloaded_leaves=back.n_leaves, depth=back.max_depth, eval_psnr=results["psnr"],
        eval_ssim=results["ssim"], step_clock_s=json.dumps(steps),
        march_800_exact_ms=frame_ms, march_host_build_s=round(build_s, 2),
        accel_level=vr.arrays["accel_level"], accel_reso=vr.arrays["accel_reso"],
        K_estimated=vr.contrib_slots, K_exact=vr._get_deferred(False).K,
    )
    if not (np.isfinite(img).all() and vr.arrays["accel_level"] < back.max_depth + 1):
        raise RuntimeError("bad march frame of the extracted tree, or an unbudgeted accel grid")
    if launches <= 0:
        raise RuntimeError("the extract CLI never launched the trunk forward kernel")
    if back.n_leaves != tree.n_leaves or back.max_depth != 8 or tree.n_leaves == 0:
        raise RuntimeError(f"bad extracted tree: {back}")
    if not math.isfinite(results["psnr"]):
        raise RuntimeError(f"bad extraction eval {results}")
    return launches


class _Tee:
    """stdout that also hands each complete line to a callback."""

    def __init__(self, fn):
        self.fn, self.out, self.buf = fn, sys.stdout, ""

    def write(self, text):
        self.buf += text
        if "\n" in self.buf:
            done, self.buf = self.buf.rsplit("\n", 1)
            self.fn(done)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def exact_inputs(opt, c2w):
    """The optimizer's tile inputs for one 800x800 pose; fails if its caps
    would drop geometry."""
    focal = 1.1 * RES
    r = opt.r
    r.w1cap = r.w1cap or int(min(r.grid_c, np.ceil(np.sqrt(3) * r.tile / focal * r.grid_c) + 3))
    ti = r.make_tile_inputs_fn(RES, RES, focal, r.rcap, r.w1cap, r.ccap)
    idx = r.index
    p2, _, nck, w1o = ti(c2w, idx["csr"], idx["base"], r.extra_data, idx["blk_bbox"])
    if int(nck.max()) > r.ccap or int(w1o.max()) > 0:
        raise RuntimeError(f"caps too small at 800x800: pieces {int(nck.max())}, w1 {int(w1o.max())}")
    return ti, p2


def tile_bwd_vs_plain(tree):
    """Phase 11: the tile backward kernel against its plain version."""
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.kernels import tile_composite as K
    from plenoctree_tpu_torch.octree.tile_opt import TileOptimizer

    t0 = time.time()
    opt = TileOptimizer(tree, step_size=1e-5, ccap=512, device="cuda")
    t_index = time.time() - t0
    ti, p2 = exact_inputs(opt, orbit_pose(0.3))
    soa, kw = opt.static_soa, opt._kw
    fwd = lambda: K.composite_tiles(*p2, soa, **kw, stop_thresh=0.0, od_cap=1e30)  # noqa: E731
    out = fwd()
    # The exact-mode forward against its plain version first: the backward
    # check below feeds this `out` to both sides, so it cannot see a wrong one.
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out_ref = K.composite_tiles_reference(*p2, soa, **kw, stop_thresh=0.0, od_cap=1e30)
    torch.cuda.synchronize()
    fwd_plain_ms = (time.perf_counter() - t1) * 1e3
    fwd_err = float((out - out_ref).abs().max())
    del out_ref
    if not (bool(torch.isfinite(out).all()) and fwd_err <= KERNEL_ATOL):
        raise RuntimeError(f"exact-mode tile kernel disagrees with the plain version: {fwd_err}")
    g = torch.tensor(np.random.default_rng(SEED).normal(size=tuple(out.shape)), dtype=torch.float32,
                     device=out.device)
    got = K.composite_tiles_bwd(*p2, soa, out, g, **kw)
    again = K.composite_tiles_bwd(*p2, soa, out, g, **kw)
    torch.cuda.synchronize()
    ref = K.composite_tiles_bwd_reference(*p2, soa, out, g, **kw)
    sr = kw["sigma_row"]
    errs = {}
    for name, sl in (("sigma", slice(sr, sr + 1)), ("colour", slice(6, sr))):
        top = float(ref[:, sl].abs().max())
        errs[name] = (float((got[:, sl] - ref[:, sl]).abs().max()) / top,
                      float((again[:, sl] - got[:, sl]).abs().max()) / top)
    finite = bool(torch.isfinite(got).all())
    untouched = not bool(got[:, :6].any() or got[:, sr + 1 :].any())
    max_abs_err = float((got - ref).abs().max())
    ms_k = cuda_ms(lambda: K.composite_tiles_bwd(*p2, soa, out, g, **kw), 5)
    ms_p = cuda_ms(lambda: K.composite_tiles_bwd_reference(*p2, soa, out, g, **kw), 1)
    ms_f = cuda_ms(fwd, 5)
    nbytes, flops = tile_work(p2, soa, sr, opt.r.quantum,
                              out.numel() * 4 * 2 + soa.numel() * soa.element_size())
    bound_ms, bound_by = bound_of(nbytes, flops, F32_FLOPS)
    fwd_bound = bound_of(*tile_work(p2, soa, sr, opt.r.quantum, out.numel() * 4), F32_FLOPS)
    pieces = p2[0][:, 0, 0]
    phase(
        "tile bwd kernel vs plain", t0, index_build_s=round(t_index, 2), tiles=pieces.numel(),
        pieces_total=int(pieces.sum()), pieces_max=int(pieces.max()), ccap=opt.r.ccap,
        sigma_rel_err=errs["sigma"][0], colour_rel_err=errs["colour"][0], tol=BWD_RTOL,
        sigma_rerun_rel=errs["sigma"][1], colour_rerun_rel=errs["colour"][1],
        rerun_tol=BWD_RERUN_RTOL, max_abs_err=max_abs_err, kernel_ms=ms_k, plain_ms=ms_p,
        fwd_exact_max_abs_err=fwd_err, fwd_exact_tol=KERNEL_ATOL, fwd_exact_kernel_ms=ms_f,
        fwd_exact_plain_ms=fwd_plain_ms, fwd_exact_bound_ms=fwd_bound[0], bound_ms=bound_ms,
        bound_by=bound_by, soa_gib=soa.numel() * 4 / 2**30,
    )
    if not (finite and untouched):
        raise RuntimeError("tile backward kernel: non-finite or misplaced gradients")
    if not max(e[0] for e in errs.values()) <= BWD_RTOL:
        raise RuntimeError(f"tile backward kernel disagrees with the plain version: {errs}")
    if not max(e[1] for e in errs.values()) <= BWD_RERUN_RTOL:
        raise RuntimeError(f"two tile backward kernel runs differ too much: {errs}")
    del got, again, ref
    return opt, ti, dict(max_abs_err=max_abs_err, ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms,
                         bound_by=bound_by, fwd_exact_err=fwd_err)


def device_split(prof, kernels, ops, n_steps):
    """Device ms per step from a torch.profiler window: per group of
    `kernels` (kernel-name substrings) and of `ops` (the device time of the
    kernels an op launched), the rest as "other"; and the top kernels as
    (ms per step, name, launches per step)."""
    ms = dict.fromkeys([*kernels, *ops], 0.0)
    total, top = 0.0, []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        t = t / 1e3 / n_steps
        if ev.device_type.name == "CUDA" and ev.key in ops.values():
            continue  # a profiler range's span on the device, not a kernel
        if ev.device_type.name == "CUDA" and t:
            total += t
            top.append((round(t, 3), ev.key[:60], ev.count // n_steps))
            name = next((n for n, k in kernels.items() if k in ev.key), None)
            if name:
                ms[name] += t
        else:
            name = next((n for n, k in ops.items() if k == ev.key), None)
            if name:
                ms[name] += t
    ms["other"] = total - sum(ms.values())
    top.sort(reverse=True)
    return ms, top[:8]


def optimize_throughput(opt, ti):
    """Phase 12: ms per optimizer step at 800x800, and its split."""
    from torch.profiler import ProfilerActivity, profile

    from plenoctree_tpu_torch.data.poses import orbit_pose

    t0 = time.time()
    focal = 1.1 * RES
    lr = float(OPT_FLAGS[OPT_FLAGS.index("--lr") + 1])
    leaf = opt.initial_leaf_dataT()
    poses = [orbit_pose(2.0 * np.pi * k / OPT_STEPS) for k in range(OPT_STEPS)]
    gts = []
    rng = np.random.default_rng(SEED)
    for c2w in poses[:2]:
        img, _, _, _ = opt.render(leaf, c2w, RES, RES, focal)
        gts.append(np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1).astype(np.float32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step(k):
        (_, (_, _, nck, w1o)), grad = opt.loss_and_grad(leaf, poses[k], gts[k % 2], RES, RES, focal)
        with torch.no_grad():
            leaf.add_(grad * -lr)
        return nck, w1o

    step(0)  # warm-up
    step_ms = []
    for k in range(OPT_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        nck, w1o = step(k)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        if int(nck) > opt.r.ccap or int(w1o) > 0:
            raise RuntimeError(f"an optimizer step dropped geometry (nc {int(nck)}, w1 {int(w1o)})")
    peak = torch.cuda.max_memory_allocated()
    step_med = float(np.median(step_ms))

    # Where the same steps spend device time: one profiler window over the
    # real step (groups: OPT_STEP_KERNELS, OPT_STEP_OPS). Tile inputs (phase
    # 1), the soa relayout, the loss and the update are small kernels in "other";
    # the host time between kernels is the idle share. The tile inputs'
    # wall time is also taken alone, on the function the step calls.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(OPT_PROFILE_STEPS):
            step(k)
        torch.cuda.synchronize()
    split, top = device_split(prof, OPT_STEP_KERNELS, OPT_STEP_OPS, OPT_PROFILE_STEPS)
    device_ms = sum(split.values())
    idx = opt.r.index
    inputs_ms = cuda_ms(lambda: ti(poses[0], idx["csr"], idx["base"], opt.r.extra_data,
                                   idx["blk_bbox"]), 5)
    phase(
        "optimize throughput", t0, res=RES, steps=OPT_STEPS, ms_per_step_median=step_med,
        ms_per_step_best=float(np.min(step_ms)), peak_mem_gib=peak / 2**30,
        device_ms_per_step=device_ms, device_split_ms=json.dumps(split),
        idle_share=1.0 - device_ms / step_med, tile_inputs_alone_ms=inputs_ms,
        top_kernels=json.dumps(top),
    )
    if not all(math.isfinite(v) for v in step_ms):
        raise RuntimeError("bad optimizer step times")
    if not all(v > 0 for v in split.values()):
        raise RuntimeError(f"a group of the profiled step shows no device time: {split}")
    return step_med


def optimize_main_path(tree):
    """Phase 13: the optimize CLI (--tile_opt) on the washed tree, then the
    eval CLI on its output."""
    from plenoctree_tpu_torch.cli import evaluate as eval_cli
    from plenoctree_tpu_torch.cli import optimize as optimize_cli
    from plenoctree_tpu_torch.kernels import tile_composite as K
    from plenoctree_tpu_torch.octree import N3Tree

    t0 = time.time()
    out_dir = os.path.join(ROOT, "build", "smoke", "optimize")
    os.makedirs(out_dir, exist_ok=True)
    washed = tree.clone()
    bd = washed.data_format.basis_dim
    washed.data[..., [0, bd, 2 * bd]] = 0.0  # the degree-0 term of each channel
    src, dst = os.path.join(out_dir, "tree_washed.npz"), os.path.join(out_dir, "tree_opt.npz")
    washed.save(src, compress=False)
    common = ["--config", "nerf_sh/config/blender", "--dataset", "synthetic",
              "--synthetic_resolution", str(OPT_RES), "--device", "cuda"]
    K.launches = K.bwd_launches = 0
    initial, vals = [], []

    def grab(text):
        for line in text.splitlines():
            if line.startswith("** initial val psnr"):
                initial.append(float(line.split()[-1]))
            elif line.startswith("** val psnr"):  # "** val psnr <psnr> best <best>"
                vals.append(float(line.split()[3]))

    with contextlib.redirect_stdout(_Tee(grab)):
        best_tree, best_psnr = optimize_cli.main(common + [
            "--input", src, "--output", dst, "--tile_opt", *OPT_FLAGS,
        ])
    torch.cuda.synchronize()
    launches = (K.launches, K.bwd_launches)
    loaded = N3Tree.load(dst) if os.path.isfile(dst) else None
    phase(
        "optimize main path", t0, fwd_launches=launches[0], bwd_launches=launches[1],
        initial_val_psnr=initial[0] if initial else None, val_psnr_per_epoch=vals,
        best_val_psnr=best_psnr, min_gain_db=OPT_MIN_GAIN_DB, tree_opt_leaves=None if loaded is None else loaded.n_leaves,
    )
    if min(launches) <= 0:
        raise RuntimeError(f"the optimize CLI did not launch both tile kernels: {launches}")
    if not initial or not best_psnr > initial[0] + OPT_MIN_GAIN_DB:
        raise RuntimeError(f"val PSNR did not rise by {OPT_MIN_GAIN_DB} dB: {initial} -> {best_psnr}")
    if loaded is None or best_tree is None or loaded.n_leaves != tree.n_leaves:
        raise RuntimeError("tree_opt.npz missing or not the optimized tree")

    t0 = time.time()
    K.launches = 0
    psnr, ssim, _ = eval_cli.main(common + ["--input", dst, "--fast_eval"])
    torch.cuda.synchronize()
    phase("optimized tree eval", t0, psnr=psnr, ssim=ssim, launches=K.launches)
    if not (math.isfinite(psnr) and K.launches > 0):
        raise RuntimeError(f"bad eval of the optimized tree: PSNR {psnr}")

    # Control: the same run with the gradient's sign flipped (SGD at -lr)
    # must not pass the gain check, or the check cannot tell a broken
    # gradient from a sound one.
    t0 = time.time()
    i = OPT_FLAGS.index("--lr")
    flipped = OPT_FLAGS[:i] + OPT_FLAGS[i + 2 :] + [f"--lr=-{OPT_FLAGS[i + 1]}"]
    initial.clear()
    vals.clear()
    with contextlib.redirect_stdout(_Tee(grab)):
        _, ctrl_best = optimize_cli.main(common + [
            "--input", src, "--tile_opt", "--nosave", *flipped,
        ])
    gain = ctrl_best - initial[0]
    phase("optimize control (gradient sign flipped)", t0, initial_val_psnr=initial[0],
          val_psnr_after=vals, best_val_psnr=ctrl_best, gain_db=gain, min_gain_db=OPT_MIN_GAIN_DB)
    if not gain < OPT_MIN_GAIN_DB:
        raise RuntimeError(f"a sign-flipped gradient passed the gain check: {gain} dB")
    return launches[1], best_psnr


def gather_vs_plain():
    """Phase 14: every gather_sum variant against its plain version and a
    float64 sum at the probes' sizes, with times and bounds; then the probes'
    entry point (bench_gather.run), the kernel's main path, in process."""
    import torch.nn.functional as F

    from plenoctree_tpu_torch import bench_gather
    from plenoctree_tpu_torch.kernels import gather_sum as G

    t0 = time.time()
    rng = np.random.default_rng(SEED)
    dev = "cuda"
    D = GATHER_D
    table = torch.tensor(rng.normal(size=(GATHER_ROWS, D)), dtype=torch.float32, device=dev)
    small = table[:GATHER_SMEM_ROWS].contiguous()

    def idx(rows, shape):
        return torch.tensor(rng.integers(0, rows, size=shape), dtype=torch.int32, device=dev)

    kr, rk = idx(GATHER_ROWS, (GATHER_K, GATHER_R)), idx(GATHER_ROWS, (GATHER_R, GATHER_K))
    ks = idx(GATHER_SMEM_ROWS, (GATHER_K, GATHER_R))
    variants = [  # name, index stream, table, groups, unroll, shared-memory table
        ("vmem_u1", kr, table, 1, 1, False), ("vmem_u8", kr, table, 1, 8, False),
        ("tile", kr, table, 8, 1, False), ("vmem_rk", rk, table, 1, 1, False),
        ("smem_1k", ks, small, 1, 8, True),
    ]
    lib = G.build()
    res = {}
    for name, ix, tab, groups, unroll, smem in variants:
        run = lambda: G.gather_sum(ix, tab, groups, unroll, smem)  # noqa: E731
        out, again = run(), run()
        torch.cuda.synchronize()
        ref = G.gather_sum_reference(ix, tab, groups)
        f64 = tab.double().index_select(0, ix.reshape(-1).long()).reshape(-1, groups, D).sum(0)
        n = ix.numel()
        blocks = lib.pn_gather_sum_blocks(n, int(smem))
        chain = -(-n // (16 * blocks)) + 16 + blocks
        tol = 2.0**-24 * chain * 4.0 * math.sqrt(n // groups) * float(tab.std())
        err = float((out.double() - f64).abs().max())
        plain_err = float((ref.double() - f64).abs().max())
        # embedding_bag's bags: the whole stream (G = 1), or its 8 residue
        # classes as the rows of a [8, n/8] index (made once, outside the timing).
        bags = ix.reshape(1, -1) if groups == 1 else ix.reshape(-1, groups).t().contiguous()
        lib_err = float((F.embedding_bag(bags, tab, mode="sum").double() - f64).abs().max())
        distinct = int(torch.unique(ix).numel())
        bound = bound_of(n * 4 + distinct * D * 4 + groups * D * 4, float(n * D), F32_FLOPS)
        res[name] = dict(
            ms=cuda_ms(run, 10), plain_ms=cuda_ms(lambda: G.gather_sum_reference(ix, tab, groups), 5),
            library_ms=cuda_ms(lambda: F.embedding_bag(bags, tab, mode="sum"), 10),
            max_abs_err=float((out - ref).abs().max()), err_vs_f64=err, plain_err_vs_f64=plain_err,
            library_err_vs_f64=lib_err, tol=tol, rerun_equal=bool(torch.equal(out, again)),
            bound_ms=bound[0], bound_by=bound[1], blocks=blocks, distinct_rows=distinct,
        )
        if not (err <= tol and plain_err <= tol and res[name]["rerun_equal"]):
            raise RuntimeError(f"gather_sum {name} disagrees: {res[name]}")
    phase("gather kernel vs plain", t0, **{k: json.dumps(v) for k, v in res.items()})

    t0 = time.time()
    G.launches = 0
    probes = bench_gather.run()
    launches = G.launches
    phase("gather probes (main path)", t0, launches=launches,
          ns_per_row=json.dumps({k: round(v, 4) for k, v in probes["ns_per_row"].items()}))
    if launches <= 0 or launches != sum(probes["launches"].values()):
        raise RuntimeError(f"the probes' gather_sum launches do not add up: {launches}, {probes['launches']}")
    by_case = probes["launches"]
    res["vmem_u1"]["launches"] = sum(by_case[c] for c in (
        "pallas_vmem_u1", "pallas_vmem_u8", "gather_sum_smem_1k", "gather_sum_u8_1k", "gather_sum_u8_1m"))
    res["tile"]["launches"] = by_case["pallas_vmem_tile"]
    res["vmem_rk"]["launches"] = by_case["pallas_vmem"]
    return res


def march_full_width(tree, served0):
    """Phase 15: VolumeRenderer on the depth-7 SH16 tree at 800x800, two
    orbit poses, exact (step 1e-5) and fast; the fast frame of pose 0 against
    the served tile frame of that pose (u8, phase 6)."""
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.octree.renderer import VolumeRenderer

    t0 = time.time()
    vr = VolumeRenderer(tree, step_size=1e-5, device="cuda")
    build_s = time.time() - t0
    k_est = vr.contrib_slots
    focal = 1.1 * RES
    torch.cuda.reset_peak_memory_stats()
    ms, frames = {}, {}
    for fast in (False, True):
        ms[fast] = []
        for k in range(2):
            t1 = time.perf_counter()
            img = vr.render_persp(orbit_pose(2.0 * np.pi * k / N_ORBIT), RES, RES, focal, fast=fast)
            ms[fast].append((time.perf_counter() - t1) * 1e3)
            if img.shape != (RES, RES, 3) or not np.isfinite(img).all() or img.min() == img.max():
                raise RuntimeError(f"bad march frame (fast={fast}, pose {k})")
            frames[fast, k] = img
    peak = torch.cuda.max_memory_allocated()
    u8 = np.round(np.clip(frames[True, 0], 0.0, 1.0) * 255.0)
    psnr = -10.0 * math.log10(float(np.mean(((u8 - served0) / 255.0) ** 2)))
    phase(
        "march full width", t0, host_build_s=round(build_s, 2), exact_ms=ms[False], fast_ms=ms[True],
        K_estimated=k_est, K_exact=vr._get_deferred(False).K, K_fast=vr._get_deferred(True).K,
        max_segments=vr.opts.max_segments, accel_level=vr.arrays["accel_level"],
        accel_reso=vr.arrays["accel_reso"], peak_mem_gib=peak / 2**30,
        psnr_fast_vs_served=psnr, min_psnr=MARCH_SERVED_MIN_PSNR,
    )
    if not psnr >= MARCH_SERVED_MIN_PSNR:
        raise RuntimeError(f"fast march frame vs served frame: {psnr} dB < {MARCH_SERVED_MIN_PSNR}")
    return vr, frames


def random_lpips_weights(path):
    """Seeded random VGG16 + LPIPS-head weights in the npz layout (conv
    kernels HWIO N(0, 0.05), biases N(0, 0.01), heads U(0, 1)): the
    pretrained weights cannot be downloaded, so the value checks the path
    and is no perceptual score."""
    from plenoctree_tpu_torch.ops import lpips

    rng = np.random.default_rng(SEED)
    w, cin, i = {}, 3, 0
    for v in lpips._VGG_CFG:
        if v != "M":
            w[f"conv{i}/kernel"] = (rng.normal(size=(3, 3, cin, v)) * 0.05).astype(np.float32)
            w[f"conv{i}/bias"] = (rng.normal(size=(v,)) * 0.01).astype(np.float32)
            cin, i = v, i + 1
    for k, (_, c) in enumerate(lpips.tap_structure()):
        w[f"lin{k}"] = rng.random(size=(c,)).astype(np.float32)
    np.savez(path, **w)


def exact_eval_main_path(tree_path, vr):
    """Phase 16: the eval CLI without --fast_eval (the march) at 200x200,
    with random LPIPS weights; LPIPS of one pair on the card vs the CPU."""
    from plenoctree_tpu_torch.cli import evaluate as eval_cli
    from plenoctree_tpu_torch.data.synthetic import render_synthetic_scene
    from plenoctree_tpu_torch.kernels import tile_composite
    from plenoctree_tpu_torch.ops.lpips import get_lpips_fn

    t0 = time.time()
    weights = os.path.join(ROOT, "build", "smoke", "lpips_random.npz")
    random_lpips_weights(weights)
    before = os.environ.get("LPIPS_WEIGHTS_NPZ")
    os.environ["LPIPS_WEIGHTS_NPZ"] = weights
    try:
        tile_composite.launches = 0
        psnr, ssim, lpips = eval_cli.main([
            "--input", tree_path, "--config", "nerf_sh/config/blender", "--dataset", "synthetic",
            "--synthetic_resolution", str(EVAL_RES), "--device", "cuda",
        ])
        torch.cuda.synchronize()
        tile_launches = tile_composite.launches
        images, c2ws, focal = render_synthetic_scene("test", 4, EVAL_RES, True, 2.0, 6.0)
        im = np.clip(vr.render_persp(c2ws[0], EVAL_RES, EVAL_RES, focal, fast=True), 0.0, 1.0)
        on_card = get_lpips_fn("cuda")(images[0], im)
        on_cpu = get_lpips_fn("cpu")(images[0], im)
    finally:
        if before is None:
            del os.environ["LPIPS_WEIGHTS_NPZ"]
        else:
            os.environ["LPIPS_WEIGHTS_NPZ"] = before
    rel = abs(on_card - on_cpu) / abs(on_cpu)
    phase("exact eval main path", t0, psnr=psnr, ssim=ssim, lpips_random_weights=lpips,
          tile_launches=tile_launches, lpips_pair_card=on_card, lpips_pair_cpu=on_cpu,
          lpips_rel_diff=rel, lpips_rtol=LPIPS_RTOL)
    if not (math.isfinite(psnr) and math.isfinite(ssim)) or psnr < 25.0 or ssim < 0.8:
        raise RuntimeError(f"exact eval quality too low: PSNR {psnr}, SSIM {ssim}")
    if tile_launches != 0:
        raise RuntimeError("the eval CLI without --fast_eval launched the tile kernel")
    if not (math.isfinite(lpips) and lpips > 0 and rel <= LPIPS_RTOL):
        raise RuntimeError(f"bad LPIPS: {lpips}, card {on_card} vs CPU {on_cpu}")
    return psnr


def march_opt_throughput(vr, frames):
    """Phase 17: the march optimizer's step at 800x800 on the depth-7 tree
    (TwoPhaseRenderer.loss_grad over chunks + the SGD update), median of
    MARCH_OPT_STEPS, peak memory; the device time by part and the idle share
    of one chunk + update from a profiler window."""
    from torch.profiler import ProfilerActivity, profile

    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.octree.optimize import (
        TwoPhaseRenderer, _image_rays, default_slot_budget, image_loss_grad, make_update,
    )
    from plenoctree_tpu_torch.octree.renderer import RenderOptions

    t0 = time.time()
    focal = 1.1 * RES
    lr = float(OPT_FLAGS[OPT_FLAGS.index("--lr") + 1])
    opts = RenderOptions(step_size=1e-5, max_segments=vr.opts.max_segments)
    rend = TwoPhaseRenderer(vr.arrays, vr.fmt, vr.basis_dim, opts, K=vr._get_deferred(False).K)
    data = rend.data0.clone()  # the renderer's tables stay as they are
    chunk = default_slot_budget("cuda", data.shape[1]) // rend.K
    update = make_update(data, True, 0.0, lr)
    rng = np.random.default_rng(SEED)
    rays, gts = [], []
    for k in range(2):
        rays.append(_image_rays(orbit_pose(2.0 * np.pi * k / N_ORBIT), RES, RES, focal, None))
        img = frames[False, k] + 0.05 * rng.standard_normal(frames[False, k].shape)
        gts.append(np.clip(img, 0, 1).astype(np.float32).reshape(-1, 3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step(k, one_chunk=False):
        o, d = rays[k % 2]
        # One chunk: the one at the middle of the frame (the first rows of
        # an orbit frame are mostly background).
        s = slice((o.shape[0] - chunk) // 2, (o.shape[0] + chunk) // 2) if one_chunk else slice(None)
        sq, grad, over = image_loss_grad(rend, data, o[s], d[s], gts[k % 2][s], chunk)
        update(grad, float(o[s].shape[0] * 3))
        return over

    def timed(fn):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        over = fn()
        e1.record()
        torch.cuda.synchronize()
        if bool(over):
            raise RuntimeError(f"an optimizer step overflowed K={rend.K}")
        return e0.elapsed_time(e1)

    step(0)  # warm-up
    step_ms = [timed(lambda: step(k)) for k in range(MARCH_OPT_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    step_med = float(np.median(step_ms))
    # One chunk of the step and the update, alone and in a profiler window
    # (backward on this thread, so the shade's range holds its backward
    # kernels too).
    chunk_ms = timed(lambda: step(0, one_chunk=True))
    with torch.autograd.set_multithreading_enabled(False):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(0, one_chunk=True)
            torch.cuda.synchronize()
    split, top = device_split(prof, {}, MARCH_STEP_RANGES, 1)
    device_ms = sum(split.values())
    phase(
        "march optimize throughput", t0, res=RES, K=rend.K, chunk=chunk, steps=MARCH_OPT_STEPS,
        ms_per_step_median=step_med, ms_per_step=step_ms, peak_mem_gib=peak / 2**30,
        chunk_ms=chunk_ms, chunk_device_ms=device_ms, chunk_device_split_ms=json.dumps(split),
        chunk_idle_share=1.0 - device_ms / chunk_ms, top_kernels=json.dumps(top),
    )
    if not all(math.isfinite(v) for v in step_ms):
        raise RuntimeError("bad march optimizer step times")
    if not all(split[k] > 0 for k in MARCH_STEP_RANGES):
        raise RuntimeError(f"a part of the profiled step shows no device time: {split}")
    return step_med


def march_optimize_main_path(tile_best):
    """Phase 18: the optimize CLI without --tile_opt (the march) on phase
    13's washed tree with the same flags; it must not launch a tile kernel."""
    from plenoctree_tpu_torch.cli import optimize as optimize_cli
    from plenoctree_tpu_torch.kernels import tile_composite as K
    from plenoctree_tpu_torch.octree import N3Tree

    t0 = time.time()
    out_dir = os.path.join(ROOT, "build", "smoke", "optimize")
    src, dst = os.path.join(out_dir, "tree_washed.npz"), os.path.join(out_dir, "tree_opt_march.npz")
    K.launches = K.bwd_launches = 0
    initial, vals = [], []

    def grab(text):
        for line in text.splitlines():
            if line.startswith("** initial val psnr"):
                initial.append(float(line.split()[-1]))
            elif line.startswith("** val psnr"):
                vals.append(float(line.split()[3]))

    with contextlib.redirect_stdout(_Tee(grab)):
        best_tree, best_psnr = optimize_cli.main([
            "--config", "nerf_sh/config/blender", "--dataset", "synthetic",
            "--synthetic_resolution", str(OPT_RES), "--device", "cuda",
            "--input", src, "--output", dst, *OPT_FLAGS,
        ])
    torch.cuda.synchronize()
    launches = (K.launches, K.bwd_launches)
    loaded = N3Tree.load(dst) if os.path.isfile(dst) else None
    phase(
        "march optimize main path", t0, tile_launches=launches,
        initial_val_psnr=initial[0] if initial else None, val_psnr_per_epoch=vals,
        best_val_psnr=best_psnr, tile_opt_best_val_psnr=tile_best, min_gain_db=OPT_MIN_GAIN_DB,
        tree_opt_leaves=None if loaded is None else loaded.n_leaves,
    )
    if launches != (0, 0):
        raise RuntimeError(f"the march optimize CLI launched tile kernels: {launches}")
    if not initial or not best_psnr > initial[0] + OPT_MIN_GAIN_DB:
        raise RuntimeError(f"val PSNR did not rise by {OPT_MIN_GAIN_DB} dB: {initial} -> {best_psnr}")
    if loaded is None or best_tree is None or loaded.n_leaves != best_tree.n_leaves:
        raise RuntimeError("tree_opt_march.npz missing or not the optimized tree")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from plenoctree_tpu_torch.cli import evaluate as eval_cli
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.data.synthetic import build_scene_tree, render_synthetic_scene
    from plenoctree_tpu_torch.kernels import _build
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.kernels import gather_sum
    from plenoctree_tpu_torch.kernels import tile_composite
    from plenoctree_tpu_torch.octree import N3Tree
    from plenoctree_tpu_torch.octree.tile_render import TileRenderer

    start = time.time()
    os.chdir(ROOT)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    t0 = time.time()
    kind = torch.cuda.get_device_name(0)
    smi = gpu_name_and_power()
    phase("device", t0, card=repr(kind), nvidia_smi=repr(smi), count=torch.cuda.device_count())

    t0 = time.time()
    build_all([tile_composite.build, fused_mlp.build, gather_sum.build])
    phase(
        "kernel build", t0, ptxas=repr(ptxas_summary(_build.build_logs, "tile_composite")),
        trunk_ptxas=repr(ptxas_summary(_build.build_logs, "fused_mlp")),
        gather_ptxas=repr(ptxas_summary(_build.build_logs, "gather_sum")),
    )

    t0 = time.time()
    tree = build_scene_tree(TREE_DEPTH, BASIS_DIM, SH_NOISE, SEED)
    out_dir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    tree_path = os.path.join(out_dir, "tree.npz")
    tree.save(tree_path, compress=False)
    tree = N3Tree.load(tree_path)
    phase(
        "model", t0, format=tree.data_format, data_dim=tree.data_dim,
        depth=tree.max_depth, leaves=tree.n_leaves, path=tree_path,
    )

    # The CLIs' synthetic views at 200x200, rendered once on the host: the
    # renders are memoized in process, and phases 5, 13 (three CLI runs),
    # 16 and 18 reuse them.
    t0 = time.time()
    split_s = {}
    for split, n_views in (("test", 4), ("train", 12), ("val", 4)):
        t1 = time.time()
        render_synthetic_scene(split, n_views, EVAL_RES, True, 2.0, 6.0)
        split_s[split] = round(time.time() - t1, 2)
    phase("synthetic views", t0, res=EVAL_RES, seconds_by_split=json.dumps(split_s))

    t0 = time.time()
    renderer = TileRenderer(
        tree, step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2, device=dev
    )
    t_index = time.time() - t0
    focal = 1.1 * RES
    c2w = orbit_pose(0.0)
    renderer.w1cap = int(
        min(renderer.grid_c, np.ceil(np.sqrt(3) * renderer.tile / focal * renderer.grid_c) + 3)
    )
    tile_inputs = renderer.make_tile_inputs_fn(
        RES, RES, focal, renderer.rcap, renderer.w1cap, renderer.ccap
    )
    idx = renderer.index
    p2, _, _, _ = tile_inputs(c2w, idx["csr"], idx["base"], renderer.extra_data, idx["blk_bbox"])
    soa = idx["soa"]
    kw = renderer._kernel_kw
    out_k = tile_composite.composite_tiles(*p2, soa, **kw)
    out_p = tile_composite.composite_tiles_reference(*p2, soa, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(out_k).all() and torch.isfinite(out_p).all()):
        raise RuntimeError("non-finite tile compositing output")
    max_abs_err = float((out_k - out_p).abs().max())
    ms_kernel = cuda_ms(lambda: tile_composite.composite_tiles(*p2, soa, **kw), 10)
    ms_plain = cuda_ms(lambda: tile_composite.composite_tiles_reference(*p2, soa, **kw), 2)
    ms_inputs = cuda_ms(
        lambda: tile_inputs(c2w, idx["csr"], idx["base"], renderer.extra_data, idx["blk_bbox"]), 5
    )
    n_pieces = p2[0][:, 0, 0]
    fwd_bound = bound_of(*tile_work(p2, soa, kw["sigma_row"], kw["quantum"], out_k.numel() * 4),
                         F32_FLOPS)
    phase(
        "kernel vs plain", t0, tiles=p2[0].shape[0], pieces_max=int(n_pieces.max()),
        pieces_mean=float(n_pieces.float().mean()), index_build_s=round(t_index, 2),
        max_abs_err=max_abs_err, tol=KERNEL_ATOL, kernel_ms=ms_kernel, plain_ms=ms_plain,
        tile_inputs_ms=ms_inputs, bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
    )
    if not max_abs_err <= KERNEL_ATOL:
        raise RuntimeError(f"kernel disagrees with the plain version: {max_abs_err} > {KERNEL_ATOL}")

    t0 = time.time()
    tile_composite.launches = 0
    psnr, ssim, lpips = eval_cli.main([
        "--input", tree_path, "--config", "nerf_sh/config/blender",
        "--dataset", "synthetic", "--synthetic_resolution", str(EVAL_RES),
        "--fast_eval", "--device", "cuda",
    ])
    torch.cuda.synchronize()
    main_launches = tile_composite.launches
    with open(tree_path + ".results.json") as f:
        results = json.load(f)
    phase("main path", t0, psnr=psnr, ssim=ssim, lpips=lpips, launches=main_launches)
    if main_launches <= 0:
        raise RuntimeError("the eval CLI never launched the tile kernel")
    if not (math.isfinite(psnr) and math.isfinite(ssim)) or results["psnr"] != psnr:
        raise RuntimeError(f"bad eval results {results}")
    if psnr < 25.0 or ssim < 0.8:
        raise RuntimeError(f"eval quality too low: PSNR {psnr}, SSIM {ssim}")

    t0 = time.time()
    server = TileRenderer(
        tree, step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2,
        index=renderer.index, output="u8", device=dev,
    )
    torch.cuda.reset_peak_memory_stats(dev)
    frame_ms = []
    for k in range(N_ORBIT):
        pose = orbit_pose(2.0 * np.pi * k / N_ORBIT)
        t1 = time.perf_counter()
        img = server.render_persp(pose, RES, RES, focal)
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        if img.shape != (RES, RES, 3) or img.dtype != np.uint8 or img.min() == img.max():
            raise RuntimeError(f"bad served frame {k}: {img.shape} {img.dtype}")
        if k == 0:
            served0 = img.astype(np.float64)  # phase 15's reference for the march
    peak = torch.cuda.max_memory_allocated(dev)
    phase(
        "serving", t0, frames=N_ORBIT, median_ms=float(np.median(frame_ms)),
        best_ms=float(np.min(frame_ms)), first_ms=frame_ms[0],
        peak_mem_gib=peak / 2**30, ccap=server.ccap, w1cap=server.w1cap, gpu=repr(smi),
    )
    del server, renderer, idx, soa, p2, out_k, out_p
    torch.cuda.empty_cache()

    trunk = trunk_vs_plain(dev)
    (fwd_launches, bwd_launches), train_dir = train_main_path(dev)
    extract_main_path(train_dir)
    train_throughput()
    torch.cuda.empty_cache()
    opt, ti, bwd = tile_bwd_vs_plain(tree)
    optimize_throughput(opt, ti)
    del opt, ti
    torch.cuda.empty_cache()
    tile_bwd_launches, tile_opt_best = optimize_main_path(tree)
    torch.cuda.empty_cache()
    gather = gather_vs_plain()
    vr, frames = march_full_width(tree, served0)
    exact_eval_main_path(tree_path, vr)
    march_opt_throughput(vr, frames)
    del vr, frames
    torch.cuda.empty_cache()
    march_optimize_main_path(tile_opt_best)
    phase("total", start)

    bench_rows = trunk[TRUNK_ROWS[0]]
    print(json.dumps({"kernels": [
        {
            "name": "tile_composite",
            "route": "cuda",
            "source": "plenoctree_tpu_torch/csrc/tile_composite.cu",
            "replaces": "plenoctree_tpu/octree/tile_render.py:711",
            "launches": main_launches,
            "max_abs_err": max(max_abs_err, bwd["fwd_exact_err"]),  # serving and exact mode
            "ms": ms_kernel,
            "plain_ms": ms_plain,
            "bound_ms": fwd_bound[0],
            "bound_by": fwd_bound[1],
            "library_ms": None,
        },
        {
            "name": "fused_mlp_fwd",
            "route": "cuda",
            "source": "plenoctree_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "plenoctree_tpu/kernels/fused_mlp.py:185",
            "launches": fwd_launches,
            "max_abs_err": max(r["fwd_err"] for r in trunk.values()),
            "ms": bench_rows["fwd_ms"],
            "plain_ms": bench_rows["fwd_plain"],
            "bound_ms": bench_rows["bound_fwd"][0],
            "bound_by": bench_rows["bound_fwd"][1],
            "library_ms": bench_rows["lib_fwd"],
        },
        {
            "name": "fused_mlp_bwd",
            "route": "cuda",
            "source": "plenoctree_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "plenoctree_tpu/kernels/fused_mlp.py:268",
            "launches": bwd_launches,
            "max_abs_err": max(r["bwd_abs"] for r in trunk.values()),
            "ms": bench_rows["bwd_ms"],
            "plain_ms": bench_rows["bwd_plain"],
            "bound_ms": bench_rows["bound_bwd"][0],
            "bound_by": bench_rows["bound_bwd"][1],
            "library_ms": bench_rows["lib_bwd"],
        },
        {
            "name": "tile_composite_bwd",
            "route": "cuda",
            "source": "plenoctree_tpu_torch/csrc/tile_composite.cu",
            "replaces": "plenoctree_tpu/octree/tile_opt.py:44",
            "launches": tile_bwd_launches,
            "max_abs_err": bwd["max_abs_err"],
            "ms": bwd["ms"],
            "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd["bound_ms"],
            "bound_by": bwd["bound_by"],
            "library_ms": None,
        },
        *[
            {
                "name": name,
                "route": "cuda",
                "source": "plenoctree_tpu_torch/csrc/gather_sum.cu",
                "replaces": replaces,
                "launches": gather[v]["launches"],
                "max_abs_err": gather[v]["max_abs_err"],
                "ms": gather[v]["ms"],
                "plain_ms": gather[v]["plain_ms"],
                "bound_ms": gather[v]["bound_ms"],
                "bound_by": gather[v]["bound_by"],
                "library_ms": gather[v]["library_ms"],
            }
            for name, v, replaces in (
                ("gather_sum_vmem", "vmem_u1", "scripts/bench_gather.py:103"),
                ("gather_sum_tile", "tile", "scripts/bench_gather.py:143"),
                ("gather_sum_vmem_rk", "vmem_rk", "scripts/bench_gather2.py:124"),
            )
        ],
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
