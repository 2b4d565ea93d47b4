"""The fused trunk's plain PyTorch versions against the JAX package's Pallas
kernels, run interpreted on the CPU as tests/test_kernels.py runs them.

Depth 6, width 64, skip 4 (layer 5 reads [h, x]), d_in 63 (posenc 0..10),
head 1 + 12 (SH degree 1: 3 colours x 4 coefficients), 1,500 rows: a
ragged tail against both the JAX 1024-row tile and the CUDA tiles. Every
kernel test runs each variant: the default (x [N, 63] encoded), the
in-kernel posenc (x the raw [N, 3] points), the in-kernel SH decode (a
basis [N, 4], rgb [N, 3]) and both together (the training configuration).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from plenoctree_tpu.kernels import fused_mlp as jfk
from plenoctree_tpu.models.mlp import TrunkMLP as JaxTrunkMLP
from plenoctree_tpu_torch.kernels import fused_mlp as tfk
from plenoctree_tpu_torch.models.mlp import TrunkMLP
from plenoctree_tpu_torch.models.params import (
    init_trunk_params,
    params_from_flax,
    params_to_flax,
    trunk_weights,
)

DEPTH, WIDTH, SKIP, D_IN, N_RGB, ROWS = 6, 64, 4, 63, 12, 1500
POSENC, SH_DIM = (0, 10), 4
# Plain version vs the interpreted Pallas kernel: the same bf16 rounding
# points, f32 sums in another order (and, for posenc, another sin: an ulp
# can round an encoded feature to the other bf16). Measured on the CPU:
# forward 2.4e-7 max abs (default, posenc) and 4.8e-7 (sh, posenc+sh);
# per-layer grads 2.8e-6, 3.0e-6, 3.0e-5 and 6.8e-5 max relative. A bf16
# activation that rounds the other way near a boundary moves the forward
# by up to ~1e-3 (8.3e-4 was read here before): the bounds leave room.
FWD_ATOL = 5e-3
GRAD_RTOL = 2e-3
VARIANTS = {
    "default": dict(posenc=None, sh_dim=0),
    "posenc": dict(posenc=POSENC, sh_dim=0),
    "sh": dict(posenc=None, sh_dim=SH_DIM),
    "posenc+sh": dict(posenc=POSENC, sh_dim=SH_DIM),
}


@functools.lru_cache(maxsize=None)
def _make_case(name):
    var = VARIANTS[name]
    rng = np.random.default_rng(7)
    params = init_trunk_params(rng, D_IN, DEPTH, WIDTH, SKIP, 1, N_RGB, bias_std=0.05)
    if var["posenc"]:
        x = rng.uniform(-1.5, 1.5, size=(ROWS, 3)).astype(np.float32)
    else:
        x = rng.normal(size=(ROWS, D_IN)).astype(np.float32)
    basis = rng.normal(size=(ROWS, SH_DIM)).astype(np.float32) if var["sh_dim"] else None
    n_rgb_out = N_RGB // SH_DIM if var["sh_dim"] else N_RGB
    gs = rng.normal(size=(ROWS, 1)).astype(np.float32)
    gr = rng.normal(size=(ROWS, n_rgb_out)).astype(np.float32)
    flat, meta = jfk.pack_params(params, skip_layer=SKIP, posenc=var["posenc"])
    meta = dict(meta, sh_dim=var["sh_dim"])
    fused = jfk.make_fused_trunk(meta)
    jb = None if basis is None else jnp.asarray(basis)
    js, jr = fused(flat, jnp.asarray(x), jb)

    def loss(fw):
        s, r = fused(fw, jnp.asarray(x), jb)
        return jnp.vdot(s, gs) + jnp.vdot(r, gr)

    jg = jax.grad(loss)(tuple(flat))
    return dict(
        name=name, params=params, x=x, basis=basis, gs=gs, gr=gr, jax_meta=meta,
        meta=trunk_weights(params, SKIP, posenc=var["posenc"], sh_dim=var["sh_dim"])[1],
        jax_out=(np.asarray(js), np.asarray(jr)), jax_grads=[np.asarray(g) for g in jg],
    )


@pytest.fixture(scope="module", params=list(VARIANTS))
def case(request):
    return _make_case(request.param)


@pytest.fixture(scope="module")
def base():
    return _make_case("default")


def _basis(case):
    return None if case["basis"] is None else torch.from_numpy(case["basis"])


def _flat(case):
    return trunk_weights(case["params"], SKIP)[0]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def test_meta_matches_jax_packing(case):
    assert case["meta"] == case["jax_meta"]


def test_reference_forward_matches_pallas(case):
    flat = _flat(case)
    s, r = tfk.fused_trunk_reference(flat, torch.from_numpy(case["x"]), case["meta"],
                                     _basis(case))
    js, jr = case["jax_out"]
    assert s.shape == js.shape and r.shape == jr.shape
    assert np.abs(s.numpy() - js).max() <= FWD_ATOL
    assert np.abs(r.numpy() - jr).max() <= FWD_ATOL


def test_reference_backward_matches_pallas(case):
    flat = _flat(case)
    grads = tfk.fused_trunk_bwd_reference(
        flat, torch.from_numpy(case["x"]), torch.from_numpy(case["gs"]),
        torch.from_numpy(case["gr"]), case["meta"], _basis(case),
    )
    assert len(grads) == len(case["jax_grads"])
    for i, (g, jg) in enumerate(zip(grads, case["jax_grads"])):
        assert tuple(g.shape) == jg.shape, i
        assert _rel(g.numpy(), jg) <= GRAD_RTOL, i


def test_wrapper_runs_plain_version_on_cpu(case):
    flat = _flat(case)
    x = torch.from_numpy(case["x"])
    before = (tfk.fwd_launches, tfk.bwd_launches)
    s, r = tfk.fused_trunk(flat, x, case["meta"], _basis(case))
    rs, rr = tfk.fused_trunk_reference(flat, x, case["meta"], _basis(case))
    assert torch.equal(s, rs) and torch.equal(r, rr)
    g = tfk.fused_trunk_bwd(flat, x, torch.from_numpy(case["gs"]), torch.from_numpy(case["gr"]),
                            case["meta"], _basis(case))
    assert len(g) == len(flat)
    assert (tfk.fwd_launches, tfk.bwd_launches) == before  # no kernel on the CPU


def test_autograd_function_matches_backward_reference(case):
    flat = [t.requires_grad_() for t in _flat(case)]
    x = torch.from_numpy(case["x"]).requires_grad_()
    basis = _basis(case)
    if basis is not None:
        basis.requires_grad_()
    s, r = tfk.FusedTrunkFn.apply(case["meta"], x, basis, *flat)
    (s * torch.from_numpy(case["gs"])).sum().add((r * torch.from_numpy(case["gr"])).sum()).backward()
    ref = tfk.fused_trunk_bwd_reference(
        [t.detach() for t in flat], x.detach(), torch.from_numpy(case["gs"]),
        torch.from_numpy(case["gr"]), case["meta"], _basis(case),
    )
    assert all(torch.equal(t.grad, g) for t, g in zip(flat, ref))
    assert x.grad is None  # positions get no gradient, as in the JAX package
    assert basis is None or basis.grad is None  # nor does the basis


@pytest.mark.parametrize("bad", ["min_deg<0", "posenc x [N, 63]", "posenc x bf16",
                                 "no basis", "basis shape", "basis dtype",
                                 "basis without sh_dim", "cotangent width"])
def test_variants_raise_where_they_cannot_run(bad):
    """The variants' inputs are checked before any kernel runs: posenc needs
    min_deg >= 0 (the JAX kernel asserts it: its scales come from an
    integer shift) and raw f32 [N, 3] points; the SH decode needs an f32
    [N, sh_dim] basis and [N, C] colour cotangents."""
    rng = np.random.default_rng(3)
    params = init_trunk_params(rng, D_IN, DEPTH, WIDTH, SKIP, 1, N_RGB)
    flat, meta = trunk_weights(params, SKIP, posenc=POSENC, sh_dim=SH_DIM)
    x = torch.from_numpy(rng.uniform(-1, 1, (100, 3)).astype(np.float32))
    basis = torch.from_numpy(rng.normal(size=(100, SH_DIM)).astype(np.float32))
    g = torch.ones(100, 3)
    call, err = (lambda: tfk.fused_trunk(flat, x, meta, basis)), ValueError
    if bad == "min_deg<0":
        meta = dict(meta, posenc=(-1, 9))
    elif bad == "posenc x [N, 63]":
        x = torch.zeros(100, D_IN)
    elif bad == "posenc x bf16":
        x, err = x.bfloat16(), TypeError
    elif bad == "no basis":
        basis = None
    elif bad == "basis shape":
        basis = basis[:, :3]
    elif bad == "basis dtype":
        basis, err = basis.double(), TypeError
    elif bad == "basis without sh_dim":
        meta = dict(meta, sh_dim=0)
    else:
        call = lambda: tfk.fused_trunk_bwd(flat, x, g[:, :1], torch.ones(100, N_RGB), meta, basis)
    with pytest.raises(err):
        call()
    with pytest.raises(err):
        tfk.FusedTrunkFn.apply(meta, x, basis, *flat) if bad != "cotangent width" else call()


def test_wrapper_rejects_bad_dtypes(base):
    case = base
    flat = _flat(case)
    x = torch.from_numpy(case["x"])
    with pytest.raises(TypeError):
        tfk.fused_trunk(flat, x.double(), case["meta"])
    with pytest.raises(TypeError):
        tfk.fused_trunk([t.bfloat16() for t in flat], x, case["meta"])
    with pytest.raises(ValueError):
        tfk.fused_trunk(flat, x[:, :10], case["meta"])


def test_packed_layout_round_trips(base):
    """The kernels' weight stream: every slab, read as the kernels' wgmma
    descriptors address it (element (row, k) of an [R, k] slab at byte
    (k / 8) R 16 + (row / 8) 128 + (row % 8) 16 + (k % 8) 2), holds the
    weights the layout says (forward: W_i^T, h rows then x rows; backward:
    W_i[:width]), in bf16; the gradient layout reads back every weight once."""
    case = base
    flat = _flat(case)
    stream, b_pack = tfk.pack(flat, case["meta"])
    lay = tfk._layout(case["meta"])
    assert (lay.xp, lay.np) == (64, 16) and stream.numel() * 2 == lay.stream_bytes
    assert b_pack.numel() == lay.b_total
    raw = stream.view(torch.int16).numpy()
    assert lay.n_fwd == sum(len(range(0, kk, tfk.KS)) for layer in lay.layers for kk in layer[:2])
    for j, (i, part, k0, k, off) in enumerate(lay.slabs):
        k_h, k_x, n = lay.layers[i][:3]
        w = torch.zeros(k_h + k_x, n)
        w[: flat[2 * i].shape[0], : flat[2 * i].shape[1]] = flat[2 * i]
        if j < lay.n_fwd:
            want = w[part * k_h + k0 : part * k_h + k0 + k].t()  # [N_i, k]
        else:
            want = w[:WIDTH, k0 : k0 + k]  # [width, k] over N_i
        rows = want.shape[0]
        r, kk = np.meshgrid(np.arange(rows), np.arange(k), indexing="ij")
        byte = off + (kk // 8) * rows * 16 + (r // 8) * 128 + (r % 8) * 16 + (kk % 8) * 2
        got = torch.from_numpy(raw[byte // 2].copy()).view(torch.bfloat16).float()
        assert torch.equal(got, want.bfloat16().float()), (i, part, k0)
    back = tfk._unpack_grads(torch.cat([
        torch.nn.functional.pad(t, (0, n - t.shape[1], 0, k_h + k_x - t.shape[0])).reshape(-1)
        for t, (k_h, k_x, n, _, _) in zip(flat[::2], lay.layers)]), b_pack, flat, case["meta"])
    for a, b in zip(back, flat):
        assert torch.equal(a, b)


def test_trunk_fused_enc_grads_split_like_flax(case):
    """TrunkMLP.fused_enc (port, from params_from_flax) against flax's
    fused_enc (Pallas, interpreted), with the case's variant: outputs, and
    gradients that split the [W_sigma | W_rgb] head back onto Dense_6 and
    Dense_7."""
    var = VARIANTS[case["name"]]
    rng = np.random.default_rng(11)
    if var["posenc"]:
        x = rng.uniform(-1.5, 1.5, size=(300, 3)).astype(np.float32)
    else:
        x = rng.normal(size=(300, D_IN)).astype(np.float32)
    basis = rng.normal(size=(300, SH_DIM)).astype(np.float32) if var["sh_dim"] else None
    n_out = 1 + (N_RGB // SH_DIM if var["sh_dim"] else N_RGB)
    gt = rng.normal(size=(300, n_out)).astype(np.float32)
    jmlp = JaxTrunkMLP(net_depth=DEPTH, net_width=WIDTH, skip_layer=SKIP,
                       num_rgb_channels=N_RGB, condition=False,
                       compute_dtype=jnp.bfloat16, use_pallas=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, case["params"])
    jb = None if basis is None else jnp.asarray(basis)

    def jloss(p):
        rgb, sigma = jmlp.apply({"params": p}, jnp.asarray(x), jb, var["posenc"],
                                method=jmlp.fused_enc)
        return jnp.vdot(jnp.concatenate([sigma, rgb], -1), gt)

    jgrad = jax.grad(jloss)(jparams)
    tmlp = TrunkMLP(D_IN, DEPTH, WIDTH, SKIP, N_RGB, compute_dtype=torch.bfloat16)
    tmlp.load_state_dict(params_from_flax(case["params"]))
    tb = None if basis is None else torch.from_numpy(basis)
    rgb, sigma = tmlp.fused_enc(torch.from_numpy(x), tb, var["posenc"])
    assert tuple(rgb.shape) == (300, n_out - 1)
    torch.vdot(torch.cat([sigma, rgb], -1).reshape(-1), torch.from_numpy(gt).reshape(-1)).backward()
    got = params_to_flax({k: p.grad for k, p in tmlp.named_parameters()})
    for name in case["params"]:
        for leaf in ("kernel", "bias"):
            assert _rel(got[name][leaf], np.asarray(jgrad[name][leaf])) <= GRAD_RTOL, (name, leaf)


def test_params_round_trip_through_flax_layout(base):
    case = base
    tmlp = TrunkMLP(D_IN, DEPTH, WIDTH, SKIP, N_RGB)
    tmlp.load_state_dict(params_from_flax(case["params"]))
    back = params_to_flax(tmlp)
    assert sorted(back) == sorted(case["params"])
    for name, leaves in case["params"].items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(back[name][leaf], v)
    # flax's own init builds the same tree shapes as the port's module
    jmlp = JaxTrunkMLP(net_depth=DEPTH, net_width=WIDTH, skip_layer=SKIP,
                       num_rgb_channels=N_RGB, condition=False)
    jv = jmlp.init(random.PRNGKey(0), jnp.zeros((1, 1, D_IN)))["params"]
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jv)
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), back)


def test_bench_trunk_noise_floor_runs_on_cpu():
    """The noise-floor entry point on the CPU: its f64 evaluation keeps the
    algorithm's rounding points, so the plain f32 version lies within bf16
    noise of it for every variant (the kernel's columns stay empty)."""
    from plenoctree_tpu_torch import bench_trunk

    res = bench_trunk.run(rows=256, seeds=1, device=torch.device("cpu"))
    assert [r["variant"] for r in res] == list(bench_trunk.VARIANTS)
    for r in res:
        assert len(r["plain_vs_f64"]) == 1 and r["plain_vs_f64"][0] < 0.05, r
        assert r["kernel_vs_f64"] == []


@pytest.mark.parametrize("variant", ["default", "posenc+sh"])
@pytest.mark.parametrize("candidate", ["true", "bias_dropped", "bias_scaled"])
def test_small_row_bound_tells_true_from_broken_gradients(variant, candidate):
    """bench_trunk's small-row check (the kernel's distance from the f64
    evaluation at most TRUNK_SMALL_ROW_FACTOR times the plain version's),
    held here to the gradients the plain version computes on the same rows
    in reverse order: it passes them, and fails them with one bias gradient
    dropped or scaled by 1.05."""
    from plenoctree_tpu_torch import bench_trunk

    var = VARIANTS[variant]
    rng = np.random.default_rng(11)
    params = init_trunk_params(rng, D_IN, DEPTH, WIDTH, SKIP, 1, N_RGB, bias_std=0.05)
    flat, meta = trunk_weights(params, SKIP, posenc=var["posenc"], sh_dim=var["sh_dim"])
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    x = t(rng.uniform(-1.5, 1.5, (ROWS, 3)) if var["posenc"] else rng.normal(size=(ROWS, D_IN)))
    basis = t(rng.normal(size=(ROWS, SH_DIM))) if var["sh_dim"] else None
    gs = t(rng.normal(size=(ROWS, 1)))
    gr = t(rng.normal(size=(ROWS, N_RGB // SH_DIM if var["sh_dim"] else N_RGB)))
    plain = tfk.fused_trunk_bwd_reference(flat, x, gs, gr, meta, basis)
    exact = bench_trunk.bwd_f64(flat, x, gs, gr, meta, basis)
    rev = lambda a: None if a is None else a.flip(0)  # noqa: E731
    got = [g.clone() for g in tfk.fused_trunk_bwd_reference(
        flat, rev(x), rev(gs), rev(gr), meta, rev(basis))]
    if candidate == "bias_dropped":
        got[3] = torch.zeros_like(got[3])
    elif candidate == "bias_scaled":
        got[3] = got[3] * 1.05
    d_got, d_plain, ok = bench_trunk.within_noise_floor(got, plain, exact)
    assert 0.0 < d_plain < 0.01
    assert ok == (candidate == "true"), (d_got, d_plain)
