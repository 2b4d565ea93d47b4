"""The CUDA kernels on the card (marked `gpu`; skips without CUDA).

This file imports no JAX, so it also runs where the JAX stack is absent;
tests/conftest.py imports jax, so run it there without the conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from plenoctree_tpu_torch import bench_trunk
from plenoctree_tpu_torch.data.synthetic import build_scene_tree, render_synthetic_scene
from plenoctree_tpu_torch.kernels import fused_mlp as F
from plenoctree_tpu_torch.kernels import gather_sum as G
from plenoctree_tpu_torch.kernels import tile_composite as K
from plenoctree_tpu_torch.models.params import init_trunk_params, trunk_weights
from plenoctree_tpu_torch.octree.tile_opt import CompositeTilesFn, TileOptimizer, optimize_tree_tiles
from plenoctree_tpu_torch.octree.tile_render import TileRenderer

# Kernel vs plain version on the same inputs (see chip_smoke.py): the sums
# run in different orders, hit tests and precedence are identical.
ATOL = 5e-5
# Fused trunk kernels vs their plain versions (same bf16 rounding points;
# f32 sums in another order can round a bf16 activation the other way):
# the JAX package's kernel-test bounds (tests/test_kernels.py). chip_smoke.py
# holds the bench shapes to the tighter bounds measured there.
TRUNK_FWD_ATOL = 2e-2
TRUNK_GRAD_RTOL = 0.05
# Tile backward kernel vs its plain version, per field group, relative to
# the group's largest |gradient|: the same hit tests and precedence, sums in
# another order (measured <= 2.9e-7 on the H100); and two kernel runs, whose
# float atomics add in another order each time (measured <= 1.5e-7).
BWD_RTOL = 1e-5
BWD_RERUN_RTOL = 2e-6
# The march on the card vs the march on the CPU (the same torch ops): the
# same cells in the same order, f32 sums in another order (measured 1.1e-6
# on a depth-5 SH16 tree at 101x101). The shade's gradient sums each cell's
# contributions with float atomics on the card (measured 3.7e-5 of the
# largest |gradient|).
MARCH_ATOL = 2e-5
MARCH_GRAD_RTOL = 2e-4


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("basis_dim,res", [(1, 64), (16, 64), (16, 200)])
def test_kernel_matches_reference(basis_dim, res):
    _need_cuda()
    tree = build_scene_tree(depth=5, basis_dim=basis_dim, sh_noise=0.05, seed=1)
    r = TileRenderer(tree, step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2, device="cuda")
    _, c2ws, focal = render_synthetic_scene("test", 1, res, True, 2.0, 6.0)
    ti = r.make_tile_inputs_fn(res, res, focal, r.rcap, 16, r.ccap)
    p2 = ti(c2ws[0], r.index["csr"], r.index["base"], r.extra_data, r.index["blk_bbox"])[0]
    before = K.launches
    out = K.composite_tiles(*p2, r.index["soa"], **r._kernel_kw)
    ref = K.composite_tiles_reference(*p2, r.index["soa"], **r._kernel_kw)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [16, 32])
def test_cuda_frame_matches_cpu_frame(tile):
    """A whole frame on the card (phase 1 in torch, the CUDA kernel) vs the
    same renderer on the CPU (plain version): within 1e-4. Tile 32 (1024
    rays) runs as four blocks per tile, one per quad group."""
    _need_cuda()
    tree = build_scene_tree(depth=4, basis_dim=16, sh_noise=0.05, seed=2)
    _, c2ws, focal = render_synthetic_scene("test", 2, 47, True, 2.0, 6.0)
    gpu = TileRenderer(tree, grid_c=16, tile=tile, device="cuda")
    cpu = TileRenderer(tree, grid_c=16, tile=tile, device="cpu")
    for c2w in c2ws:
        a = gpu.render_persp(c2w, 47, 47, focal)
        b = cpu.render_persp(c2w, 47, 47, focal)
        assert np.abs(a - b).max() <= 1e-4


@pytest.mark.gpu
def test_wrapper_rejects_bad_inputs():
    _need_cuda()
    tree = build_scene_tree(depth=3)
    r = TileRenderer(tree, grid_c=16, device="cuda")
    _, c2ws, focal = render_synthetic_scene("test", 1, 32, True, 2.0, 6.0)
    ti = r.make_tile_inputs_fn(32, 32, focal, r.rcap, 8, r.ccap)
    p2 = list(ti(c2ws[0], r.index["csr"], r.index["base"], r.extra_data, r.index["blk_bbox"])[0])
    with pytest.raises(TypeError):
        K.composite_tiles(*p2[:5], p2[5].double(), *p2[6:], r.index["soa"], **r._kernel_kw)
    with pytest.raises(ValueError):
        K.composite_tiles(*p2[:5], p2[5].cpu(), *p2[6:], r.index["soa"], **r._kernel_kw)
    # A sigma_row off the data layout: the wrapper refuses it, and so does
    # the C entry (past the wrapper), since the kernel stages each piece only
    # up to sigma_row.
    kw = dict(r._kernel_kw, sigma_row=r._kernel_kw["sigma_row"] - 1)
    with pytest.raises(ValueError):
        K.composite_tiles(*p2, r.index["soa"], **kw)
    with pytest.raises(RuntimeError):
        K._launch_fwd(K.build(), tuple(p2), r.index["soa"], **kw)


def _trunk(depth, width, n_rgb, seed, device="cuda", posenc=None, sh_dim=0):
    params = init_trunk_params(np.random.default_rng(seed), 63, depth, width, 4, 1, n_rgb, 0.05)
    return trunk_weights(params, 4, device, posenc, sh_dim)


def _grad_rel_errs(got, want):
    return [float((a - b).abs().max() / (b.abs().max() + 1e-9)) for a, b in zip(got, want)]


def _check_noise_floor(n, flat, x, gs, gr, meta, basis, grads, ref):
    """At the sparsity pass's 10,000 rows, besides TRUNK_GRAD_RTOL: the
    kernel's gradients at most bench_trunk.TRUNK_SMALL_ROW_FACTOR times as
    far from an f64 evaluation of the same algorithm as the plain
    version's."""
    if n != 10000:
        return
    exact = bench_trunk.bwd_f64(flat, x, gs, gr, meta, basis)
    d_kernel, d_plain, ok = bench_trunk.within_noise_floor(grads, ref, exact)
    assert ok, (d_kernel, d_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 10000])
def test_fused_trunk_matches_reference(n):
    _need_cuda()
    flat, meta = _trunk(8, 256, 48, seed=n)
    rng = np.random.default_rng(n + 1)
    x = torch.tensor(rng.normal(size=(n, 63)), dtype=torch.float32, device="cuda")
    gs = torch.tensor(rng.normal(size=(n, 1)), dtype=torch.float32, device="cuda")
    gr = torch.tensor(rng.normal(size=(n, 48)), dtype=torch.float32, device="cuda")
    f0, b0 = F.fwd_launches, F.bwd_launches
    s, r = F.fused_trunk(flat, x, meta)
    grads = F.fused_trunk_bwd(flat, x, gs, gr, meta)
    torch.cuda.synchronize()
    assert (F.fwd_launches, F.bwd_launches) == (f0 + 1, b0 + 1)
    rs, rr = F.fused_trunk_reference(flat, x, meta)
    assert float((s - rs).abs().max()) <= TRUNK_FWD_ATOL
    assert float((r - rr).abs().max()) <= TRUNK_FWD_ATOL
    ref = F.fused_trunk_bwd_reference(flat, x, gs, gr, meta)
    assert [g.shape for g in grads] == [g.shape for g in ref]
    assert max(_grad_rel_errs(grads, ref)) <= TRUNK_GRAD_RTOL
    _check_noise_floor(n, flat, x, gs, gr, meta, None, grads, ref)
    again = F.fused_trunk_bwd(flat, x, gs, gr, meta)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 10000])
def test_fused_trunk_sg25_head_matches_reference(n):
    """The SG25 model's trunk (nerf_sh/config/misc/sg): a 1 + 75 column head,
    which the kernels pad to the wgmma width 128 (the SH16 head takes 64)."""
    _need_cuda()
    flat, meta = _trunk(8, 256, 75, seed=n + 7)
    assert meta["d_out"] == 76 and F._layout(meta).np == 128
    x, _, gs, gr = _variant_inputs(n, n + 8, None, 0, 75)
    s, r = F.fused_trunk(flat, x, meta)
    grads = F.fused_trunk_bwd(flat, x, gs, gr, meta)
    rs, rr = F.fused_trunk_reference(flat, x, meta)
    assert r.shape == rr.shape == (n, 75)
    assert float((s - rs).abs().max()) <= TRUNK_FWD_ATOL
    assert float((r - rr).abs().max()) <= TRUNK_FWD_ATOL
    ref = F.fused_trunk_bwd_reference(flat, x, gs, gr, meta)
    assert max(_grad_rel_errs(grads, ref)) <= TRUNK_GRAD_RTOL
    _check_noise_floor(n, flat, x, gs, gr, meta, None, grads, ref)
    again = F.fused_trunk_bwd(flat, x, gs, gr, meta)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
def test_fused_trunk_autograd_on_cuda():
    _need_cuda()
    flat, meta = _trunk(6, 64, 12, seed=3)
    x = torch.randn(1500, 63, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    w = [t.clone().requires_grad_() for t in flat]
    s, r = F.FusedTrunkFn.apply(meta, x, None, *w)
    (s.square().sum() + r.sum()).backward()
    ref = F.fused_trunk_bwd_reference(flat, x, 2 * s.detach(), torch.ones_like(r), meta)
    assert max(_grad_rel_errs([t.grad for t in w], ref)) <= TRUNK_GRAD_RTOL


def _variant_inputs(n, seed, posenc, sh_dim, n_rgb):
    """Raw points (posenc) or encoded x, a basis (SH decode) and cotangents."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    x = t(rng.uniform(-1.5, 1.5, (n, 3)) if posenc else rng.normal(size=(n, 63)))
    basis = t(rng.normal(size=(n, sh_dim))) if sh_dim else None
    gs = t(rng.normal(size=(n, 1)))
    gr = t(rng.normal(size=(n, n_rgb // sh_dim if sh_dim else n_rgb)))
    return x, basis, gs, gr


@pytest.mark.gpu
@pytest.mark.parametrize("posenc,sh_dim", [((0, 10), 0), (None, 16), ((0, 10), 16)])
@pytest.mark.parametrize("n", [4096, 10000])
def test_fused_trunk_variants_match_reference(posenc, sh_dim, n):
    """The in-kernel posenc, SH decode and both (the training configuration)
    against the plain versions, with bitwise-equal backward reruns."""
    _need_cuda()
    flat, meta = _trunk(8, 256, 48, seed=n, posenc=posenc, sh_dim=sh_dim)
    x, basis, gs, gr = _variant_inputs(n, n + 1, posenc, sh_dim, 48)
    counts = (F.fwd_launches, F.bwd_launches, F.posenc_launches, F.sh_launches)
    s, r = F.fused_trunk(flat, x, meta, basis)
    grads = F.fused_trunk_bwd(flat, x, gs, gr, meta, basis)
    torch.cuda.synchronize()
    assert (F.fwd_launches, F.bwd_launches, F.posenc_launches, F.sh_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 2 * bool(posenc), counts[3] + 2 * bool(sh_dim))
    rs, rr = F.fused_trunk_reference(flat, x, meta, basis)
    assert r.shape == rr.shape == (n, 3 if sh_dim else 48)
    assert float((s - rs).abs().max()) <= TRUNK_FWD_ATOL
    assert float((r - rr).abs().max()) <= TRUNK_FWD_ATOL
    ref = F.fused_trunk_bwd_reference(flat, x, gs, gr, meta, basis)
    assert max(_grad_rel_errs(grads, ref)) <= TRUNK_GRAD_RTOL
    _check_noise_floor(n, flat, x, gs, gr, meta, basis, grads, ref)
    again = F.fused_trunk_bwd(flat, x, gs, gr, meta, basis)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("sh_dim", [0, 25])
@pytest.mark.parametrize("n", [4096, 10000])
def test_fused_trunk_sh25_head_matches_reference(sh_dim, n):
    """The SH25 head (nerf_sh/config/tt: 1 + 75 columns, padded to 128),
    raw coefficients and the in-kernel decode against a degree-4 SH basis
    of random unit directions (the main path's basis, as chip_smoke.py's
    phase 7 draws it: bench_trunk.inputs), against the plain versions. With
    N(0, 1) values in place of a basis the 4096-row gradient check reads
    rounding noise: 5.5e-2 from the plain version, the kernel 1.9x the
    plain version's distance from an f64 evaluation (PERF.md)."""
    _need_cuda()
    flat, meta = _trunk(8, 256, 75, seed=n, sh_dim=sh_dim)
    x, basis, gs, gr = bench_trunk.inputs(n, n + 1, None, sh_dim, "cuda", 75)
    f0, b0 = F.fwd_launches, F.bwd_launches
    s, r = F.fused_trunk(flat, x, meta, basis)
    grads = F.fused_trunk_bwd(flat, x, gs, gr, meta, basis)
    torch.cuda.synchronize()
    assert (F.fwd_launches, F.bwd_launches) == (f0 + 1, b0 + 1)
    rs, rr = F.fused_trunk_reference(flat, x, meta, basis)
    assert r.shape == rr.shape == (n, 3 if sh_dim else 75)
    assert float((s - rs).abs().max()) <= TRUNK_FWD_ATOL
    assert float((r - rr).abs().max()) <= TRUNK_FWD_ATOL
    ref = F.fused_trunk_bwd_reference(flat, x, gs, gr, meta, basis)
    assert max(_grad_rel_errs(grads, ref)) <= TRUNK_GRAD_RTOL
    _check_noise_floor(n, flat, x, gs, gr, meta, basis, grads, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("res", [64, 201])
def test_ndc_tile_kernel_matches_reference(res):
    """NDC serving (per-ray origins, segment-AABB group masks): the tile
    kernel against its plain version on a forward-facing pose, and a whole
    NDC frame on the card against the CPU renderer's (within 1e-4)."""
    _need_cuda()
    from plenoctree_tpu_torch.octree.renderer import make_ndc_config

    tree = build_scene_tree(depth=5, basis_dim=16, sh_noise=0.05, seed=3)
    focal = 1.2 * res
    ndc = make_ndc_config(res, res, focal)
    c2w = np.eye(4, dtype=np.float32)
    c2w[0, 3], c2w[1, 3] = 0.12, -0.05
    r = TileRenderer(tree, step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2, ndc=ndc,
                     device="cuda")
    ti = r.make_tile_inputs_fn(res, res, focal, r.rcap, 16, r.ccap)
    p2 = ti(c2w, r.index["csr"], r.index["base"], r.extra_data, r.index["blk_bbox"])[0]
    before = K.launches
    out = K.composite_tiles(*p2, r.index["soa"], **r._kernel_kw)
    ref = K.composite_tiles_reference(*p2, r.index["soa"], **r._kernel_kw)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    assert torch.isfinite(out).all() and float((out - ref).abs().max()) <= ATOL
    cpu = TileRenderer(tree, step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2, ndc=ndc,
                       device="cpu", index=None)
    a = r.render_persp(c2w, res, res, focal)
    b = cpu.render_persp(c2w, res, res, focal)
    assert np.abs(a - b).max() <= 1e-4 and np.abs(a - 1.0).max() > 0.1


@pytest.mark.gpu
def test_fused_trunk_autograd_with_basis_on_cuda():
    """FusedTrunkFn with both variants: the basis is saved for the backward
    and gets no gradient, nor do the raw points."""
    _need_cuda()
    flat, meta = _trunk(6, 64, 12, seed=6, posenc=(0, 10), sh_dim=4)
    x, basis, _, _ = _variant_inputs(1500, 7, (0, 10), 4, 12)
    basis.requires_grad_()
    w = [t.clone().requires_grad_() for t in flat]
    s, r = F.FusedTrunkFn.apply(meta, x, basis, *w)
    assert r.shape == (1500, 3)
    (s.square().sum() + r.sum()).backward()
    ref = F.fused_trunk_bwd_reference(flat, x, 2 * s.detach(), torch.ones_like(r), meta,
                                      basis.detach())
    assert max(_grad_rel_errs([t.grad for t in w], ref)) <= TRUNK_GRAD_RTOL
    assert basis.grad is None


@pytest.mark.gpu
def test_fused_trunk_rejects_bad_inputs():
    _need_cuda()
    flat, meta = _trunk(6, 64, 12, seed=4)
    x = torch.randn(100, 63, device="cuda")
    with pytest.raises(TypeError):
        F.fused_trunk(flat, x.double(), meta)
    with pytest.raises(TypeError):
        F.fused_trunk([t.half() for t in flat], x, meta)
    with pytest.raises(ValueError):
        F.fused_trunk(flat, x.cpu(), meta)
    # The variants' inputs: raw f32 [N, 3] points with min_deg >= 0, an f32
    # [N, sh_dim] basis.
    pts = torch.rand(100, 3, device="cuda")
    with pytest.raises(ValueError):
        F.fused_trunk(flat, pts, dict(meta, posenc=(-1, 9)))
    with pytest.raises(ValueError):
        F.fused_trunk(flat, x, dict(meta, sh_dim=4), torch.ones(100, 3, device="cuda"))
    with pytest.raises(TypeError):
        F.fused_trunk(flat, x, dict(meta, sh_dim=4), torch.ones(100, 4, device="cuda").double())
    # A layout the kernels cannot take (width over 256): the C side refuses it.
    wide, wide_meta = _trunk(2, 320, 12, seed=5)
    g = torch.ones(100, 13, device="cuda")
    with pytest.raises(RuntimeError, match="invalid argument"):
        F.fused_trunk(wide, x, wide_meta)
    with pytest.raises(RuntimeError, match="invalid argument"):
        F.fused_trunk_bwd(wide, x, g[:, :1], g[:, 1:], wide_meta)


@pytest.mark.gpu
def test_train_steps_on_cuda_match_cpu():
    """Two train steps with the fused kernels on the card against the same
    two steps on the CPU (plain versions), same weights, rays and draws."""
    _need_cuda()
    from plenoctree_tpu_torch import engine
    from plenoctree_tpu_torch.data.rays import Rays
    from plenoctree_tpu_torch.models.nerf import construct_nerf
    from plenoctree_tpu_torch.utils import checkpoints as ckpt
    from plenoctree_tpu_torch.utils.config import default_config

    cfg = default_config(
        net_depth=6, net_width=64, sh_deg=1, use_viewdirs=False, num_coarse_samples=16,
        num_fine_samples=16, batch_size=256, sparsity_npoints=1000, randomized=False,
        compute_dtype="bfloat16", use_pallas=True, lr_init=5e-4,
    )
    rng = np.random.default_rng(5)
    o = rng.normal(size=(256, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(size=(256, 3)) * 0.3 - o / 4.0
    host = {
        "rays": [o, d, d / np.linalg.norm(d, axis=-1, keepdims=True)],
        "pixels": rng.uniform(size=(256, 3)), "sp": rng.uniform(-1.5, 1.5, (1000, 3)),
    }
    runs = {}
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        model = construct_nerf(cfg, seed=3).to(dev)
        state = ckpt.create_train_state(model)
        step = engine.make_train_step(model, cfg)
        batch = {"rays": Rays(*map(t, host["rays"])), "pixels": t(host["pixels"])}
        f0 = F.fwd_launches
        stats = [step(state, batch, None, {"sp_points": t(host["sp"])})[1] for _ in range(2)]
        if dev == "cuda":
            torch.cuda.synchronize()
            assert F.fwd_launches > f0
        runs[dev] = ([float(s.loss) for s in stats], {k: v.detach().cpu() for k, v in state.params.items()})
    (loss_cpu, p_cpu), (loss_gpu, p_gpu) = runs["cpu"], runs["cuda"]
    # Step 1 starts from equal weights: the kernels' bf16 rounding only.
    np.testing.assert_allclose(loss_gpu[0], loss_cpu[0], rtol=2e-3)
    # Adam normalises each step to ~lr, so a near-zero gradient that differs
    # in sign moves a weight by up to 2 lr per step; step 2's loss then
    # differs by more (measured 2.6e-3 relative on the H100).
    np.testing.assert_allclose(loss_gpu[1], loss_cpu[1], rtol=1e-2)
    assert max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu) <= 4 * 5e-4 + 1e-6


def _exact_inputs(depth, basis_dim, res, device="cuda", tile=16):
    """An exact-mode optimizer (keep_all index) and its tile inputs for one
    pose at res x res."""
    tree = build_scene_tree(depth=depth, basis_dim=basis_dim, sh_noise=0.05, seed=1)
    opt = TileOptimizer(tree, step_size=1e-4, grid_c=16, ccap=4096, tile=tile, device=device)
    _, c2ws, focal = render_synthetic_scene("test", 1, res, True, 2.0, 6.0)
    r = opt.r
    ti = r.make_tile_inputs_fn(res, res, focal, r.rcap, 16, r.ccap)
    p2 = ti(c2ws[0], r.index["csr"], r.index["base"], r.extra_data, r.index["blk_bbox"])[0]
    return opt, p2


def _group_errs(a, b, sigma_row):
    out = {}
    for name, sl in (("colour", slice(6, sigma_row)), ("sigma", slice(sigma_row, sigma_row + 1))):
        ref = b[:, sl].abs().max().item()
        out[name] = (a[:, sl] - b[:, sl]).abs().max().item() / max(ref, 1e-30)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("depth,basis_dim,res,tile", [(4, 16, 64, 16), (5, 1, 128, 16), (4, 16, 64, 32)])
def test_tile_bwd_kernel_matches_reference(depth, basis_dim, res, tile):
    """The exact-mode forward and the backward kernel against their plain
    versions; tile 32 (1024 rays) runs both kernels as four blocks per tile,
    one per quad group."""
    _need_cuda()
    opt, p2 = _exact_inputs(depth, basis_dim, res, tile=tile)
    soa = opt.static_soa
    exact = dict(opt._kw, stop_thresh=0.0, od_cap=1e30)
    out = K.composite_tiles(*p2, soa, **exact)
    assert float((out - K.composite_tiles_reference(*p2, soa, **exact)).abs().max()) <= ATOL
    g = torch.tensor(np.random.default_rng(res).normal(size=out.shape), dtype=torch.float32,
                     device="cuda")
    before = K.bwd_launches
    got = K.composite_tiles_bwd(*p2, soa, out, g, **opt._kw)
    again = K.composite_tiles_bwd(*p2, soa, out, g, **opt._kw)
    torch.cuda.synchronize()
    assert K.bwd_launches == before + 2
    ref = K.composite_tiles_bwd_reference(*p2, soa, out, g, **opt._kw)
    sr = int(opt.r.index["sigma_row"])
    assert torch.isfinite(got).all() and not got[:, :6].any() and not got[:, sr + 1 :].any()
    assert max(_group_errs(got, ref, sr).values()) <= BWD_RTOL
    assert max(_group_errs(again, got, sr).values()) <= BWD_RERUN_RTOL


def _sg25_tree(depth):
    """The scene tree with an SG25 payload (data_dim 76, fields 82 in the
    soa): seeded amplitudes and lobes (softplus-ed lambda, unit mu)."""
    from plenoctree_tpu_torch.octree.n3tree import DataFormat

    tree = build_scene_tree(depth=depth, basis_dim=25, sh_noise=0.05, seed=2)
    tree.data_format = DataFormat("SG25")
    rng = np.random.default_rng(3)
    mu = rng.normal(size=(25, 3))
    mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
    tree.extra_data = np.concatenate([rng.uniform(0.5, 3.0, (25, 1)), mu], -1).astype(np.float32)
    return tree


@pytest.mark.gpu
def test_sg25_tile_kernels_match_reference_on_a_tree():
    """An SG25 tree through the tile optimizer's exact-mode inputs (bd 25,
    82 rows padded to 88 fields, runrows 128, 256 rays per tile): both
    kernels against their plain versions. The kernels stage the 82 rows
    they read, not the padding: the backward then fits a block's shared
    memory with 1,280 bytes to spare (231,168 of 232,448; the 88 padded
    rows would need 237,312)."""
    _need_cuda()
    tree = _sg25_tree(4)
    opt = TileOptimizer(tree, step_size=1e-4, grid_c=16, ccap=4096, device="cuda")
    _, c2ws, focal = render_synthetic_scene("test", 1, 64, True, 2.0, 6.0)
    r = opt.r
    ti = r.make_tile_inputs_fn(64, 64, focal, r.rcap, 16, r.ccap)
    p2 = ti(c2ws[0], r.index["csr"], r.index["base"], r.extra_data, r.index["blk_bbox"])[0]
    soa, kw = opt.static_soa, opt._kw
    assert (kw["basis_dim"], kw["sigma_row"], soa.shape[1], kw["runrows"]) == (25, 81, 88, 128)
    smem = K.build().pn_tile_composite_bwd_smem_bytes(256, 25, 3, 82, 128, kw["quantum"])
    assert smem == 231168 <= K._MAX_SMEM
    for mode in (dict(kw, stop_thresh=1e-2, od_cap=-float(np.log(1e-2))),
                 dict(kw, stop_thresh=0.0, od_cap=1e30)):
        out = K.composite_tiles(*p2, soa, **mode)
        assert float((out - K.composite_tiles_reference(*p2, soa, **mode)).abs().max()) <= ATOL
    g = torch.tensor(np.random.default_rng(4).normal(size=out.shape), dtype=torch.float32,
                     device="cuda")
    got = K.composite_tiles_bwd(*p2, soa, out, g, **kw)
    ref = K.composite_tiles_bwd_reference(*p2, soa, out, g, **kw)
    sr = kw["sigma_row"]
    assert float(ref[:, 6:sr].abs().max()) > 0
    assert torch.isfinite(got).all() and not got[:, :6].any() and not got[:, sr + 1 :].any()
    assert max(_group_errs(got, ref, sr).values()) <= BWD_RTOL


def _synthetic_tiles(tile, bd, nc, seed, runrows=128, quantum=128, n_tiles=5, n_pieces=11):
    """Phase-1 inputs made by hand, to reach what a scene seldom shows: rows
    in tie groups (identical boxes, so equal keys, other sigma and colour:
    the row index decides their order), sigma <= 0 and sigma > 0 rows
    outside their run's [lo, hi), empty runs and zero quad-group masks
    (chunks with no live row or no group), a tile without pieces, dense
    high-sigma boxes (serving thresholds saturate rays mid-tile), a wall
    that saturates every ray of tile 1 in its first chunk (the tile stops
    there, with the next chunk's copy in flight), and
    pieces over several chunks (the last one partly filled when a chunk
    holds several pieces). Returns (p2, soa, kw without the thresholds)."""
    rng = np.random.default_rng(seed)
    rays = tile * tile
    fields = 6 + nc * bd + 1
    n_blk = 16
    center = rng.uniform(-0.7, 0.7, (n_blk + 1, quantum, 3))
    half = rng.uniform(0.05, 0.3, (n_blk + 1, quantum, 3))
    tie = np.arange(quantum) // 4 * 4  # rows 4j..4j+3 share row 4j's box
    center, half = center[:, tie], half[:, tie]
    center[n_blk], half[n_blk] = 0.0, 1.0  # a wall of tied boxes, only in tile 1's first piece
    soa = np.zeros((n_blk + 1, fields, quantum), np.float32)
    soa[:, 0:3] = (center - half).transpose(0, 2, 1)
    soa[:, 3:6] = (center + half).transpose(0, 2, 1)
    soa[:, 6:-1] = rng.normal(0.0, 0.5, (n_blk + 1, nc * bd, quantum))
    sigma = rng.normal(2.0, 3.0, (n_blk + 1, quantum))
    sigma[rng.random((n_blk + 1, quantum)) < 0.2] = 0.0
    sigma[n_blk] = 0.5
    soa[:, -1] = sigma
    ccap = n_pieces + 3
    c0 = rng.integers(0, n_blk, (n_tiles, ccap)) * quantum
    lo = c0 + rng.integers(0, quantum // 2, (n_tiles, ccap))
    hi = lo + rng.integers(0, quantum // 2 + 1, (n_tiles, ccap))
    hi[:, 1] = lo[:, 1]  # an empty run
    c0[1, 0], lo[1, 0], hi[1, 0] = n_blk * quantum, n_blk * quantum, (n_blk + 1) * quantum
    mask = rng.integers(1, 16, (n_tiles, ccap))
    mask[:, 2] = 0  # no quad group
    mask[1, 0] = 15
    meta = np.zeros((n_tiles, 1, 4), np.int32)
    meta[:, 0, 0] = n_pieces - np.arange(n_tiles) % 3
    meta[-1, 0, 0] = 0
    spread = np.full((n_tiles, 1, 1), 0.2)
    spread[1] = 0.02  # tile 1's rays all meet the wall
    d = np.concatenate([rng.normal(0.0, 1.0, (n_tiles, rays, 2)) * spread,
                        np.ones((n_tiles, rays, 1))], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((n_tiles, rays, 4))
    o[..., :3] = rng.normal(0.0, 0.05, (n_tiles, rays, 3)) + [0.0, 0.0, -3.0]
    invd = np.zeros((n_tiles, rays, 4))
    invd[..., :3] = 1.0 / d
    aux = np.zeros((n_tiles, rays, 4))
    aux[..., 0], aux[..., 1], aux[..., 2] = 1.0, 0.0, 100.0
    mdir = np.zeros((n_tiles, 1, 4))
    md = d.mean(1)
    mdir[:, 0, :3] = md / np.linalg.norm(md, axis=-1, keepdims=True)
    basis = rng.normal(0.0, 0.4, (n_tiles, rays, bd))
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device="cuda")  # noqa: E731
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device="cuda")  # noqa: E731
    p2 = (i32(meta), i32(c0[:, None]), i32(lo[:, None]), i32(hi[:, None]), i32(mask[:, None]),
          f32(o), f32(invd), f32(aux), f32(mdir), f32(basis))
    kw = dict(basis_dim=bd, n_channels=nc, sigma_row=fields - 1, runrows=runrows,
              quantum=quantum, step_eps=1e-4)
    return p2, f32(soa), kw


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("bd,nc,fmt", [(1, 1, "RGBA"), (1, 3, "SH"), (4, 3, "SH"), (9, 1, "SH"),
                                       (16, 3, "SH"), (25, 3, "SG")])
def test_tile_kernels_match_reference_on_hand_made_tiles(tile, bd, nc, fmt):
    """Both tile kernels against their plain versions on _synthetic_tiles:
    the forward with serving thresholds (rays saturate) and in exact mode,
    the backward on the exact-mode output, and its reruns."""
    _need_cuda()
    _check_tile_kernels(*_synthetic_tiles(tile, bd, nc, seed=bd * 10 + nc + tile), fmt)


@pytest.mark.gpu
@pytest.mark.parametrize("runrows,quantum", [(256, 128), (128, 64), (128, 32)])
def test_tile_kernels_match_reference_with_several_pieces_per_chunk(runrows, quantum):
    """As above with 2 or 4 pieces per chunk (the backward refuses runrows
    256)."""
    _need_cuda()
    _check_tile_kernels(*_synthetic_tiles(16, 16, 3, seed=runrows + quantum, runrows=runrows,
                                          quantum=quantum), "SH")


def _check_tile_kernels(p2, soa, kw, fmt):
    kw = dict(kw, fmt=fmt)
    serving = dict(kw, stop_thresh=1e-2, od_cap=-float(np.log(1e-2)))
    exact = dict(kw, stop_thresh=0.0, od_cap=1e30)
    for mode in (serving, exact):
        out = K.composite_tiles(*p2, soa, **mode)
        ref = K.composite_tiles_reference(*p2, soa, **mode)
        assert torch.isfinite(out).all()
        assert float((out - ref).abs().max()) <= ATOL
    trans = out[..., kw["n_channels"]]
    assert float(trans.min()) < 1e-2 < float(trans.max())  # some rays saturate, some stay clear
    g = torch.tensor(np.random.default_rng(7).normal(size=out.shape), dtype=torch.float32,
                     device="cuda")
    if kw["runrows"] > 128:  # two chunk gradients of 256 rows would not fit in shared memory
        with pytest.raises(ValueError):
            K.composite_tiles_bwd(*p2, soa, out, g, **kw)
        return
    got = K.composite_tiles_bwd(*p2, soa, out, g, **kw)
    again = K.composite_tiles_bwd(*p2, soa, out, g, **kw)
    ref = K.composite_tiles_bwd_reference(*p2, soa, out, g, **kw)
    sr = kw["sigma_row"]
    assert torch.isfinite(got).all() and not got[:, :6].any()
    assert float(ref[:, sr].abs().max()) > 0 and float(ref[:, 6:sr].abs().max()) > 0
    assert max(_group_errs(got, ref, sr).values()) <= BWD_RTOL
    assert max(_group_errs(again, got, sr).values()) <= BWD_RERUN_RTOL


@pytest.mark.gpu
def test_composite_tiles_fn_cuda_matches_cpu():
    """CompositeTilesFn forward and soa gradient on the card (both kernels)
    against the CPU (plain versions) on the same inputs."""
    _need_cuda()
    grads, outs = {}, {}
    for dev in ("cpu", "cuda"):
        opt, p2 = _exact_inputs(4, 16, 47, device=dev)
        soa = opt.static_soa.clone().requires_grad_(True)
        out = CompositeTilesFn.apply(opt._kw, soa, *p2)
        g = torch.tensor(np.random.default_rng(0).normal(size=out.shape), dtype=torch.float32,
                         device=dev)
        (grads[dev],) = torch.autograd.grad((out * g).sum(), soa)
        outs[dev] = out.detach().cpu()
    assert float((outs["cuda"] - outs["cpu"]).abs().max()) <= ATOL
    sr = int(opt.r.index["sigma_row"])
    assert max(_group_errs(grads["cuda"].cpu(), grads["cpu"], sr).values()) <= BWD_RTOL


@pytest.mark.gpu
def test_optimize_epoch_cuda_matches_cpu():
    """One optimize_tree_tiles epoch (SGD at lr 1e5 over the 12 synthetic
    train views at 32x32, validated on the 4 val views; the DC colour
    coefficients of a depth-4 SH16 tree washed to 0) on the card and on the
    CPU: the same val PSNR within 1e-3 dB and leaf data within 1e-4."""
    _need_cuda()
    from plenoctree_tpu_torch.utils.config import default_config

    images, c2ws, focal = render_synthetic_scene("train", 12, 32, True, 2.0, 6.0)
    val_images, val_c2ws, _ = render_synthetic_scene("val", 4, 32, True, 2.0, 6.0)
    runs = {}
    for dev in ("cpu", "cuda"):
        tree = build_scene_tree(depth=4, basis_dim=16, sh_noise=0.05, seed=2)
        tree.data[..., [0, 16, 32]] = 0.0
        best, psnr = optimize_tree_tiles(
            tree, c2ws, images, val_c2ws, val_images, focal,
            default_config(renderer_step_size=1e-5), num_epochs=1, lr=1e5, val_interval=1,
            grid_c=16, device=dev,
        )
        assert best is not None
        runs[dev] = (best.data, psnr)
    assert abs(runs["cuda"][1] - runs["cpu"][1]) <= 1e-3
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_tile_bwd_rejects_bad_inputs():
    _need_cuda()
    opt, p2 = _exact_inputs(3, 1, 32)
    soa = opt.static_soa
    out = K.composite_tiles(*p2, soa, **opt._kw, stop_thresh=0.0, od_cap=1e30)
    g = torch.ones_like(out)
    with pytest.raises(ValueError):
        K.composite_tiles_bwd(*p2, soa, out, g[:, :, :4].contiguous(), **opt._kw)
    with pytest.raises(ValueError):
        K.composite_tiles_bwd(*p2, soa, out, g.cpu(), **opt._kw)
    with pytest.raises(TypeError):
        K.composite_tiles_bwd(*p2[:5], p2[5].double(), *p2[6:], soa, out, g, **opt._kw)
    with pytest.raises(ValueError):
        K.composite_tiles_bwd(*p2, soa, out, g, **dict(opt._kw, sigma_row=opt._kw["sigma_row"] + 1))


def _gather_tol(n, rms=1.0):
    """f32 sums of n zero-mean terms vs float64: 2^-24 per addition of a
    running sum that stays within ~4 sqrt(n) rms (tests/test_torch_gather.py)."""
    return 2.0**-24 * n * 4.0 * np.sqrt(n) * rms


@pytest.mark.gpu
@pytest.mark.parametrize(
    "groups,unroll,placement,rows,n",
    [(1, 1, "auto", 32768, 256 * 8192), (1, 8, "auto", 32768, 256 * 8192),
     (8, 1, "auto", 32768, 256 * 8192), (8, 8, "auto", 32768, 256 * 8192),
     (1, 8, "l2", 32768, 256 * 8192), (8, 1, "l2", 32768, 256 * 8192),
     (1, 8, "smem", 1024, 256 * 8192), (8, 1, "smem", 1024, 64 * 8192),
     (1, 8, "auto", 1 << 20, 1000003)],
)
def test_gather_sum_kernel_matches_reference(groups, unroll, placement, rows, n):
    """Every variant at the probes' sizes (the 32k-row table sliced, "auto",
    and through L2; the 1k-row table in shared memory; a ragged stream on
    the 1M-row table, through L2) against the plain version and a float64
    sum; reruns equal."""
    _need_cuda()
    rng = np.random.default_rng(rows + n + groups)
    table = torch.tensor(rng.normal(size=(rows, 56)), dtype=torch.float32, device="cuda")
    idx = torch.tensor(rng.integers(0, rows, size=n), dtype=torch.int32, device="cuda")
    before = G.launches
    out = G.gather_sum(idx, table, groups, unroll, placement)
    again = G.gather_sum(idx, table, groups, unroll, placement)
    torch.cuda.synchronize()
    assert G.launches == before + 2 and torch.equal(out, again)
    ref = G.gather_sum_reference(idx, table, groups)
    f64 = table.double().index_select(0, idx.long()).reshape(-1, groups, 56).sum(0)
    tol = _gather_tol(n // groups)
    assert float((out.double() - f64).abs().max()) <= tol
    assert float((ref.double() - f64).abs().max()) <= tol


@pytest.mark.gpu
def test_gather_sum_rejects_bad_inputs():
    _need_cuda()
    table = torch.zeros(2048, 56, device="cuda")
    idx = torch.zeros(64, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        G.gather_sum(idx.long(), table)
    with pytest.raises(TypeError):
        G.gather_sum(idx, table.double())
    with pytest.raises(ValueError, match="multiple of 4"):
        G.gather_sum(idx, torch.zeros(2048, 50, device="cuda"))
    with pytest.raises(ValueError, match="shared memory"):
        G.gather_sum(idx, table, placement="smem")  # 2048 x 56 x 4 B > 232,448
    with pytest.raises(ValueError, match="shared memory a slice"):
        G.gather_sum(idx, torch.zeros(1 << 20, 56, device="cuda"), placement="sliced")
    with pytest.raises(ValueError, match="placement"):
        G.gather_sum(idx, table, placement="vmem")
    with pytest.raises(ValueError, match="16-byte"):
        G.gather_sum(idx, torch.zeros(2049 * 56 + 1, device="cuda")[1:].view(2049, 56))
    with pytest.raises(ValueError):
        G.gather_sum(idx.cpu(), table)
    assert torch.equal(G.gather_sum(idx[:0], table), torch.zeros(1, 56, device="cuda"))


def _gather_streams(rows, S, rps, n, seed):
    """Index streams for the sliced placement's routing: uniform; every
    index in one slice (the last, short one); 90% of them row 0
    (bench_gather's mostly_zero); each slice's first and last rows only."""
    rng = np.random.default_rng(seed)
    last = (S - 1) * rps
    edges = np.unique(np.concatenate([np.arange(S) * rps, np.minimum(np.arange(1, S + 1) * rps, rows) - 1]))
    mostly_zero = rng.integers(0, rows, n)
    mostly_zero[rng.random(n) < 0.9] = 0
    return {
        "uniform": rng.integers(0, rows, n),
        "one_slice": rng.integers(last, rows, n),
        "mostly_zero": mostly_zero,
        "slice_edges": rng.choice(edges, n),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("placement,rows", [
    ("sliced", 264), ("sliced", 265), ("sliced", 528), ("sliced", 1000), ("sliced", 32768),
    ("sliced", 33001), ("smem", 264), ("smem", 265), ("smem", 1000)])
@pytest.mark.parametrize("groups", [1, 8])
def test_gather_sum_placements_match_reference(placement, rows, groups):
    """The sliced and shared-memory placements against the plain version
    and a float64 sum: G = 1 and 8, [K, R] and [R, K] streams, tables at
    and beside the slice boundaries of 132 SMs (264 one-row slices, one row
    more, two-row slices, a short last slice), skewed streams (all in one
    slice, mostly row 0, slice edges), reruns bitwise equal. Tolerance: each
    f32 addition errs by at most 2^-24 of the running sum, which is at most
    the sum of the rows' magnitudes, so |out - f64| <= 2^-24 * chain *
    sum |rows| with chain the launch's longest addition chain."""
    _need_cuda()
    table = torch.tensor(np.random.default_rng(rows).normal(size=(rows, 56)), dtype=torch.float32,
                         device="cuda")
    p = G.plan(8192 * 24, rows, 56, groups, "sliced", G.sm_count("cuda"))
    for name, flat in _gather_streams(rows, p["S"], p["rps"], 8192 * 24, rows + groups).items():
        for shape in ((24, 8192), (8192, 24)):
            idx = torch.tensor(flat.reshape(shape), dtype=torch.int32, device="cuda")
            before = G.launches
            out = G.gather_sum(idx, table, groups, 8, placement)
            again = G.gather_sum(idx, table, groups, 8, placement)
            torch.cuda.synchronize()
            assert G.launches == before + 2 and torch.equal(out, again), (name, shape)
            rows64 = table.double().index_select(0, idx.reshape(-1).long()).reshape(-1, groups, 56)
            f64, mag = rows64.sum(0), rows64.abs().sum(0)
            chain = G.addition_chain(idx, table, groups, placement, G.sm_count("cuda"))
            tol = 2.0**-24 * chain * mag
            assert bool(((out.double() - f64).abs() <= tol).all()), (name, shape)
            ref = G.gather_sum_reference(idx, table, groups)
            assert bool(((ref.double() - f64).abs() <= 2.0**-24 * idx.numel() * mag).all())


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True])
def test_march_cuda_matches_cpu(fast):
    """VolumeRenderer on the card against the same renderer on the CPU: a
    depth-5 SH16 tree at 101x101, exact (step 1e-5) and fast, with the same
    accel grid; and the march optimizer's shade gradient on both devices."""
    _need_cuda()
    from plenoctree_tpu_torch.octree.optimize import TwoPhaseRenderer, _image_rays
    from plenoctree_tpu_torch.octree.renderer import RenderOptions, VolumeRenderer, tree_arrays

    tree = build_scene_tree(depth=5, basis_dim=16, sh_noise=0.05, seed=1)
    images, c2ws, focal = render_synthetic_scene("test", 1, 101, True, 2.0, 6.0)
    rs = [VolumeRenderer(tree, step_size=1e-5, device=dev) for dev in ("cuda", "cpu")]
    assert torch.equal(rs[0].arrays["accel"].cpu(), rs[1].arrays["accel"])
    imgs = [r.render_persp(c2ws[0], 101, 101, focal, fast=fast) for r in rs]
    assert np.abs(imgs[0] - imgs[1]).max() <= MARCH_ATOL
    o, d = _image_rays(c2ws[0], 101, 101, focal, None)
    grads = []
    for dev in ("cuda", "cpu"):
        opts = RenderOptions(step_size=1e-5, max_segments=96)
        r = TwoPhaseRenderer(tree_arrays(tree, device=dev), "SH", 16, opts, K=128)
        gt = torch.tensor(images[0].reshape(-1, 3), device=dev)
        sq, g, over = r.loss_grad(r.data0, o, d, gt, torch.ones(o.shape[0], 1, device=dev))
        assert not bool(over)
        grads.append(g.cpu())
    assert float((grads[0] - grads[1]).abs().max()) <= MARCH_GRAD_RTOL * float(grads[1].abs().max())


@pytest.mark.gpu
def test_gen_mesh_trunk_kernel_matches_plain_at_chunk_rows():
    """gen_mesh's dispatch: 720,720 grid points of the published 300^3 grid
    through make_points_fn with --use_pallas (one forward kernel launch)
    against the plain trunk on the same points."""
    _need_cuda()
    from plenoctree_tpu_torch.cli import gen_mesh
    from plenoctree_tpu_torch.models.nerf import construct_nerf
    from plenoctree_tpu_torch.octree.extract import make_points_fn
    from plenoctree_tpu_torch.utils.config import default_config

    from plenoctree_tpu_torch.utils.config import update_flags

    cfg = default_config(config="nerf_sh/config/blender")
    update_flags(cfg)
    cfg.use_pallas, cfg.compute_dtype = True, "bfloat16"
    model = construct_nerf(cfg, seed=0).cuda().eval()
    axes = gen_mesh.grid_axes([300] * 3, [-2.0] * 3, [2.0] * 3)
    pts = gen_mesh.device_grid(axes, "cuda")[:720720]
    before = F.fwd_launches
    _, sigma = make_points_fn(model, "cuda")(pts)
    torch.cuda.synchronize()
    assert F.fwd_launches - before == 1
    model.use_pallas = False
    _, plain = make_points_fn(model, "cuda")(pts)
    assert torch.isfinite(sigma).all() and sigma.shape == (720720, 1)
    assert float((sigma - plain).abs().max()) <= TRUNK_FWD_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_marching_cuda_matches_cpu_bitwise(seed):
    _need_cuda()
    from plenoctree_tpu_torch.ops.marching import marching_tetrahedra

    g = torch.linspace(-1, 1, 40, dtype=torch.float64)
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    noise = torch.from_numpy(np.random.default_rng(seed).normal(size=(40, 40, 40)) * 0.05)
    vol = (0.6 - (x * x + y * y + z * z).sqrt() + noise).float()
    vc, tc = marching_tetrahedra(vol, 0.0)
    vg, tg = marching_tetrahedra(vol.cuda(), 0.0)
    assert len(tc) > 1000
    assert torch.equal(vg.cpu(), vc) and torch.equal(tg.cpu(), tc)


@pytest.mark.gpu
def test_jax_orbax_fixture_restores_on_cuda():
    """The committed checkpoint that the JAX package's save_checkpoint wrote
    (tests/torch_fixtures/jax_ckpt, an orbax directory) restored onto the
    card, bitwise against the arrays it holds."""
    _need_cuda()
    import os

    from plenoctree_tpu_torch.models.nerf import get_model_state
    from plenoctree_tpu_torch.utils.config import default_config, update_flags

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "jax_ckpt")
    want = np.load(os.path.join(root, "want.npz"))
    cfg = default_config(config="nerf_sh/config/blender")
    update_flags(cfg)
    cfg.net_depth, cfg.net_width, cfg.train_dir = 2, 16, os.path.join(root, "train_state")
    _, state = get_model_state(cfg, restore=True, device="cuda")
    assert state.step == 3 and state.opt_state["count"] == 3
    for group, tensors in (("params", state.params), ("mu", state.opt_state["mu"]),
                           ("nu", state.opt_state["nu"])):
        for k, t in tensors.items():
            assert t.is_cuda
            np.testing.assert_array_equal(t.detach().cpu().numpy(),
                                          want[f"train_state/{group}/{k}"])


def _dp_inputs(n=256, seed=60):
    """Weights, warm Adam moments (a smooth update), one global batch and its
    draws for the data-parallel tests."""
    from plenoctree_tpu_torch.data.rays import Rays
    from plenoctree_tpu_torch.models.nerf import construct_nerf
    from plenoctree_tpu_torch.utils.config import default_config

    cfg = dict(net_depth=6, net_width=64, sh_deg=1, use_viewdirs=False, num_coarse_samples=16,
               num_fine_samples=16, batch_size=n, sparsity_npoints=1000, randomized=True,
               compute_dtype="bfloat16", use_pallas=True)
    params = {k: v.numpy() for k, v in construct_nerf(default_config(**cfg), seed=3)
              .state_dict().items()}
    rng = np.random.default_rng(seed)
    opt = {"count": 10,
           "mu": {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32) for k, v in params.items()},
           "nu": {k: ((rng.uniform(0.5, 1.5, v.shape) * 1e-3) ** 2).astype(np.float32)
                  for k, v in params.items()}}
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(size=(n, 3)) * 0.3 - o / 4.0
    f32 = lambda a: np.asarray(a, np.float32)
    batch = {"pixels": f32(rng.uniform(size=(n, 3))),
             "rays": Rays(f32(o), f32(d), f32(d / np.linalg.norm(d, axis=-1, keepdims=True)))}
    draws = {"t_rand": f32(rng.uniform(size=(n, 16))), "u": f32(rng.uniform(size=(n, 17))),
             "sp_points": f32(rng.uniform(-1.5, 1.5, (1000, 3)))}
    return cfg, params, opt, batch, draws


@pytest.mark.gpu
def test_two_rank_gloo_step_on_cuda_matches_one_process():
    """Two gloo ranks, both on cuda:0, each half of a 256-ray batch, through
    the fused trunk kernels (3 forward and 3 backward launches per rank and
    step): the ranks' parameters bitwise equal to each other and within
    1e-5 of the one-process step on the whole batch (the backward kernel
    sums its rows in another grouping; measured on the CPU's plain version:
    1.4e-7 relative on the gradients); gradients within 1e-4 per leaf."""
    _need_cuda()
    from plenoctree_tpu_torch.parallel.ranks import run_ranks, train_steps

    cfg, params, opt, batch, draws = _dp_inputs()
    kw = dict(cfg=cfg, params=params, batches=[batch] * 2, draws=[draws] * 2, opt_state=opt,
              device="cuda:0", launches=True)
    one = train_steps(0, 1, **kw)
    two = run_ranks("plenoctree_tpu_torch.parallel.ranks:train_steps", 2, kw, timeout=300)
    for r in two:
        assert (r["fwd_launches"], r["bwd_launches"]) == (6, 6)
        assert r["all_reduce_ms"] is not None and r["all_reduce_ms"] > 0
    for k, p in one["params"][-1].items():
        np.testing.assert_array_equal(two[0]["params"][-1][k], two[1]["params"][-1][k])
        np.testing.assert_allclose(two[0]["params"][-1][k], p, rtol=1e-5, atol=1e-5, err_msg=k)
        for g1, g2 in zip(one["grads"], two[0]["grads"]):
            assert np.abs(g2[k] - g1[k]).max() <= 1e-4 * np.abs(g1[k]).max() + 1e-30, k


@pytest.mark.gpu
@pytest.mark.parametrize("output", ["f32", "u8"])
def test_sharded_tile_frame_on_cuda_is_bitwise(output):
    """TileRenderer(mesh=[cuda:0, cuda:0]) at 200x200 (169 tiles: one padded
    tile): two kernel launches per frame, each on its own stream, and the
    frame bitwise the one-device frame."""
    _need_cuda()
    from plenoctree_tpu_torch.parallel import make_mesh

    tree = build_scene_tree(depth=5, basis_dim=16, sh_noise=0.05, seed=1)
    kw = dict(step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2, output=output)
    single = TileRenderer(tree, device="cuda", **kw)
    sharded = TileRenderer(tree, index=single.index, mesh=make_mesh(devices=["cuda:0"] * 2),
                           **kw)
    _, c2ws, focal = render_synthetic_scene("test", 2, 200, True, 2.0, 6.0)
    for c2w in c2ws:
        a = single.render_persp(c2w, 200, 200, focal)
        sharded.w1cap, sharded.ccap = single.w1cap, single.ccap  # no regrowth re-render
        before = K.launches
        b = sharded.render_persp(c2w, 200, 200, focal)
        assert K.launches - before == 2
        np.testing.assert_array_equal(a, b)
