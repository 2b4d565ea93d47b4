"""The CUDA kernels on the card (marked `gpu`; skips without CUDA).

This file imports no JAX, so it also runs where the JAX stack is absent;
tests/conftest.py imports jax, so run it there without the conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

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
    same renderer on the CPU (plain version): within 1e-4. Tile 32 runs the
    kernel's 1024-thread instantiation."""
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


def _trunk(depth, width, n_rgb, seed, device="cuda"):
    params = init_trunk_params(np.random.default_rng(seed), 63, depth, width, 4, 1, n_rgb, 0.05)
    return trunk_weights(params, 4, device)


def _grad_rel_errs(got, want):
    return [float((a - b).abs().max() / (b.abs().max() + 1e-9)) for a, b in zip(got, want)]


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
    again = F.fused_trunk_bwd(flat, x, gs, gr, meta)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # no atomics


@pytest.mark.gpu
def test_fused_trunk_autograd_on_cuda():
    _need_cuda()
    flat, meta = _trunk(6, 64, 12, seed=3)
    x = torch.randn(1500, 63, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    w = [t.clone().requires_grad_() for t in flat]
    s, r = F.FusedTrunkFn.apply(meta, x, *w)
    (s.square().sum() + r.sum()).backward()
    ref = F.fused_trunk_bwd_reference(flat, x, 2 * s.detach(), torch.ones_like(r), meta)
    assert max(_grad_rel_errs([t.grad for t in w], ref)) <= TRUNK_GRAD_RTOL


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
    for bad in ({"posenc": (0, 10)}, {"sh_dim": 16}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            F.fused_trunk(flat, x, dict(meta, **bad))
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
    versions; tile 32 (1024 rays per block) runs both kernels' second
    instantiation."""
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
    "groups,unroll,smem,rows,n",
    [(1, 1, False, 32768, 256 * 8192), (1, 8, False, 32768, 256 * 8192),
     (8, 1, False, 32768, 256 * 8192), (8, 8, False, 32768, 256 * 8192),
     (1, 8, True, 1024, 256 * 8192), (8, 1, True, 1024, 64 * 8192),
     (1, 8, False, 1 << 20, 1000003)],
)
def test_gather_sum_kernel_matches_reference(groups, unroll, smem, rows, n):
    """Every variant at the probes' sizes (and a ragged stream on the 1M-row
    table) against the plain version and a float64 sum; reruns equal."""
    _need_cuda()
    rng = np.random.default_rng(rows + n + groups)
    table = torch.tensor(rng.normal(size=(rows, 56)), dtype=torch.float32, device="cuda")
    idx = torch.tensor(rng.integers(0, rows, size=n), dtype=torch.int32, device="cuda")
    before = G.launches
    out = G.gather_sum(idx, table, groups, unroll, smem)
    again = G.gather_sum(idx, table, groups, unroll, smem)
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
        G.gather_sum(idx, table, smem_table=True)  # 2048 x 56 x 4 B > 232,448
    with pytest.raises(ValueError):
        G.gather_sum(idx.cpu(), table)


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
