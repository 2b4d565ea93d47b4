"""Port parity on the CPU: the differentiable tile optimizer
(plenoctree_tpu_torch/octree/tile_opt.py and the plain tile backward in
kernels/tile_composite.py) against the JAX package's tile_opt, whose Pallas
backward kernel runs interpreted here.

Small sizes, as tests/test_tile_opt.py: a depth-3 tree, grid_c 8, 31x31
frames (odd, as in tests/test_torch_tile_render.py: at an even size the
principal ray passes through the tree centre, where the f32 slab tests are
ill-conditioned and the two packages' pixels there may differ by ~1e-4).
Inputs come from numpy seeds and go through both packages. The CUDA
backward kernel runs only on a GPU: tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plenoctree_tpu.octree.renderer import VolumeRenderer
from plenoctree_tpu.octree.tile_opt import TileOptimizer as JaxTileOptimizer
from plenoctree_tpu.ops.metrics import compute_psnr as jax_psnr
from plenoctree_tpu_torch.data.synthetic import build_scene_tree as build_shn_tree
from plenoctree_tpu_torch.kernels import tile_composite as K
from plenoctree_tpu_torch.octree.tile_opt import TileOptimizer, optimize_tree_tiles
from plenoctree_tpu_torch.utils.config import default_config

from tests.test_octree import build_scene_tree, render_synthetic_scene
from tests.test_tile_opt import orbit_pose

# One intra-op thread per process: the suite runs in several xdist workers
# on a few cores, and PyTorch's default of one OpenMP thread per core in
# every worker oversubscribes the machine so badly that small CPU ops slow
# down by orders of magnitude (this module's finite-difference test took
# 0.7 s alone and 192 s beside five other workers). Every worker imports
# this module while collecting, so the setting holds for the whole run.
torch.set_num_threads(1)

H = W = 31
FX = 1.1 * W
KW = dict(step_size=1e-3, grid_c=8, rcap=128)
# The plain backward against the interpreted JAX backward kernel on the same
# inputs: the same hit tests and precedence, sums in another order (matmul
# vs matmul, other blockings) and exp/tanh from other libraries. Measured
# <= 3e-7 of the largest |gradient| per field group; held at 1e-5.
BWD_RTOL = 1e-5


@pytest.fixture(scope="module")
def trees():
    return {
        "sh1": build_scene_tree(depth=3),
        "sh16": build_shn_tree(depth=3, basis_dim=16, sh_noise=0.1, seed=0),
    }


@pytest.fixture(scope="module")
def pairs(trees):
    """(jax, port) optimizers per tree, and a perturbed ground truth."""
    out = {}
    for name, tree in trees.items():
        jo = JaxTileOptimizer(tree, **KW)
        po = TileOptimizer(tree, **KW, device="cpu")
        img0, _, _, _ = jo.render(jo.initial_leaf_dataT(), orbit_pose(), H, W, FX)
        rng = np.random.default_rng(3)
        gt = np.clip(img0 + 0.15 * rng.standard_normal(img0.shape), 0, 1).astype(np.float32)
        out[name] = (jo, po, gt)
    return out


def _p2(jo, pose):
    """The JAX optimizer's tile inputs (exact mode, keep_all index)."""
    r = jo.r
    r.w1cap = r.w1cap or int(min(r.grid_c, np.ceil(np.sqrt(3) * r.tile / FX * r.grid_c) + 3))
    idx = r.index
    fn = r.make_tile_inputs_fn(H, W, FX, r.rcap, r.w1cap, r.ccap)
    return fn(jnp.asarray(pose), idx["csr"], idx["base"], r.extra_data, idx["blk_bbox"])[0]


def _groups(gsoa, sigma_row):
    return {
        "geometry": gsoa[:, :6],
        "colour": gsoa[:, 6:sigma_row],
        "sigma": gsoa[:, sigma_row : sigma_row + 1],
        "pad": gsoa[:, sigma_row + 1 :],
    }


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", ["sh1", "sh16"])
def test_bwd_reference_matches_jax_kernel(pairs, name):
    """composite_tiles_bwd_reference vs the JAX _tile_bwd_kernel on the same
    p2_args, soa, forward output and cotangent: per field group within
    BWD_RTOL of the group's largest |gradient|; geometry and pad rows 0."""
    jo, po, _ = pairs[name]
    p2 = _p2(jo, orbit_pose(0.7))
    soa = jnp.asarray(jo.static_soa)
    T = p2[0].shape[0]
    out = jo.r._get_p2(T, jo.r.ccap)(*p2, soa)
    g = jnp.asarray(np.random.default_rng(5).normal(size=out.shape).astype(np.float32))
    want = np.asarray(jo._get_p2_bwd(T, jo.r.ccap)(p2, soa, out, g, jnp.zeros_like(soa)))
    t = lambda a: torch.from_numpy(np.array(a))
    before = K.bwd_launches
    got = K.composite_tiles_bwd(*map(t, p2), t(soa), t(out), t(g), **po._kw).numpy()
    assert K.bwd_launches == before  # CPU tensors: the plain version, no launch
    sr = int(po.r.index["sigma_row"])
    gw, gg = _groups(want, sr), _groups(got, sr)
    assert not gg["geometry"].any() and not gg["pad"].any()
    for k in ("colour", "sigma"):
        assert np.abs(gw[k]).max() > 0, k
        assert _rel(gg[k], gw[k]) <= BWD_RTOL, (k, _rel(gg[k], gw[k]))


@pytest.mark.parametrize("slab", ["fma", "backward"])
def test_bwd_reference_matches_autograd(pairs, monkeypatch, slab):
    """The plain backward against torch.autograd.grad through the plain
    forward (composite_tiles_reference in exact mode), an oracle that shares
    no code with it. Autograd passes gradient through clamp(min=0) at
    sigma == 0, where the backward takes the ReLU's 0; those rows are zeroed
    before comparing.
    "fma": the backward's slab test patched to the forward's FMA form, so
    both see the same hits: within 1e-6 of the largest |gradient| per group
    (measured 1.4e-7). "backward": the slab test as the JAX backward writes
    it, `(box - o) * invd`; a grazing hit may then count in one pass and not
    the other (measured 9.3e-4 on the sigma row, 3.4e-4 on the colours),
    held at 3e-3."""
    if slab == "fma":
        monkeypatch.setattr(K, "_slab_bwd", lambda box, o, iv: K._fma(box, iv, -(o * iv)))
    _, po, _ = pairs["sh16"]
    rng = np.random.default_rng(9)
    r = po.r
    r.w1cap = r.w1cap or int(min(r.grid_c, np.ceil(np.sqrt(3) * r.tile / FX * r.grid_c) + 3))
    fn = r.make_tile_inputs_fn(H, W, FX, r.rcap, r.w1cap, r.ccap)
    idx = r.index
    p2 = fn(orbit_pose(1.9), idx["csr"], idx["base"], r.extra_data, idx["blk_bbox"])[0]
    soa = po.static_soa.clone().requires_grad_(True)
    out = K.composite_tiles_reference(*p2, soa, **po._kw, stop_thresh=0.0, od_cap=1e30)
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    (want,) = torch.autograd.grad((out * g).sum(), soa)
    sr = int(idx["sigma_row"])
    want[:, sr] *= po.static_soa[:, sr] > 0
    got = K.composite_tiles_bwd_reference(*p2, po.static_soa, out.detach(), g, **po._kw)
    gw, gg = _groups(want.numpy(), sr), _groups(got.numpy(), sr)
    tol = 1e-6 if slab == "fma" else 3e-3
    for k in ("colour", "sigma"):
        assert _rel(gg[k], gw[k]) <= tol, (k, _rel(gg[k], gw[k]))


@pytest.mark.parametrize("name", ["sh1", "sh16"])
def test_loss_and_grad_matches_jax(pairs, name):
    """TileOptimizer.loss_and_grad vs JAX's on the same leaf data, pose and
    target: loss within 1e-6; leaf gradients per field group (colour
    columns, sigma row) within 1e-5 of the group's largest |gradient| (the
    backward's summation order, then the segment-sum's)."""
    jo, po, gt = pairs[name]
    leaf_j = jo.initial_leaf_dataT()
    leaf_p = po.initial_leaf_dataT()
    np.testing.assert_array_equal(leaf_p.numpy(), np.asarray(leaf_j))
    (lj, (img_j, *caps_j)), gj = jo.loss_and_grad(leaf_j, orbit_pose(), gt, H, W, FX)
    (lp, (img_p, *caps_p)), gp = po.loss_and_grad(leaf_p, orbit_pose(), gt, H, W, FX)
    assert abs(float(lp) - float(lj)) <= 1e-6
    assert [int(c) for c in caps_p] == [int(c) for c in caps_j]
    np.testing.assert_allclose(img_p.numpy(), np.asarray(img_j), rtol=0, atol=1e-5)
    gj, gp = np.asarray(gj), gp.numpy()
    assert gp.shape == gj.shape == (po.data_dim, po.n_kept)
    for rows in (slice(0, -1), slice(-1, None)):
        assert np.abs(gj[rows]).max() > 0
        assert _rel(gp[rows], gj[rows]) <= 1e-5, (rows, _rel(gp[rows], gj[rows]))


def test_grad_matches_finite_difference(pairs):
    """As tests/test_tile_opt.py: the largest-gradient coordinates and three
    random ones from the top 200, central differences at a small relative
    step, within 5% or the f32 noise floor."""
    _, po, gt = pairs["sh1"]
    leaf = po.initial_leaf_dataT()
    (_, _), grad = po.loss_and_grad(leaf, orbit_pose(), gt, H, W, FX)
    grad = grad.numpy()
    flat = np.argsort(np.abs(grad).ravel())[::-1]
    rng = np.random.default_rng(0)
    picks = list(flat[:3]) + list(rng.choice(flat[3:200], 3, replace=False))
    leaf_np = leaf.numpy()
    for pidx in picks:
        r, c = np.unravel_index(pidx, grad.shape)
        eps = max(1e-4 * abs(leaf_np[r, c]), 1e-4)
        losses = []
        for sgn in (1, -1):
            lp = leaf_np.copy()
            lp[r, c] += sgn * eps
            (loss, _), _ = po.loss_and_grad(torch.from_numpy(lp), orbit_pose(), gt, H, W, FX)
            losses.append(float(loss))
        fd = (losses[0] - losses[1]) / (2 * eps)
        an = grad[r, c]
        noise = 4 * 1.2e-7 * max(losses) / (2 * eps)
        denom = max(abs(fd), abs(an), 1e-7)
        assert abs(fd - an) < max(0.05 * denom, noise), (r, c, fd, an)


def test_directional_derivative(pairs):
    """The derivative along the normalised gradient matches |grad| within 2%
    (the whole gradient's signal, far above the f32 noise floor)."""
    _, po, gt = pairs["sh16"]
    leaf = po.initial_leaf_dataT()
    (_, _), grad = po.loss_and_grad(leaf, orbit_pose(), gt, H, W, FX)
    g = grad.numpy().astype(np.float64)
    d = g / np.linalg.norm(g)
    an = float(np.sum(g * d))
    for eps in (1e-3, 3e-4):
        lo = []
        for sgn in (1, -1):
            pert = torch.from_numpy((leaf.numpy() + sgn * eps * d).astype(np.float32))
            (loss, _), _ = po.loss_and_grad(pert, orbit_pose(), gt, H, W, FX)
            lo.append(float(loss))
        fd = (lo[0] - lo[1]) / (2 * eps)
        assert abs(fd - an) / max(abs(fd), abs(an)) < 0.02, (eps, fd, an)


def test_optimize_tree_tiles_improves_psnr():
    """The scenario of tests/test_tile_opt.py: wash the colours of a depth-3
    tree, fine-tune on analytic renders (4 train views, 1 val view at 32x32),
    and the best val PSNR must beat the washed tree's (exact march, JAX) by
    more than 2 dB."""
    tree = build_scene_tree(depth=3)
    tree.data[: tree.n_internal, ..., :3] = 0.0
    images, c2ws, focal = render_synthetic_scene("train", 5, 32, True, 2.0, 6.0)
    im0 = np.clip(VolumeRenderer(tree, step_size=1e-3).render_persp(c2ws[4], 32, 32, focal), 0, 1)
    psnr0 = float(jax_psnr(np.mean((im0 - images[4]) ** 2)))
    best_tree, best_psnr = optimize_tree_tiles(
        tree, c2ws[:4], images[:4], c2ws[4:], images[4:], focal,
        default_config(renderer_step_size=1e-3), num_epochs=4, lr=3e4, use_sgd=True,
        val_interval=1, continue_on_decrease=True, grid_c=8, device="cpu",
    )
    assert best_tree is not None
    assert best_psnr > psnr0 + 2.0, (psnr0, best_psnr)
    assert not np.array_equal(best_tree.data, tree.data)


@pytest.mark.parametrize("use_sgd,momentum", [(True, 0.9), (False, 0.0)])
def test_optimizer_updates_match_optax(pairs, use_sgd, momentum):
    """One epoch over two views with SGD + momentum or Adam equals optax's
    sgd / adam(lr, eps=1e-8) applied to the same gradients (the port's
    own), to f32 rounding."""
    import optax

    _, po, gt = pairs["sh1"]
    tree = po.r.tree
    poses = [orbit_pose(0.5), orbit_pose(1.1)]
    imgs = [gt, gt[::-1].copy()]
    lr = 1e3 if use_sgd else 1e-2
    seen = []
    loss_and_grad = TileOptimizer.loss_and_grad

    def spy(self, leaf, *args):
        res = loss_and_grad(self, leaf, *args)
        seen.append((leaf.clone(), res[1].clone()))
        return res

    mp = pytest.MonkeyPatch()
    mp.setattr(TileOptimizer, "loss_and_grad", spy)
    try:
        best, _ = optimize_tree_tiles(
            tree, poses, imgs, poses[:1], imgs[:1], FX, default_config(renderer_step_size=1e-3),
            num_epochs=1, lr=lr, use_sgd=use_sgd, sgd_momentum=momentum, val_interval=1,
            continue_on_decrease=True, grid_c=8, device="cpu",
        )
    finally:
        mp.undo()
    tx = optax.sgd(lr, momentum=momentum or None) if use_sgd else optax.adam(lr, eps=1e-8)
    p = jnp.asarray(seen[0][0].numpy())
    s = tx.init(p)
    for k, (leaf, grad) in enumerate(seen):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(p), rtol=1e-6, atol=1e-6)
        u, s = tx.update(jnp.asarray(grad.numpy()), s, p)
        p = optax.apply_updates(p, u)
    assert len(seen) == 2


def test_write_back_round_trip(pairs):
    _, po, _ = pairs["sh16"]
    t2 = po.r.tree.clone()
    perturbed = po.initial_leaf_dataT() + 1.0
    po.write_back(t2, perturbed)
    again = TileOptimizer(t2, **KW, device="cpu", index=po.r.index)
    np.testing.assert_allclose(again.initial_leaf_dataT().numpy(), perturbed.numpy(), rtol=1e-6)


def test_cli_unported_paths_and_missing_gpu_raise(tmp_path, trees):
    """The LLFF loader is not ported (an LLFF config goes to the march
    optimizer: tests/test_torch_march_opt.py), and both optimizers raise on
    --device cuda without a GPU."""
    from plenoctree_tpu_torch.cli import optimize as cli

    path = str(tmp_path / "tree.npz")
    trees["sh1"].save(path)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["--input", path, "--dataset", "llff", "--data_dir", str(tmp_path), "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    base = ["--input", path, "--dataset", "synthetic", "--synthetic_resolution", "16"]
    for extra in (["--tile_opt"], []):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(base + extra + ["--num_epochs", "1"])
