"""Port parity on the CPU: the exact march (plenoctree_tpu_torch/octree/
renderer.py and march.py) against the JAX package's renderer and march.

Small trees (depth 4 SH1 / SH16 / RGBA / SG4, a depth-2 N = 3 tree), odd
frame sizes (at an even size the principal ray passes through the tree
centre, where 8 cells meet and the f32 slab tests are ill-conditioned).
Every tree is saved once and loaded by each package's own N3Tree; rays and
points come from numpy seeds and go through both packages.

Tolerances: the tables, the accel grid, K and the located cells are equal.
Rendered colours agree to RENDER_ATOL = 2e-5: the marches take the same
cells in the same order (the port mirrors XLA's fused multiply-adds in
the ray position and the descent), and the colours differ by the order of
f32 sums (the SH dot, the cumulative product) and by one-ulp differences
of `1/|d|` in the ray setup; measured <= 3.0e-7 on these frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plenoctree_tpu.data import rays as jax_rays
from plenoctree_tpu.data.synthetic import render_synthetic_scene as jax_scene
from plenoctree_tpu.octree import N3Tree as JaxN3Tree
from plenoctree_tpu.octree import march as JM
from plenoctree_tpu.octree import renderer as JR
from plenoctree_tpu_torch.data import rays as port_rays
from plenoctree_tpu_torch.data.synthetic import build_scene_tree as build_shn_tree
from plenoctree_tpu_torch.data.synthetic import render_synthetic_scene, scene_sigma_rgb
from plenoctree_tpu_torch.octree import N3Tree
from plenoctree_tpu_torch.octree import march as PM
from plenoctree_tpu_torch.octree import renderer as PR

from tests.test_octree import TestGenericBranchFactor, build_scene_tree

torch.set_num_threads(1)  # see tests/test_torch_tile_opt.py

RENDER_ATOL = 2e-5
RES = 25


def _refined(data_format, data_dim, depth=4, extra_data=None):
    """The synthetic scene refined to `depth` in a JAX N3Tree, leaves at
    full depth filled by `fill(centres_world)`."""
    tree = JaxN3Tree(data_dim=data_dim, depth_limit=depth, radius=1.2, center=(0, 0, 0),
                     data_format=data_format, init_reserve=1000, extra_data=extra_data)
    reso = 2 ** (depth + 1)
    arr = (np.arange(reso) + 0.5) / reso
    grid_w = tree.tree2world(np.stack(np.meshgrid(arr, arr, arr, indexing="ij"), -1).reshape(-1, 3))
    occupied = grid_w[scene_sigma_rgb(grid_w)[0] > 0.05]
    for _ in range(depth):
        tree.refine_points(occupied)
    return tree


def _rgba_tree():
    tree = _refined("RGBA", 4)
    leaf = np.nonzero(tree.depths == tree.max_depth)[0]
    sigma, rgb = scene_sigma_rgb(tree.tree2world(tree.leaf_centers()[leaf]))
    tree.set_leaf_data(leaf, np.concatenate([rgb, sigma[:, None]], -1).astype(np.float32))
    return tree


def _sg_tree():
    rng = np.random.default_rng(7)
    mu = rng.normal(size=(4, 3))
    mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
    extra = np.concatenate([rng.uniform(0.5, 3.0, (4, 1)), mu], -1).astype(np.float32)
    tree = _refined("SG4", 13, extra_data=extra)
    leaf = np.nonzero(tree.depths == tree.max_depth)[0]
    sigma, _ = scene_sigma_rgb(tree.tree2world(tree.leaf_centers()[leaf]))
    coeff = rng.normal(scale=0.5, size=(leaf.size, 12))
    tree.set_leaf_data(leaf, np.concatenate([coeff, sigma[:, None]], -1).astype(np.float32))
    return tree


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """name -> (JAX N3Tree, port N3Tree), the same npz loaded by each."""
    made = {
        "sh1": build_scene_tree(depth=4),
        "sh16": build_shn_tree(depth=4, basis_dim=16, sh_noise=0.1, seed=0),
        "rgba": _rgba_tree(),
        "sg4": _sg_tree(),
        "n3": TestGenericBranchFactor()._tiny_tree(3),
    }
    out = {}
    for name, tree in made.items():
        path = str(tmp_path_factory.mktemp("trees") / f"{name}.npz")
        tree.save(path, compress=False)
        out[name] = (JaxN3Tree.load(path), N3Tree.load(path))
    return out


def _pose():
    _, c2ws, focal = jax_scene("test", 1, RES, True, 2.0, 6.0)
    return c2ws[0], focal


@pytest.mark.parametrize("name", ["sh1", "n3"])
@pytest.mark.parametrize("budget", [None, "tiny"])
def test_tree_arrays_and_accel_grid_equal(trees, name, budget):
    jt, pt = trees[name]
    # "tiny" allows only a grid two levels below full depth: internal
    # pointer words and a residual descent.
    bb = None if budget is None else 4 * jt.N ** (3 * (jt.max_depth - 1)) + 8
    ja = JR.tree_arrays(jt, bytes_budget=bb)
    pa = PR.tree_arrays(pt, bytes_budget=bb, device="cpu")
    if budget is not None:
        assert ja["accel_level"] < jt.max_depth + 1 and (np.asarray(ja["accel"]) < 0).any()
    for k in ("accel_reso", "accel_level", "N", "depth_limit"):
        assert ja[k] == pa[k], k
    for k in ("child", "data", "sigma", "accel", "offset", "invradius"):
        np.testing.assert_array_equal(np.asarray(ja[k]), pa[k].numpy(), err_msg=k)


def test_estimate_contrib_slots_equal(trees):
    for name, (jt, pt) in trees.items():
        for thr in (0.0, 1e-2, 5.0):
            assert JM.estimate_contrib_slots(jt, thr) == PM.estimate_contrib_slots(pt, thr), (name, thr)


@pytest.mark.parametrize("name", ["sh16", "n3"])
@pytest.mark.parametrize("mode", ["grid", "budget", "descent"])
def test_locate_same_cells(trees, name, mode):
    """_locate on random points; JAX's under jit, as in its march."""
    jt, pt = trees[name]
    bb = 4 * jt.N ** (3 * (jt.max_depth - 1)) + 8 if mode == "budget" else None
    ja = JR.tree_arrays(jt, accel=mode != "descent", bytes_budget=bb)
    pa = PR.tree_arrays(pt, accel=mode != "descent", bytes_budget=bb, device="cpu")
    jtab, jmeta = JR.split_arrays(ja)
    ptab, pmeta = PR.split_arrays(pa)
    pos = np.random.default_rng(3).uniform(0, 1 - 1e-7, (4096, 3)).astype(np.float32)
    jc, jco, js = jax.jit(lambda tb, p: JR._locate(tb, jmeta, p))(jtab, jnp.asarray(pos))
    pc, pco, ps = PR._locate(ptab, pmeta, torch.from_numpy(pos))
    np.testing.assert_array_equal(np.asarray(jc), pc.numpy())
    np.testing.assert_array_equal(np.asarray(js), ps.numpy())
    np.testing.assert_array_equal(np.asarray(jco), pco.numpy())


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = np.tile([[0.0, 0.0, 3.2]], (n, 1)).astype(np.float32)
    d = rng.normal(scale=0.15, size=(n, 3)).astype(np.float32)
    d[:, 2] = -1.0
    return o, d


@pytest.mark.parametrize("name", ["sh1", "sh16", "rgba", "sg4"])
def test_render_rays_matches_jax(trees, name):
    jt, pt = trees[name]
    o, d = _rays(64, 4)
    fmt, bd = pt.data_format.format, pt.data_format.basis_dim
    jopts = JR.RenderOptions(step_size=1e-3, max_segments=96)
    popts = PR.RenderOptions(step_size=1e-3, max_segments=96)
    want = np.asarray(JR.render_rays(JR.tree_arrays(jt), jnp.asarray(o), jnp.asarray(d), fmt, bd,
                                     jt.max_depth, jopts))
    got = PR.render_rays(PR.tree_arrays(pt, device="cpu"), torch.from_numpy(o), torch.from_numpy(d),
                         fmt, bd, pt.max_depth, popts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_ATOL)


def test_render_rays_is_differentiable(trees):
    """Autograd reaches only the leaves along the rays (the JAX test's
    sparsity check), and matches JAX's gradient."""
    jt, pt = trees["sh1"]
    o, d = _rays(4, 5)
    ja = JR.tree_arrays(jt)
    jdata = ja.pop("data")
    opts = dict(step_size=1e-3, max_segments=64)
    gj = jax.grad(lambda x: jnp.sum(JR.render_rays(dict(ja, data=x), jnp.asarray(o), jnp.asarray(d),
                                                   "SH", 1, 4, JR.RenderOptions(**opts))))(jdata)
    pa = PR.tree_arrays(pt, device="cpu")
    data = pa["data"].clone().requires_grad_(True)
    out = PR.render_rays(dict(pa, data=data), torch.from_numpy(o), torch.from_numpy(d), "SH", 1, 4,
                         PR.RenderOptions(**opts))
    (g,) = torch.autograd.grad(out.sum(), data)
    touched = int((g.abs().sum(-1) > 0).sum())
    assert 0 < touched < 200
    gj = np.asarray(gj)
    assert np.abs(g.numpy() - gj).max() <= 1e-5 * np.abs(gj).max()


@pytest.mark.parametrize("name", ["sh1", "sh16", "rgba", "sg4"])
@pytest.mark.parametrize("fast", [False, True])
def test_render_persp_matches_jax(trees, name, fast):
    jt, pt = trees[name]
    c2w, focal = _pose()
    want = JR.VolumeRenderer(jt, step_size=1e-3).render_persp(c2w, RES, RES, focal, fast=fast)
    got = PR.VolumeRenderer(pt, step_size=1e-3, device="cpu").render_persp(c2w, RES, RES, focal,
                                                                        fast=fast)
    assert got.shape == want.shape == (RES, RES, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_ATOL)


def test_budgeted_grid_and_small_chunks_match_jax(trees):
    """A byte budget that forces the residual descent, step 1e-5, and
    chunks of 128 rays with a bucket floor of 32 (compaction and edge
    padding on every chunk)."""
    jt, pt = trees["sh16"]
    c2w, focal = _pose()
    bb = 4 * 2 ** (3 * 3) + 8
    jr = JR.VolumeRenderer(jt, step_size=1e-5, accel_bytes_budget=bb, segs_per_pass=8)
    pr = PR.VolumeRenderer(pt, step_size=1e-5, accel_bytes_budget=bb, segs_per_pass=8,
                           device="cpu")
    jr._get_deferred(False).min_bucket = 32
    pr._get_deferred(False).min_bucket = 32
    want = jr.render_persp(c2w, RES, RES, focal, chunk=128)
    got = pr.render_persp(c2w, RES, RES, focal, chunk=128)
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_ATOL)


def test_forced_regrowth_matches_jax(trees):
    """From K = 8 both packages overflow, double K the same number of
    times, and render the same image."""
    jt, pt = trees["sh16"]
    c2w, focal = _pose()
    jr = JR.VolumeRenderer(jt, step_size=1e-3, contrib_slots=8)
    pr = PR.VolumeRenderer(pt, step_size=1e-3, contrib_slots=8, device="cpu")
    want = jr.render_persp(c2w, RES, RES, focal)
    got = pr.render_persp(c2w, RES, RES, focal)
    assert pr._get_deferred(False).K == jr._get_deferred(False).K > 8
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_ATOL)


def test_regrowth_stops_at_k_max_with_a_warning(trees):
    _, pt = trees["sh16"]
    c2w, focal = _pose()
    r = PR.VolumeRenderer(pt, step_size=1e-3, contrib_slots=8, device="cpu")
    monkey = pytest.MonkeyPatch()
    monkey.setattr(PM, "K_MAX", 8)
    try:
        with pytest.warns(UserWarning, match="clipped at K=8"):
            r.render_persp(c2w, 9, 9, focal * 9 / RES)
    finally:
        monkey.undo()


def test_empty_tree_renders_background():
    tree = N3Tree(data_dim=4, depth_limit=2, radius=1.0, center=(0, 0, 0), data_format="SH1")
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 3.0
    im = PR.VolumeRenderer(tree, step_size=1e-3, device="cpu").render_persp(c2w, 9, 9, 9.0)
    np.testing.assert_allclose(im, 1.0, atol=1e-6)


def test_ndc_matches_jax(trees):
    rng = np.random.default_rng(8)
    o = rng.normal(scale=0.1, size=(50, 3)).astype(np.float32)
    d = rng.normal(scale=0.2, size=(50, 3)).astype(np.float32)
    d[:, 2] = -1.0
    for a, b in zip(jax_rays.convert_to_ndc(o, d, 30.0, 21, 23), port_rays.convert_to_ndc(o, d, 30.0, 21, 23)):
        np.testing.assert_array_equal(a, b)
    jt, pt = trees["sh1"]
    c2w = np.eye(4, dtype=np.float32)
    ndc = PR.make_ndc_config(21, 23, 20.0)
    assert ndc == JR.make_ndc_config(21, 23, 20.0)
    want = JR.VolumeRenderer(jt, step_size=1e-3, ndc=ndc).render_persp(c2w, 23, 21, 20.0)
    got = PR.VolumeRenderer(pt, step_size=1e-3, ndc=ndc, device="cpu").render_persp(c2w, 23, 21, 20.0)
    assert want.min() < 0.9  # the rays cross geometry
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_ATOL)


def test_synthetic_views_are_memoized_read_only():
    a = render_synthetic_scene("val", 2, 9, True, 2.0, 6.0)
    b = render_synthetic_scene("val", 2, 9, True, 2, 6)
    assert a[0] is b[0] and not a[0].flags.writeable and not a[1].flags.writeable
    want = jax_scene("val", 2, 9, True, 2.0, 6.0)
    np.testing.assert_array_equal(a[0], want[0])
    np.testing.assert_array_equal(a[1], want[1])


def test_missing_gpu_raises(trees):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        PR.VolumeRenderer(trees["sh1"][1])
