"""Port parity on the CPU: extraction (plenoctree_tpu_torch/octree/
{extract,grid_weight}.py, cli/extract.py) and the port's own N3Tree against
the JAX package, and the conversion chain extract -> optimize --tile_opt ->
evaluate end to end. Small sizes: grids of 16^3-32^3, 16x16-32x32 views."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from jax import random

from plenoctree_tpu import engine as jengine
from plenoctree_tpu.data.synthetic import render_synthetic_scene, scene_sigma_rgb
from plenoctree_tpu.models import construct_nerf as jax_construct_nerf
from plenoctree_tpu.octree import extract as jextract
from plenoctree_tpu.octree.grid_weight import calculate_grid_weights as jax_grid_weights
from plenoctree_tpu.octree.n3tree import N3Tree as JaxN3Tree
from plenoctree_tpu.ops.sh import SH_C0
from plenoctree_tpu.utils import checkpoints as jckpt
from plenoctree_tpu.utils import config as jconfig
from plenoctree_tpu_torch.models.params import init_trunk_params
from plenoctree_tpu_torch.octree import extract as textract
from plenoctree_tpu_torch.octree.grid_weight import calculate_grid_weights
from plenoctree_tpu_torch.octree.n3tree import N3Tree
from plenoctree_tpu_torch.utils import config as tconfig

from tests.test_octree import build_scene_tree

# One intra-op thread per process: the suite runs in several xdist workers
# on a few cores, and PyTorch's default of one OpenMP thread per core in
# every worker oversubscribes the machine so badly that small CPU ops slow
# down by orders of magnitude (this module's conversion-chain test took
# 23 s alone and 1226 s beside five other workers). Every worker imports
# this module while collecting, so the setting holds for the whole run.
torch.set_num_threads(1)


def jax_points_fn(points, viewdirs=None):
    """tests/test_extraction.py's analytic stand-in for a trained NeRF-SH
    of degree 0 (the JAX package's signature)."""
    sigma, rgb = scene_sigma_rgb(np.asarray(points))
    rgbc = np.clip(rgb, 1e-4, 1 - 1e-4)
    return (np.log(rgbc / (1 - rgbc)) / SH_C0).astype(np.float32), sigma[:, None]


def port_points_fn(points):
    """The same analytic field with the port's points_fn signature."""
    return jax_points_fn(points)


class _Views:
    """The loader surface calculate_grid_weights reads."""

    def __init__(self, n_views=4, res=32):
        _, self.camtoworlds, self.focal = render_synthetic_scene("train", n_views, res, True, 2.0, 6.0)
        self.w = self.h = res
        self.size = n_views


def _cfg(pkg, **kw):
    base = dict(
        sh_deg=0, use_viewdirs=False, init_grid_depth=4, chunk=4096, alpha_thresh=0.01,
        masking_mode="sigma", samples_per_cell=4, renderer_step_size=1e-3, center="0 0 0",
        radius="1.2", num_rgb_channels=3,
    )
    base.update(kw)
    return pkg.default_config(**base)


def _assert_same_tree(a, b, atol):
    """Equal topology (child / parent_depth arrays, so equal leaf order) and
    leaf data within atol."""
    n = a.n_internal
    assert n == b.n_internal and a.max_depth == b.max_depth
    np.testing.assert_array_equal(a.child[:n], b.child[:n])
    np.testing.assert_array_equal(a.parent_depth[:n], b.parent_depth[:n])
    np.testing.assert_allclose(a.data[:n], b.data[:n], rtol=0, atol=atol)


def test_grid_weights_match_jax():
    """The march over a 32^3 analytic sigma grid from 4 cameras at 32x32:
    per-voxel max weights within 1e-6 (both packages contract the sample
    depth and position into FMAs, so the same rays visit the same voxels;
    the weights then differ by exp's last bits)."""
    reso = 32
    invradius = np.full(3, 0.5 / 1.2, np.float32)
    offset = np.full(3, 0.5, np.float32)
    arr = (np.arange(reso) + 0.5) / reso
    t = np.stack(np.meshgrid(arr, arr, arr, indexing="ij"), -1).reshape(-1, 3)
    sigma, _ = scene_sigma_rgb((t - offset) / invradius)
    views = _Views()
    want = jax_grid_weights(views, sigma, reso, invradius, offset, chunk=4096)
    got = calculate_grid_weights(views, sigma, reso, invradius, offset, chunk=4096)
    assert got.shape == want.shape == (reso, reso, reso) and got.dtype == np.float32
    assert want.max() > 0.3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("masking_mode", ["sigma", "weight"])
def test_extraction_matches_jax(masking_mode):
    """step1_build + step2_fill with the analytic field written once per
    package: equal topology, leaf data within 1e-5 (the per-leaf means of
    identical samples, which may sum in another order; measured equal)."""
    trees = []
    for pkg, tree_cls, ext, fn in (
        (jconfig, JaxN3Tree, jextract, jax_points_fn),
        (tconfig, N3Tree, textract, port_points_fn),
    ):
        cfg = _cfg(pkg, masking_mode=masking_mode)
        tree = tree_cls(data_dim=4, depth_limit=cfg.init_grid_depth, radius=1.2,
                        center=(0, 0, 0), data_format="SH1", init_reserve=1000)
        ext.step1_build(cfg, tree, fn, _Views())
        ext.step2_fill(cfg, tree, fn)
        tree.relu_sigma_()
        tree.shrink_to_fit()
        trees.append(tree)
    assert trees[1].n_leaves > 1000
    _assert_same_tree(trees[1], trees[0], atol=1e-5)


@pytest.mark.parametrize("chunk_size", [1, 7, 64, 5000])
def test_jitter_chunks_equal_one_sequential_draw(chunk_size):
    """step2_fill's jitter, drawn on threads from advanced copies of the
    PCG64 generator, equals the one sequential pass of the JAX package
    (every chunk's points bit for bit), and leaves the generator where
    that pass leaves it."""
    tree = N3Tree(data_dim=4, depth_limit=2, radius=1.3, center=(0.1, 0, 0))
    rng = np.random.default_rng(1)
    corner, size = rng.random((1000, 3)), rng.random(1000)
    gen, want_gen = np.random.default_rng(20200823), np.random.default_rng(20200823)
    got = list(textract._jitter_chunks(tree, corner, size, 8, chunk_size, gen))
    los = list(range(0, 1000, chunk_size))
    assert [(lo, hi) for lo, hi, _ in got] == [(lo, min(lo + chunk_size, 1000)) for lo in los]
    for lo, hi, points in got:
        u = want_gen.random((hi - lo, 8, 3), dtype=np.float64)
        t = corner[lo:hi, None, :] + u * size[lo:hi, None, None]
        np.testing.assert_array_equal(points, tree.tree2world(t.astype(np.float32)).reshape(-1, 3))
    assert gen.random() == want_gen.random()


def test_autoscale_matches_jax():
    for kw in ({}, {"scale_alpha_thresh": 0.1}):
        want = jextract.auto_scale(_cfg(jconfig, **kw), [0.0] * 3, [2.5] * 3, jax_points_fn)
        got = textract.auto_scale(_cfg(tconfig, **kw), [0.0] * 3, [2.5] * 3, port_points_fn)
        np.testing.assert_allclose(np.array(got), np.array(want), rtol=0, atol=1e-6)
        assert all(r < 1.5 for r in got[1])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tree_npz_loads_in_the_other_package(tmp_path, writer):
    """A tree saved by either package's N3Tree loads in the other with
    equal arrays and attributes (svox layout, data stored half)."""
    tree = build_scene_tree(depth=3)  # the JAX package's class
    reader = N3Tree
    if writer == "port":
        tree, reader = N3Tree.load(_save(tree, tmp_path / "a.npz")), JaxN3Tree
    back = reader.load(_save(tree, tmp_path / "tree.npz"))
    assert type(back).__module__ != type(tree).__module__
    n = tree.n_internal
    for k in ("child", "parent_depth"):
        np.testing.assert_array_equal(getattr(back, k), getattr(tree, k)[:n])
    np.testing.assert_array_equal(back.data, tree.data[:n].astype(np.float16).astype(np.float32))
    for k in ("invradius", "offset"):
        np.testing.assert_array_equal(getattr(back, k), getattr(tree, k))
    for k in ("N", "data_dim", "n_internal", "n_free", "depth_limit", "geom_resize_fact"):
        assert getattr(back, k) == getattr(tree, k), k
    assert repr(back.data_format) == repr(tree.data_format) == "SH1"
    assert back.n_leaves == tree.n_leaves


def _save(tree, path):
    tree.save(str(path), compress=False)
    return str(path)


def test_port_n3tree_builds_like_jax():
    """build_from_points (the port's numpy refine loop; the JAX package's
    native builder where available) and query_points give the same arrays."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    a = JaxN3Tree(data_dim=4, depth_limit=4, radius=1.0, center=(0, 0, 0)).build_from_points(pts)
    b = N3Tree(data_dim=4, depth_limit=4, radius=1.0, center=(0, 0, 0)).build_from_points(pts)
    n = a.n_internal
    assert n == b.n_internal
    np.testing.assert_array_equal(a.child[:n], b.child[:n])
    np.testing.assert_array_equal(a.parent_depth[:n], b.parent_depth[:n])
    q = rng.uniform(-1.2, 1.2, (2000, 3)).astype(np.float32)
    for x, y in zip(a.query_points(q), b.query_points(q)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_viewdirs_and_sg_raise():
    """use_viewdirs extraction is ported (SH projection; its parity is
    tests/test_torch_viewdirs.py): step2_fill of such a model without a
    cross_fn raises, and the CLI refuses a use_viewdirs model without a
    target SH degree; SG trees are ported (tests/test_torch_sg.py):
    step2_fill fills an SG1 tree."""
    tree = N3Tree(data_dim=4, depth_limit=2, data_format="SH1")
    with pytest.raises(ValueError, match="cross_fn"):
        textract.step2_fill(_cfg(tconfig, use_viewdirs=True), tree, port_points_fn)
    sg = N3Tree(data_dim=4, depth_limit=2, data_format="SG1", extra_data=np.ones((1, 4)))
    textract.step2_fill(_cfg(tconfig), sg, port_points_fn)
    assert np.abs(sg.data).max() > 0
    from plenoctree_tpu_torch.cli import extract as cli

    with pytest.raises(ValueError, match="--sh_deg"):
        cli.main(["--train_dir", "/nonexistent", "--dataset", "synthetic", "--use_viewdirs",
                  "--sh_deg", "-1", "--device", "cpu"])


# A small f32 NeRF-SH (degree 1) without view directions, 4 x 32 trunks.
_NERF = dict(net_depth=4, net_width=32, skip_layer=2, sh_deg=1, use_viewdirs=False,
             num_coarse_samples=8, num_fine_samples=8)
# Seeded weights whose grid sigmas all lie at least _MARGIN from the mask
# threshold (the test asserts it, and that the two packages' grid sigmas
# differ by far less): f32 matmuls in XLA and PyTorch sum in other orders,
# so a sigma within rounding of the threshold could be masked by one
# package and not the other. Of seeds 0-19 at bias std 0.3, seed 7 has the
# widest margin (5.4e-4) with about half the grid above the threshold.
_SEED = 7
_MARGIN = 1e-4


def _jax_checkpoint(train_dir):
    rng = np.random.default_rng(_SEED)
    params = {
        name: init_trunk_params(rng, 63, 4, 32, 2, 1, 12, bias_std=0.3)
        for name in ("MLP_0", "MLP_1")
    }
    state = jckpt.create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, params)})
    os.makedirs(train_dir, exist_ok=True)
    with open(os.path.join(train_dir, "checkpoint_5"), "wb") as f:
        f.write(serialization.to_bytes(state.replace(step=jnp.int32(5))))


def test_jax_checkpoint_extracts_alike_in_both_packages(tmp_path):
    """One checkpoint written by the JAX package, restored by each package's
    own loader and extracted by each package's pipeline (f32 trunks, sigma
    masking at init_grid_depth 3, 4 jittered samples per leaf): equal
    topology, leaf data within 1e-4 (f32 trunks summing in another order;
    measured 4.8e-7)."""
    from plenoctree_tpu_torch.models.nerf import get_model_state

    train_dir = str(tmp_path / "ckpt")
    _jax_checkpoint(train_dir)
    kw = dict(_NERF, train_dir=train_dir, init_grid_depth=3, samples_per_cell=4,
              masking_mode="sigma", alpha_thresh=0.01, radius="1.5", chunk=4096)
    jcfg, tcfg = jconfig.default_config(**kw), tconfig.default_config(**kw)
    jmodel, jvars = jax_construct_nerf(random.PRNGKey(0), jcfg)
    jstate = jckpt.restore_checkpoint(train_dir, jckpt.create_train_state(jvars))
    assert int(jstate.step) == 5
    fn = jengine.make_eval_points_fn(jmodel, raw_rgb=True)
    jfn = lambda p, v: fn(jstate.variables, p, v)  # noqa: E731
    tmodel, tstate = get_model_state(tcfg, restore=True)
    assert tstate.step == 5
    tfn = textract.make_points_fn(tmodel, "cpu")

    reso = 2 ** (kw["init_grid_depth"] + 1)
    grid = textract._grid_points(reso, np.full(3, 0.5, np.float32), np.full(3, 0.5 / 1.5, np.float32))
    sig = textract._eval_sigma(tfn, grid, 4096)
    assert np.abs(sig - jextract._eval_sigma(jfn, grid, 4096, False)).max() < 0.1 * _MARGIN
    thresh = -np.log(1.0 - kw["alpha_thresh"]) / (2.0 / reso)
    assert np.abs(sig - thresh).min() > _MARGIN
    assert 0.05 < (sig >= thresh).mean() < 0.95

    trees = []
    for pkg_tree, ext, pfn in ((JaxN3Tree, jextract, jfn), (N3Tree, textract, tfn)):
        tree = pkg_tree(data_dim=13, depth_limit=3, radius=[1.5] * 3, center=[0.0] * 3,
                        data_format="SH4", init_reserve=1000)
        cfg = jcfg if ext is jextract else tcfg
        ext.step1_build(cfg, tree, pfn, None)
        ext.step2_fill(cfg, tree, pfn)
        tree.relu_sigma_()
        tree.shrink_to_fit()
        trees.append(tree)
    _assert_same_tree(trees[1], trees[0], atol=1e-4)


def test_conversion_chain_end_to_end(tmp_path):
    """cli.extract -> cli.optimize --tile_opt -> cli.evaluate on the CPU from
    a port checkpoint of a small NeRF-SH trained for 6 steps by the port's
    train CLI: each stage writes its file, the optimized tree loads, and
    its eval PSNR is finite."""
    from plenoctree_tpu_torch.cli import evaluate as eval_cli
    from plenoctree_tpu_torch.cli import extract as extract_cli
    from plenoctree_tpu_torch.cli import optimize as optimize_cli
    from plenoctree_tpu_torch.cli import train as train_cli

    d = str(tmp_path)
    model = ["--config", "nerf_sh/config/blender", "--dataset", "synthetic", "--device", "cpu",
             "--net_depth", "3", "--net_width", "32", "--sh_deg", "1",
             "--num_coarse_samples", "8", "--num_fine_samples", "8",
             "--synthetic_resolution", "16"]
    train_cli.main(model + [
        "--train_dir", d, "--batch_size", "64", "--image_batching", "--max_steps", "6",
        "--print_every", "3", "--save_every", "6", "--render_every", "0",
        "--sparsity_npoints", "100", "--chunk", "512", "--lr_init", "5e-3",
    ])
    tree_path, opt_path = os.path.join(d, "tree.npz"), os.path.join(d, "tree_opt.npz")
    tree = extract_cli.main(model + [
        "--train_dir", d, "--output", tree_path, "--init_grid_depth", "4",
        "--samples_per_cell", "2", "--masking_mode", "sigma", "--autoscale",
        "--scale_alpha_thresh", "0.1", "--radius", "1.4", "--fast_eval",
    ])
    with open(tree_path + ".results.json") as f:
        res = json.load(f)
    assert res["n_leaves"] == tree.n_leaves > 0 and np.isfinite(res["psnr"])
    best, best_psnr = optimize_cli.main(model + [
        "--input", tree_path, "--output", opt_path, "--tile_opt", "--num_epochs", "2",
        "--val_interval", "1", "--lr", "1e3", "--tile_grid_c", "16",
        "--renderer_step_size", "1e-5", "--continue_on_decrease",
    ])
    assert best is not None and os.path.isfile(opt_path)
    assert best_psnr > res["psnr"]
    opt_tree = N3Tree.load(opt_path)
    assert opt_tree.n_leaves == tree.n_leaves
    psnr, ssim, _ = eval_cli.main(model + ["--input", opt_path, "--fast_eval"])
    assert np.isfinite(psnr) and np.isfinite(ssim)
