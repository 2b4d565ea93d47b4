"""Port parity on the CPU: ops, host data, config (plenoctree_tpu_torch vs
the JAX package, same numpy inputs)."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from plenoctree_tpu.data import rays as jax_rays
from plenoctree_tpu.data import synthetic as jax_synthetic
from plenoctree_tpu.data.poses import pose_spherical as jax_pose_spherical
from plenoctree_tpu.ops import metrics as jax_metrics
from plenoctree_tpu.ops import sh as jax_sh
from plenoctree_tpu.utils import config as jax_config
from plenoctree_tpu_torch.data import rays, synthetic
from plenoctree_tpu_torch.data.datasets import get_dataset
from plenoctree_tpu_torch.data.poses import pose_spherical
from plenoctree_tpu_torch.ops import metrics, sh
from plenoctree_tpu_torch.utils import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unit_dirs(n, seed):
    d = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_basis_matches_jax(deg):
    # Same polynomial, same evaluation order: equal to f32 rounding (1e-6).
    dirs = _unit_dirs(512, deg)
    ref = np.asarray(jax_sh.sh_basis(deg, jnp.asarray(dirs)))
    out = sh.sh_basis(deg, torch.from_numpy(dirs)).numpy()
    assert out.shape == ref.shape == (512, (deg + 1) ** 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("deg", [0, 3])
def test_eval_sh_matches_jax(deg):
    # A (deg+1)^2-term f32 contraction in either order: within 1e-5.
    rng = np.random.default_rng(7)
    dirs = _unit_dirs(64, 9)
    coef = rng.standard_normal((64, 3, (deg + 1) ** 2)).astype(np.float32)
    ref = np.asarray(jax_sh.eval_sh(deg, jnp.asarray(coef), jnp.asarray(dirs)))
    out = sh.eval_sh(deg, torch.from_numpy(coef), torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_sh_rejects_bad_degree():
    with pytest.raises(ValueError):
        sh.sh_basis(5, torch.zeros(1, 3))
    with pytest.raises(ValueError):
        sh.eval_sh(1, torch.zeros(1, 3, 9), torch.zeros(1, 3))


@pytest.mark.parametrize("mse", [1e-1, 3.3e-3, 2.5e-4, 7e-7])
def test_psnr_matches_jax(mse):
    # Same f32 ops (log, scale, divide by ln 10): within 1e-6.
    ref = float(jax_metrics.compute_psnr(mse))
    out = float(metrics.compute_psnr(mse))
    assert abs(out - ref) <= 1e-6


@pytest.mark.parametrize("shape,noise", [((40, 48, 3), 0.05), ((2, 32, 32, 3), 0.3)])
def test_ssim_matches_jax(shape, noise):
    # Separable 11-tap "valid" Gaussian filter, tf.image constants; the
    # convolutions sum in another order than XLA's: within 1e-5.
    rng = np.random.default_rng(3)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)
    ref = np.asarray(jax_metrics.compute_ssim(jnp.asarray(a), jnp.asarray(b), max_val=1.0))
    out = metrics.compute_ssim(torch.from_numpy(a), torch.from_numpy(b), max_val=1.0).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    same = float(metrics.compute_ssim(torch.from_numpy(a), torch.from_numpy(a), 1.0).mean())
    assert abs(same - 1.0) < 1e-5


def test_generate_rays_and_poses_match_jax():
    c2ws = np.stack([pose_spherical(th, -30.0, 4.0) for th in (0.0, 77.0)])
    ref_c2ws = np.stack([jax_pose_spherical(th, -30.0, 4.0) for th in (0.0, 77.0)])
    np.testing.assert_array_equal(c2ws, ref_c2ws)
    out = rays.generate_rays(20, 12, 25.0, c2ws)
    ref = jax_rays.generate_rays(20, 12, 25.0, c2ws)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_synthetic_scene_matches_jax():
    out = synthetic.render_synthetic_scene("test", 2, 24, True, 2.0, 6.0)
    ref = jax_synthetic.render_synthetic_scene("test", 2, 24, True, 2.0, 6.0)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_build_scene_tree_matches_test_recipe():
    from tests.test_octree import build_scene_tree

    ref = build_scene_tree(depth=3)
    out = synthetic.build_scene_tree(depth=3, basis_dim=1)
    np.testing.assert_array_equal(out.child, ref.child)
    np.testing.assert_array_equal(out.data, ref.data)
    sh16 = synthetic.build_scene_tree(depth=3, basis_dim=16, sh_noise=0.05, seed=1)
    assert sh16.data_dim == 49 and repr(sh16.data_format) == "SH16"
    leaf = sh16.get_leaf_data()
    dc = leaf[:, [0, 16, 32]]
    np.testing.assert_array_equal(dc, ref.get_leaf_data()[:, :3])
    hi = leaf[:, 1:16][leaf[:, -1] > 0]
    assert 0.04 < hi.std() < 0.06


def test_synthetic_dataset_matches_jax(tmp_path):
    from plenoctree_tpu.data.datasets import Synthetic as JaxSynthetic

    cfg = config.default_config(dataset="synthetic")
    cfg.synthetic_resolution = 16
    out = get_dataset("test", cfg)
    ref = JaxSynthetic("test", cfg, prefetch=False)
    np.testing.assert_array_equal(out.images, ref.images)
    np.testing.assert_array_equal(out.camtoworlds, ref.camtoworlds)
    assert (out.h, out.w, out.focal, out.size) == (ref.h, ref.w, ref.focal, ref.size)
    batch = next(out)
    np.testing.assert_array_equal(batch["pixels"], ref.images[0])
    # LLFF is ported (its parity: tests/test_torch_datasets.py): a missing
    # image folder raises, a written capture loads.
    from plenoctree_tpu_torch.data.synthetic import write_llff_dataset

    with pytest.raises(ValueError, match="doesn't exist"):
        get_dataset("test", config.default_config(dataset="llff", data_dir=str(tmp_path)))
    write_llff_dataset(str(tmp_path / "llff"), n_views=4, resolution=8)
    llff = get_dataset("test", config.default_config(
        dataset="llff", data_dir=str(tmp_path / "llff"), factor=0))
    assert llff.size == 1 and llff.rays.origins.shape == (1, 8, 8, 3)
    with pytest.raises(NotImplementedError, match="not ported"):
        get_dataset("test", config.default_config(dataset="nope"))


def test_flags_match_jax_defaults():
    ref = jax_config.default_config()
    out = config.default_config()
    assert vars(out) == vars(ref)


@pytest.mark.parametrize(
    "path",
    sorted(glob.glob(os.path.join(REPO, "nerf_sh", "config", "**", "*.yaml"), recursive=True)),
    ids=os.path.basename,
)
def test_flat_yaml_reader_matches_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert config.read_flat_yaml(text, path) == (yaml.safe_load(text) or {})


def test_flat_yaml_scalars_and_rejects_nesting():
    text = "a: 1\nb: 1.5\nc: 1e-3\nd: true\ne: ~\nf: 'x y'\ng: .inf\n# c\nh: abc  # tail\n"
    assert config.read_flat_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError):
        config.read_flat_yaml("a:\n  b: 1\n")
    with pytest.raises(ValueError):
        config.read_flat_yaml("a: [1, 2]\n")


def test_parse_flags_config_then_explicit_flags(tmp_path):
    import argparse

    parser = argparse.ArgumentParser()
    config.add_flags(parser)
    cfg = config.parse_flags(parser, [
        "--config", os.path.join(REPO, "nerf_sh", "config", "blender"),
        "--dataset", "synthetic", "--nowhite_bkgd", "--randomized=false", "--near", "1.5",
    ])
    assert cfg.dataset == "synthetic"  # explicit flag wins over the file
    assert cfg.sh_deg == 3 and cfg.factor == 0  # from the file
    assert cfg.white_bkgd is False and cfg.randomized is False and cfg.near == 1.5
    assert cfg.fast_eval is False and cfg.chunk == 8192  # defaults
    with pytest.raises(SystemExit):
        config.parse_flags(parser, ["--dataset", "nope"])
    bad = tmp_path / "bad.yaml"
    bad.write_text("not_a_flag: 1\n")
    with pytest.raises(ValueError, match="not_a_flag"):
        config.update_flags(config.default_config(config=str(bad)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_transmittance_cumprod_grad_is_atens(dtype):
    """The transmittance's cumprod (ops/rendering.py::_CumProd) gives ATen's
    cumprod and ATen's gradient bit for bit, for factors in [eps, 1]
    (the smallest, alpha = 1, included); it only skips ATen's host-side
    test for a zero factor."""
    from plenoctree_tpu_torch.ops.rendering import _CumProd

    g = torch.Generator().manual_seed(4)
    x = (torch.rand((64, 191), generator=g) + 1e-10).to(dtype)
    x[:, 5] = 1e-10
    grad = torch.randn((64, 191), generator=g).to(dtype)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    (ga,) = torch.autograd.grad(torch.cumprod(a, -1), a, grad)
    (gb,) = torch.autograd.grad(_CumProd.apply(b), b, grad)
    assert torch.equal(torch.cumprod(x, -1), _CumProd.apply(x)) and torch.equal(ga, gb)
