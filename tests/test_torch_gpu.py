"""The CUDA tile kernel on the card (marked `gpu`; skips without CUDA).

This file imports no JAX, so it also runs where the JAX stack is absent;
tests/conftest.py imports jax, so run it there without the conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from plenoctree_tpu_torch.data.synthetic import build_scene_tree, render_synthetic_scene
from plenoctree_tpu_torch.kernels import tile_composite as K
from plenoctree_tpu_torch.octree.tile_render import TileRenderer

# Kernel vs plain version on the same inputs (see chip_smoke.py): the sums
# run in different orders, hit tests and precedence are identical.
ATOL = 5e-5


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
def test_cuda_frame_matches_cpu_frame():
    """A whole frame on the card (phase 1 in torch, the CUDA kernel) vs the
    same renderer on the CPU (plain version): within 1e-4."""
    _need_cuda()
    tree = build_scene_tree(depth=4, basis_dim=16, sh_noise=0.05, seed=2)
    _, c2ws, focal = render_synthetic_scene("test", 2, 47, True, 2.0, 6.0)
    gpu = TileRenderer(tree, grid_c=16, device="cuda")
    cpu = TileRenderer(tree, grid_c=16, device="cpu")
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
