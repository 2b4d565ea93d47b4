"""Port parity on the CPU: the tile renderer (plenoctree_tpu_torch vs the JAX
TileRenderer, whose Pallas kernel runs interpreted here, use_bf16=False).

Every comparison feeds both packages the same tree, index and poses. The
CUDA kernel itself runs only on a GPU: tests/test_torch_gpu.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plenoctree_tpu.data.synthetic import render_synthetic_scene
from plenoctree_tpu.octree import tile_render as J
from plenoctree_tpu.octree.renderer import VolumeRenderer
from plenoctree_tpu_torch.data.synthetic import build_scene_tree as build_shn_tree
from plenoctree_tpu_torch.kernels import tile_composite as K
from plenoctree_tpu_torch.octree import tile_render as P

from tests.test_octree import build_scene_tree

GRID_C = 16


@pytest.fixture(scope="module")
def trees():
    return {
        "sh1": build_scene_tree(),
        "sh16": build_shn_tree(depth=4, basis_dim=16, sh_noise=0.05, seed=0),
    }


@pytest.fixture(scope="module")
def renderers(trees):
    """(jax, port) renderer pairs sharing one index per tree."""
    out = {}
    for name, tree in trees.items():
        jr = J.TileRenderer(tree, step_size=1e-4, grid_c=GRID_C, use_bf16=False)
        pr = P.TileRenderer(
            tree, step_size=1e-4, grid_c=GRID_C, device="cpu",
            index=P.index_from_jax(jr.index),
        )
        out[name] = (jr, pr)
    return out


def _poses(n, res):
    _, c2ws, focal = render_synthetic_scene("test", n, res, True, 2.0, 6.0)
    return c2ws, float(focal)


_JAX_TILE_INPUTS = {}


def _jax_tile_inputs(jr, res, focal, w1cap):
    """The JAX renderer's jitted tile-input fn, compiled once per shape."""
    key = (id(jr), res, focal, w1cap)
    if key not in _JAX_TILE_INPUTS:
        _JAX_TILE_INPUTS[key] = jax.jit(
            jr.make_tile_inputs_fn(res, res, focal, jr.rcap, w1cap, jr.ccap)
        )
    return _JAX_TILE_INPUTS[key]


def _psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.parametrize("name", ["sh1", "sh16"])
def test_build_tile_index_matches_jax(trees, name):
    """Host build: every array bit-identical, every scalar equal."""
    ref = J.build_tile_index(trees[name], sigma_thresh=1e-2, grid_c=GRID_C)
    out = P.build_tile_index(trees[name], sigma_thresh=1e-2, grid_c=GRID_C)
    assert set(out) == set(ref)
    for k in ref:
        a, b = np.asarray(ref[k]), out[k]
        assert isinstance(b, np.ndarray) or np.isscalar(b), k
        assert a.dtype == np.asarray(b).dtype and a.shape == np.shape(b), k
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=k)
    assert P.INDEX_FORMAT_VERSION == J.INDEX_FORMAT_VERSION
    assert P.COPY_PAD == J.COPY_PAD


@pytest.mark.parametrize("name", ["sh1", "sh16"])
def test_build_tile_index_keep_all_matches_jax(trees, name):
    """The optimizer's keep_all index (every leaf, empty coarse ones too, so
    replicas span up to grid_c/2 cells per axis): bit-identical as well."""
    ref = J.build_tile_index(trees[name], 0.0, grid_c=GRID_C, keep_all=True)
    out = P.build_tile_index(trees[name], 0.0, grid_c=GRID_C, keep_all=True)
    assert out["n_kept"] == trees[name].n_leaves
    for k in ref:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]), err_msg=k)


def test_index_from_jax(renderers):
    jr, pr = renderers["sh1"]
    idx = P.index_from_jax(jr.index)
    for k, v in jr.index.items():
        if isinstance(v, (int, np.integer)):
            assert idx[k] == int(v)
        else:
            assert isinstance(idx[k], torch.Tensor)
            np.testing.assert_array_equal(idx[k].numpy(), np.asarray(v))
    with pytest.raises(ValueError):
        P.TileRenderer(jr.tree, grid_c=32, index=idx, device="cpu")


def test_tilize_untile_inverse_and_match_jax():
    hp, wp, tile = 48, 32, 16
    x = np.arange(hp * wp * 3, dtype=np.float32).reshape(hp, wp, 3)
    ref = np.asarray(J._tilize(jnp.asarray(x), hp, wp, tile))
    out = P._tilize(torch.from_numpy(x), hp, wp, tile)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(P._untile(out, hp, wp, tile).numpy(), x)
    np.testing.assert_array_equal(P._tile_corner_idx(tile), J._tile_corner_idx(tile))
    np.testing.assert_array_equal(P._GROUP_CORNER_OFF(8), J._GROUP_CORNER_OFF(8))


def _random_runs(rng, rcap, rev, holes):
    n = int(rng.integers(0, 20))
    starts = np.sort(rng.choice(20000, size=n, replace=False))
    lens = rng.integers(1, 300, size=n)
    ends = starts + lens
    keep = np.ones(n, bool)
    for i in range(1, n):
        if starts[i] < ends[:i][keep[:i]].max(initial=-1):
            keep[i] = False
    starts, lens = starts[keep], lens[keep]
    n = starts.shape[0]
    if rev:
        starts, lens = starts[::-1].copy(), lens[::-1].copy()
    s, l, m = (np.zeros(rcap, np.int32) for _ in range(3))
    pos = np.sort(rng.choice(rcap, size=n, replace=False)) if holes and n else np.arange(n)
    s[pos], l[pos] = starts, lens
    m[pos] = rng.integers(1, 16, size=n)
    return s, l, m


@pytest.mark.parametrize("rev", [0, 1])
@pytest.mark.parametrize("holes", [False, True])
def test_merge_and_expand_match_jax(rev, holes):
    """Run merging and piece expansion on a batch of random run lattices:
    every output equal to the JAX functions' (which see one tile at a
    time; the port takes the batch at once)."""
    rng = np.random.default_rng(11 + rev + 2 * holes)
    rcap, quantum, ccap = 64, 128, 96
    s, l, m = (np.stack(x) for x in zip(*[_random_runs(rng, rcap, rev, holes) for _ in range(12)]))
    rv = np.full(s.shape[0], rev, np.int32)
    out = P._merge_runs(*(torch.from_numpy(x) for x in (s, l, m, rv)), quantum)
    pieces = P._expand_pieces(out[0], out[1], out[2], torch.from_numpy(rv), quantum, ccap)
    merge = jax.jit(J._merge_runs, static_argnums=(4,))
    expand = jax.jit(J._expand_pieces, static_argnums=(4, 5))
    for t in range(s.shape[0]):
        ref = merge(s[t], l[t], m[t], jnp.int32(rev), quantum)
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(b[t].numpy(), np.asarray(a))
        ref_p = expand(ref[0], ref[1], ref[2], jnp.int32(rev), quantum, ccap)
        for a, b in zip(ref_p, pieces):
            np.testing.assert_array_equal(b[t].numpy(), np.asarray(a))


@pytest.mark.parametrize("pose", [0, 1, 2])
def test_tile_inputs_match_jax(renderers, pose):
    """Ray generation, tree transform, basis and phase 1 for 3 poses at
    48x48 (9 tiles): integer arrays (piece lists, metas) and the saturation
    counters equal; floats within 1e-6, relative for values above 1 (invd
    reaches 1e6 at the |dn| floor; t-values reach ~5). The size is a tile multiple: in an
    edge-padded tile, a quad whose pixels all clamp to one edge pixel has a
    zero-area frustum whose plane normals are pure rounding residue (in
    both packages); its mask bits only touch cropped pixels, but they need
    not agree bit for bit."""
    jr, pr = renderers["sh16"]
    res = 48
    c2ws, focal = _poses(3, res)
    w1cap = 8
    idx = jr.index
    ref = _jax_tile_inputs(jr, res, focal, w1cap)(
        jnp.asarray(c2ws[pose]), idx["csr"], idx["base"], jr.extra_data, idx["blk_bbox"]
    )
    pidx = pr.index
    out = pr.make_tile_inputs_fn(res, res, focal, pr.rcap, w1cap, pr.ccap)(
        c2ws[pose], pidx["csr"], pidx["base"], pr.extra_data, pidx["blk_bbox"]
    )
    names = ("meta", "c0", "lo", "hi", "mask", "o", "invd", "aux", "mdir", "basis")
    for name, a, b in zip(names, ref[0], out[0]):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)
    assert int(np.asarray(ref[0][0])[:, 0, 0].sum()) > 0  # the frame has pieces
    for a, b in zip(ref[1:], out[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("name", ["sh1", "sh16"])
def test_reference_matches_jax_kernel(renderers, name):
    """composite_tiles_reference vs the JAX _tile_kernel (interpreted) on
    identical p2 arguments: max abs <= 1e-5 (same hit tests and precedence;
    the sums run in another order)."""
    jr, pr = renderers[name]
    res = 48
    c2ws, focal = _poses(1, res)
    idx = jr.index
    p2_args = _jax_tile_inputs(jr, res, focal, 8)(
        jnp.asarray(c2ws[0]), idx["csr"], idx["base"], jr.extra_data, idx["blk_bbox"]
    )[0]
    ref = np.asarray(jr._get_p2(p2_args[0].shape[0], jr.ccap)(*p2_args, idx["soa"]))
    args = [torch.from_numpy(np.array(a)) for a in p2_args]
    out = K.composite_tiles_reference(*args, pr.index["soa"], **pr._kernel_kw).numpy()
    assert np.abs(out - ref).max() <= 1e-5
    assert (ref[..., 3] < 0.5).any()  # some rays are mostly occluded
    # The wrapper takes the plain version for CPU tensors, without a launch.
    before = K.launches
    np.testing.assert_array_equal(
        K.composite_tiles(*args, pr.index["soa"], **pr._kernel_kw).numpy(), out
    )
    assert K.launches == before


@pytest.mark.parametrize("name,res", [("sh1", 33), ("sh1", 47), ("sh16", 41)])
def test_render_persp_matches_jax(renderers, name, res):
    """Whole frames, 2 poses, odd sizes: max abs <= 1e-4 against the JAX
    renderer. Odd sizes keep every ray off the principal axis: at even
    sizes one ray passes exactly through the tree centre, where 8 cells
    meet, and there f32 slab tests are ill-conditioned (the JAX f32 result
    itself differs from an f64 evaluation by ~4e-4 on that pixel)."""
    jr, pr = renderers[name]
    c2ws, focal = _poses(2, res)
    for c2w in c2ws:
        ref = jr.render_persp(c2w, res, res, focal)
        out = pr.render_persp(c2w, res, res, focal)
        assert out.shape == ref.shape == (res, res, 3) and out.dtype == np.float32
        assert np.abs(out - ref).max() <= 1e-4
    assert (pr.w1cap, pr.ccap) == (jr.w1cap, jr.ccap)


def test_render_persp_vs_march_oracle(trees):
    """Mirrors tests/test_tile_render.py: > 45 dB against the exact march."""
    tree = trees["sh1"]
    c2ws, focal = _poses(1, 48)
    vr = VolumeRenderer(tree, step_size=1e-4)
    pr = P.TileRenderer(tree, step_size=1e-4, grid_c=GRID_C, device="cpu")
    ref = np.clip(vr.render_persp(c2ws[0], 48, 48, focal), 0, 1)
    out = np.clip(pr.render_persp(c2ws[0], 48, 48, focal), 0, 1)
    assert _psnr(out, ref) > 45.0


def test_cap_regrowth_matches_large_caps(renderers):
    """Tiny ccap/w1cap regrow (sticky) and re-render to the image the
    large caps give; fast-mode thresholds; u8 output packs the same frame."""
    _, pr = renderers["sh1"]
    tree = pr.tree
    c2ws, focal = _poses(1, 32)
    kw = dict(step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2, grid_c=GRID_C,
              device="cpu", index=pr.index)
    big = P.TileRenderer(tree, ccap=4096, w1cap=GRID_C, **kw)
    small = P.TileRenderer(tree, ccap=8, w1cap=1, **kw)
    ref = big.render_persp(c2ws[0], 32, 32, focal)
    out = small.render_persp(c2ws[0], 32, 32, focal)
    assert small.ccap > 8 and small.w1cap > 1
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    u8 = P.TileRenderer(tree, output="u8", **kw).render_persp(c2ws[0], 32, 32, focal)
    assert u8.dtype == np.uint8 and u8.shape == (32, 32, 3)
    np.testing.assert_array_equal(u8, np.round(np.clip(ref, 0, 1) * 255).astype(np.uint8))


def test_check_caps_clip_warns(renderers):
    _, pr = renderers["sh1"]
    r = P.TileRenderer(pr.tree, grid_c=GRID_C, ccap=16384, w1cap=4, device="cpu", index=pr.index)
    with pytest.warns(UserWarning, match="clipped at 16384"):
        assert r._check_caps(0, 20000, 0) is False
    assert r._check_caps(0, 0, 3) is True and r.w1cap == min(GRID_C, 4 + 3 + 2)


def test_empty_tree_renders_background():
    from plenoctree_tpu.octree import N3Tree

    tree = N3Tree(data_dim=4, depth_limit=2, radius=1.0, center=(0, 0, 0))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 3.0
    out = P.TileRenderer(tree, device="cpu").render_persp(c2w, 16, 16, 16.0)
    assert np.allclose(out, 1.0)


def test_unported_branches_and_missing_gpu_raise(renderers):
    _, pr = renderers["sh1"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        P.TileRenderer(pr.tree, ndc={"width": 8, "height": 8, "focal": 8.0}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        P.TileRenderer(pr.tree, mesh=object(), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        P.TileRenderer(pr.tree, grid_c=GRID_C, index=pr.index, device="cuda")


def test_eval_cli_end_to_end(tmp_path, monkeypatch):
    """The eval CLI (--fast_eval) on the 4-view synthetic test set at 15x15
    (odd, as in test_render_persp_matches_jax): the results file holds the
    metrics it prints and returns, and those equal the JAX package's
    compute_psnr / compute_ssim averaged over the frames the CLI rendered
    (PSNR within 1e-5 dB, SSIM within 1e-5). Renderer parity itself is
    test_render_persp_matches_jax's."""
    from plenoctree_tpu.ops.metrics import compute_psnr, compute_ssim
    from plenoctree_tpu_torch.cli import evaluate as cli
    from plenoctree_tpu_torch.data.datasets import get_dataset
    from plenoctree_tpu_torch.utils.config import default_config

    frames = []
    render = P.TileRenderer.render_persp

    def spy(self, *args):
        frames.append(render(self, *args))
        return frames[-1]

    monkeypatch.setattr(P.TileRenderer, "render_persp", spy)
    path = str(tmp_path / "tree.npz")
    build_scene_tree().save(path)
    psnr, ssim, lpips = cli.main([
        "--input", path, "--config", "nerf_sh/config/blender", "--dataset",
        "synthetic", "--synthetic_resolution", "15", "--fast_eval", "--device", "cpu",
    ])
    with open(path + ".results.json") as f:
        res = json.load(f)
    assert res["psnr"] == psnr and res["ssim"] == ssim
    assert np.isnan(res["lpips"]) and np.isnan(lpips)
    assert psnr > 30 and ssim > 0.9

    cfg = default_config(dataset="synthetic")
    cfg.synthetic_resolution = 15
    data = get_dataset("test", cfg)
    assert len(frames) == data.size == 4
    ref_psnr = ref_ssim = 0.0
    for im, gt in zip(frames, data.images):
        im = np.clip(im, 0.0, 1.0)
        ref_psnr += float(compute_psnr(float(((im - gt) ** 2).mean()))) / data.size
        ref_ssim += float(compute_ssim(jnp.asarray(im), jnp.asarray(gt), 1.0)) / data.size
    assert abs(ref_psnr - psnr) < 1e-5 and abs(ref_ssim - ssim) < 1e-5


def test_eval_without_fast_eval_raises(tmp_path, trees):
    """Without --fast_eval the eval CLI renders through the exact march
    (held to the JAX package in tests/test_torch_march_opt.py). What still
    raises: --device cuda without a GPU, on that path too, and
    --shard_devices > 1 with --fast_eval (multi-device serving, not
    ported)."""
    from plenoctree_tpu_torch.cli import evaluate as cli

    path = str(tmp_path / "tree.npz")
    trees["sh1"].save(path)
    base = ["--input", path, "--dataset", "synthetic", "--synthetic_resolution", "16"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(base + ["--fast_eval", "--shard_devices", "2", "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(base)
