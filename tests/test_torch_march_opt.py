"""Port parity on the CPU: the march optimizer (plenoctree_tpu_torch/octree/
optimize.py, `cli.optimize` without --tile_opt) and the march eval CLI
against the JAX package's optimize_tree and eval_octree.

A washed depth-3 SH1 tree (the colours of every leaf set to 0), the
analytic scene's views at odd sizes, numpy-seeded inputs.

Tolerances:
  * SQ_GRAD_RTOL = 1e-5 of the largest |gradient| for one shade's
    gradient given the same contributor slots: the same formula, f32 sums
    in another order (measured 4.2e-7);
  * PSNR_ATOL_DB = 1e-3 dB per epoch (measured <= 1.9e-6 dB);
  * the leaf data after two epochs (values up to 56): XLA fuses the
    optimizer's `p - lr * g` and the momentum trace into FMAs, which the
    port rounds as a product and a sum, and sums the gradient over rays in
    another order, so the data drift by ulps per step: DATA_ATOL = 2e-4
    for SGD (measured <= 7.6e-5). Adam divides by sqrt(nu) + 1e-8, so a
    leaf whose summed gradient cancels to ~1e-12 moves by ~lr * g / 1e-8,
    and the order of that cancelled sum shows: DATA_ATOL_ADAM = 1e-3 at
    lr 0.1 (measured 2.3e-4).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plenoctree_tpu.data.synthetic import render_synthetic_scene as jax_scene
from plenoctree_tpu.octree import N3Tree as JaxN3Tree
from plenoctree_tpu.octree import march as JM
from plenoctree_tpu.octree import renderer as JR
from plenoctree_tpu.octree.optimize import TwoPhaseRenderer as JaxTwoPhase
from plenoctree_tpu.octree.optimize import optimize_tree as jax_optimize_tree
from plenoctree_tpu.utils.config import default_config as jax_config
from plenoctree_tpu_torch.octree import N3Tree
from plenoctree_tpu_torch.octree import optimize as PO
from plenoctree_tpu_torch.octree import renderer as PR
from plenoctree_tpu_torch.utils.config import default_config

from tests.test_octree import build_scene_tree

torch.set_num_threads(1)  # see tests/test_torch_tile_opt.py

SQ_GRAD_RTOL = 1e-5
PSNR_ATOL_DB = 1e-3
DATA_ATOL = 2e-4
DATA_ATOL_ADAM = 1e-3
RES = 21


@pytest.fixture(scope="module")
def washed(tmp_path_factory):
    """(path, JAX tree, port tree) of the washed depth-3 tree."""
    tree = build_scene_tree(depth=3)
    tree.data[: tree.n_internal, ..., :3] = 0.0
    path = str(tmp_path_factory.mktemp("opt") / "washed.npz")
    tree.save(path, compress=False)
    return path, JaxN3Tree.load(path), N3Tree.load(path)


def test_sq_grad_matches_jax(washed):
    """The clamped-MSE gradient of one shade, given JAX's contributor slots
    for 21x21 rays; and the port's own march finds the same slots."""
    _, jt, pt = washed
    images, c2ws, focal = jax_scene("train", 2, RES, True, 2.0, 6.0)
    opts = dict(step_size=1e-3, max_segments=JR.default_max_segments(jt))
    K = JM.estimate_contrib_slots(jt)
    jr = JaxTwoPhase(JR.tree_arrays(jt), "SH", 1, JR.RenderOptions(**opts), K=K)
    pr = PO.TwoPhaseRenderer(PR.tree_arrays(pt, device="cpu"), "SH", 1, PR.RenderOptions(**opts), K=K)
    o, d = PO._image_rays(c2ws[0], RES, RES, focal, None)
    gt = images[1].reshape(-1, 3)
    mask = np.ones((o.shape[0], 1), np.float32)
    mask[-7:] = 0.0
    rp = jr.prep(o, d)
    carry = jr.march(jr.data0, rp, o.shape[0])
    sq_j, g_j = jr._sq_grad(jr.data0, carry["cells"], carry["dts"], carry["count"], rp[6],
                            jnp.asarray(gt), jnp.asarray(mask))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    sq_p, g_p = pr.sq_grad(pr.data0, t(carry["cells"]), t(carry["dts"]), t(carry["count"]),
                           t(rp[6]), t(gt), t(mask))
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 0
    assert np.abs(g_p.numpy() - g_j).max() <= SQ_GRAD_RTOL * np.abs(g_j).max()
    assert abs(float(sq_p) - float(sq_j)) <= 1e-5 * float(sq_j)

    prp = pr.prep(o, d)
    pc = pr.march(pr.data0, prp, o.shape[0])
    for k in ("cells", "count"):
        np.testing.assert_array_equal(pc[k].numpy(), np.asarray(carry[k]), err_msg=k)
    np.testing.assert_allclose(pc["dts"].numpy(), np.asarray(carry["dts"]), rtol=1e-6, atol=0)
    sq2, g2, ov = pr.loss_grad(pr.data0, o, d, t(gt), t(mask))
    assert not bool(ov) and torch.equal(g2, g_p) and float(sq2) == float(sq_p)


def _val_psnrs(text):
    return [float(line.split()[3]) for line in text.splitlines() if line.startswith("** val psnr")]


@pytest.mark.parametrize(
    "use_sgd,momentum,lr,rays_per_step",
    [(True, 0.0, 3e4, 0), (True, 0.9, 1e4, 0), (False, 0.0, 0.1, 0), (True, 0.0, 3e4, 150)],
)
def test_optimize_tree_matches_jax(washed, capsys, use_sgd, momentum, lr, rays_per_step):
    """Two epochs over 4 views, validated on a 5th, chunks of 200 rays (the
    last one edge-padded and masked): the same val PSNR per epoch and the
    same leaf data."""
    _, jt, pt = washed
    images, c2ws, focal = jax_scene("train", 5, RES, True, 2.0, 6.0)
    kw = dict(num_epochs=2, lr=lr, use_sgd=use_sgd, sgd_momentum=momentum, val_interval=1,
              continue_on_decrease=True, chunk=200, rays_per_step=rays_per_step)
    args = (c2ws[:4], images[:4], c2ws[4:], images[4:], focal)
    capsys.readouterr()
    jbest, jpsnr = jax_optimize_tree(jt, *args, jax_config(renderer_step_size=1e-3), **kw)
    jvals = _val_psnrs(capsys.readouterr().out)
    pbest, ppsnr = PO.optimize_tree(pt, *args, default_config(renderer_step_size=1e-3), **kw,
                                    device="cpu")
    pvals = _val_psnrs(capsys.readouterr().out)
    assert len(jvals) == len(pvals) == 2
    np.testing.assert_allclose(pvals, jvals, rtol=0, atol=PSNR_ATOL_DB)
    assert abs(ppsnr - jpsnr) <= PSNR_ATOL_DB
    assert jbest is not None and pbest is not None
    atol = DATA_ATOL if use_sgd else DATA_ATOL_ADAM
    np.testing.assert_allclose(pbest.data, jbest.data, rtol=0, atol=atol)


@pytest.mark.parametrize("sgd", [True, False])
def test_optimize_cli_march_matches_jax(washed, tmp_path, capsys, sgd):
    """The optimize CLI without --tile_opt (the march) on the synthetic
    views at 15x15, one epoch: its initial and final val PSNR equal JAX's
    optimize_tree on the same views, and it saves the improved tree."""
    from plenoctree_tpu_torch.cli import optimize as cli

    path, jt, _ = washed
    out = str(tmp_path / "opt.npz")
    lr = 3e4 if sgd else 0.1
    capsys.readouterr()
    best_tree, best = cli.main([
        "--input", path, "--output", out, "--dataset", "synthetic", "--synthetic_resolution", "15",
        "--num_epochs", "1", "--val_interval", "1", "--lr", str(lr), "--renderer_step_size", "1e-3",
        "--device", "cpu", "--sgd" if sgd else "--nosgd",
    ])
    pvals = capsys.readouterr().out
    train, tc2w, focal = jax_scene("train", 12, 15, True, 2.0, 6.0)
    val, vc2w, _ = jax_scene("val", 4, 15, True, 2.0, 6.0)
    _, jbest = jax_optimize_tree(jt, tc2w, train, vc2w, val, focal, jax_config(renderer_step_size=1e-3),
                                 num_epochs=1, lr=lr, use_sgd=sgd, val_interval=1)
    jvals = capsys.readouterr().out
    initial = [float(s.split()[-1]) for s in (pvals, jvals) for s in s.splitlines()
               if s.startswith("** initial val psnr")]
    assert len(initial) == 2 and abs(initial[0] - initial[1]) <= PSNR_ATOL_DB
    assert abs(best - jbest) <= PSNR_ATOL_DB and best > initial[0]
    assert best_tree is not None and N3Tree.load(out).n_leaves == best_tree.n_leaves


def test_eval_cli_march_matches_jax(washed, tmp_path, monkeypatch):
    """The eval CLI without --fast_eval renders through the march (it builds
    no tile renderer), and its PSNR/SSIM/LPIPS equal JAX's eval_octree on the
    same views and the same random VGG weights (LPIPS to 1e-5 relative)."""
    from plenoctree_tpu.octree.evaluate import eval_octree as jax_eval
    from plenoctree_tpu.ops import lpips as jax_lpips
    from plenoctree_tpu_torch.cli import evaluate as cli
    from plenoctree_tpu_torch.data.datasets import get_dataset
    from plenoctree_tpu_torch.octree import tile_render
    from tests.test_torch_lpips import random_weights

    weights = str(tmp_path / "vgg.npz")
    np.savez(weights, **random_weights(np.random.default_rng(0)))
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", weights)

    def no_tile_renderer(*args, **kwargs):
        raise AssertionError("the eval without --fast_eval built a TileRenderer")

    monkeypatch.setattr(tile_render.TileRenderer, "__init__", no_tile_renderer)
    jax_lpips.load_weights.cache_clear()
    path = str(tmp_path / "tree.npz")
    build_scene_tree(depth=3).save(path, compress=False)
    psnr, ssim, lpips = cli.main(["--input", path, "--dataset", "synthetic",
                                  "--synthetic_resolution", "33", "--device", "cpu"])
    with open(path + ".results.json") as f:
        assert json.load(f) == {"psnr": psnr, "ssim": ssim, "lpips": lpips}
    cfg = default_config(dataset="synthetic")
    cfg.synthetic_resolution = 33
    try:
        want = jax_eval(JaxN3Tree.load(path), get_dataset("test", cfg), jax_config())
    finally:
        jax_lpips.load_weights.cache_clear()
    assert abs(psnr - want[0]) <= 1e-4 and abs(ssim - want[1]) <= 1e-5
    assert np.isfinite(lpips) and lpips > 0 and abs(lpips - want[2]) <= 1e-5 * want[2]


def test_optimize_cli_sends_ndc_configs_to_the_march(washed, tmp_path, capsys, monkeypatch):
    """An LLFF config (the CLI keys NDC on its name, as the JAX CLI does)
    takes the march optimizer with the NDC config, even with --tile_opt,
    and prints the JAX CLI's message; --opt_rays_per_step reaches it."""
    from plenoctree_tpu_torch.cli import optimize as cli

    seen = {}

    def march(*args, **kwargs):
        seen.update(kwargs)
        return None, 0.0

    def tiles(*args, **kwargs):
        raise AssertionError("an NDC scene went to the tile optimizer")

    monkeypatch.setattr(cli, "optimize_tree", march)
    monkeypatch.setattr(cli, "optimize_tree_tiles", tiles)
    llff = tmp_path / "llff.yaml"
    llff.write_text("factor: 4\n")
    cli.main(["--input", washed[0], "--config", str(llff), "--dataset", "synthetic",
              "--synthetic_resolution", "9", "--tile_opt", "--opt_rays_per_step", "17",
              "--device", "cpu"])
    assert "tile_opt unsupported with NDC; falling back to the march" in capsys.readouterr().out
    assert seen["ndc"] == {"width": 9, "height": 9, "focal": 1.1 * 9}
    assert seen["rays_per_step"] == 17


def test_optimize_missing_gpu_raises(washed):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    _, _, pt = washed
    images, c2ws, focal = jax_scene("train", 2, 9, True, 2.0, 6.0)
    with pytest.raises(RuntimeError, match="cuda"):
        PO.optimize_tree(pt, c2ws[:1], images[:1], c2ws[1:], images[1:], focal,
                         default_config(), num_epochs=1)
