"""The port's multi-device paths against the JAX package on the CPU.

Data-parallel training runs on a 2-rank gloo group whose ranks are
processes (plenoctree_tpu_torch.parallel.ranks.run_ranks: a FileStore in a
fresh temporary directory, a timeout after which every rank is killed);
the JAX side runs its mesh step over the conftest's 8 CPU devices on the
same global batch, parameters, Adam moments and sparsity points.
Inference runs over a list of CPU devices (a device may repeat), against
the JAX package's mesh inference and against one device. Small sizes:
depth 3, width 32, batch 64, 8 + 8 samples.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from plenoctree_tpu import engine as jengine
from plenoctree_tpu.data.synthetic import render_synthetic_scene
from plenoctree_tpu.models import construct_nerf as jax_construct_nerf
from plenoctree_tpu.octree import tile_render as J
from plenoctree_tpu.parallel import make_mesh as jax_make_mesh
from plenoctree_tpu.parallel import mesh as jax_mesh_lib
from plenoctree_tpu.parallel import replicate_pytree, shard_pytree_batch
from plenoctree_tpu.types import Rays as JaxRays
from plenoctree_tpu.utils import checkpoints as jckpt
from plenoctree_tpu.utils import config as jconfig
from plenoctree_tpu_torch import engine, parallel
from plenoctree_tpu_torch.cli import gen_mesh
from plenoctree_tpu_torch.cli import train as train_cli
from plenoctree_tpu_torch.data import datasets
from plenoctree_tpu_torch.data.rays import Rays
from plenoctree_tpu_torch.models.nerf import NerfModel, get_model_state
from plenoctree_tpu_torch.models.params import init_trunk_params, params_from_flax, params_to_flax
from plenoctree_tpu_torch.octree import extract as extract_lib
from plenoctree_tpu_torch.octree import tile_render as P
from plenoctree_tpu_torch.octree.evaluate import eval_octree
from plenoctree_tpu_torch.parallel import mesh as mesh_lib
from plenoctree_tpu_torch.parallel.ranks import run_ranks, train_steps
from plenoctree_tpu_torch.utils import config as tconfig

from tests.test_octree import build_scene_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 64
# The model of tests/test_partition.py's size, coarse and fine.
CFG = dict(net_depth=3, net_width=32, skip_layer=4, sh_deg=1, use_viewdirs=False,
           num_coarse_samples=8, num_fine_samples=8, batch_size=B, sparsity_npoints=128,
           randomized=False, weight_decay_mult=0.1, max_steps=1000, dataset="synthetic")
# tests/test_torch_train.py's bounds: F32_TOL for whole f32 models, losses
# and (here) the parameters after an Adam step; F32_GRAD_RTOL, per leaf
# max relative, for the gradients.
F32_TOL = dict(atol=1e-5, rtol=1e-5)
F32_GRAD_RTOL = 1e-4
STATS = ("loss", "psnr", "loss_c", "psnr_c", "weight_l2", "loss_sp")
WORKER = "plenoctree_tpu_torch.parallel.ranks:train_steps"


def _params(seed, fine=True, width=32):
    rng = np.random.default_rng(seed)
    tree = {name: init_trunk_params(rng, 63, 3, width, 4, 1, 12, bias_std=0.05)
            for name in (("MLP_0", "MLP_1") if fine else ("MLP_0",))}
    return {k: v.numpy() for k, v in params_from_flax(tree).items()}


def _warm_adam(params, seed, count=10):
    """Adam moments as after `count` steps: the update is then a smooth
    function of the gradient (a fresh Adam's first update is lr * sign(g),
    where a gradient near 0 flips with any rounding)."""
    rng = np.random.default_rng(seed)
    mu = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32) for k, v in params.items()}
    nu = {k: ((rng.uniform(0.5, 1.5, size=v.shape) * 1e-3) ** 2).astype(np.float32)
          for k, v in params.items()}
    return {"count": count, "mu": mu, "nu": nu}


def _batch(seed, n=B):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(size=(n, 3)) * 0.3 - o / 4.0
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return {"pixels": rng.uniform(size=(n, 3)).astype(np.float32),
            "rays": Rays(*[a.astype(np.float32) for a in (o, d, v)])}


def _t(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


# ---------------------------------------------------------------- mesh


@pytest.mark.parametrize("shape,n", [("", 3), ("3", 3), ("-1", 3), ("3,1", 3), ("-1,1", 4),
                                     ((2,), 2), (None, 1)])
def test_make_mesh_matches_jax_shapes(shape, n):
    mesh = parallel.make_mesh(shape, ["cpu"] * n)
    jmesh = jax_make_mesh(shape, jax.devices()[:n])
    assert mesh.data == jmesh.shape["data"] and mesh.model == jmesh.shape.get("model", 1) == 1
    assert len(mesh) == n and all(d == torch.device("cpu") for d in mesh.devices)


@pytest.mark.parametrize("shape,n,error", [("2", 3, ValueError), ("4", 3, ValueError),
                                           ("1,2", 3, ValueError),
                                           ("2,2", 2, ValueError),
                                           ("-1,2", 3, ValueError),
                                           ("1,1,1", 1, ValueError)])
def test_make_mesh_refuses(shape, n, error):
    """Shapes that do not cover the devices (a model axis too: it is ported,
    tests/test_torch_partition.py) or have three axes."""
    with pytest.raises(error):
        parallel.make_mesh(shape, ["cpu"] * n)


@pytest.mark.parametrize("n,multiple", [(10, 3), (9, 3), (1, 4), (7, 8)])
def test_pad_to_multiple_matches_jax(n, multiple):
    x = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    want, want_pad = jax_mesh_lib.pad_to_multiple(x, multiple)
    got, pad = parallel.pad_to_multiple(x, multiple)
    got_t, pad_t = parallel.pad_to_multiple(torch.from_numpy(x), multiple)
    assert pad == pad_t == want_pad
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_shard_batch_splits_rows_and_keeps_sp_points():
    batch = _batch(1, 12)
    draws = {"t_rand": np.arange(24.0).reshape(12, 2), "sp_points": np.ones((5, 3))}
    parts = [parallel.shard_batch({**batch, "draws": draws}, r, 3) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([p["pixels"] for p in parts]), batch["pixels"])
    for i in range(3):
        np.testing.assert_array_equal(np.concatenate([p["rays"][i] for p in parts]),
                                      batch["rays"][i])
        assert isinstance(parts[i]["rays"], Rays) and parts[i]["rays"][0].shape == (4, 3)
    assert all(p["draws"]["sp_points"] is draws["sp_points"] for p in parts)
    np.testing.assert_array_equal(parts[2]["draws"]["t_rand"], draws["t_rand"][8:])
    with pytest.raises(ValueError, match="does not divide"):
        parallel.shard_batch(batch, 0, 5)


# ---------------------------------------------------------------- training


def _jax_state(params, moments):
    """A JAX TrainState at the port's parameters and Adam moments."""
    st = jckpt.create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, params_to_flax(_t(params)))})
    adam = st.opt_state[0]._replace(
        count=jnp.int32(moments["count"]), mu=params_to_flax(_t(moments["mu"])),
        nu=params_to_flax(_t(moments["nu"])))
    return st.replace(step=jnp.int32(moments["count"]), opt_state=(adam, st.opt_state[1]))


def test_two_rank_steps_match_jax_mesh_step():
    """3 steps on a 2-rank gloo group against plenoctree_tpu.engine's mesh
    step over the 8 CPU devices (state replicated, batch sharded), each
    step from the same parameters and Adam moments (the port's, before
    that step), on the same global batch and sparsity points (JAX's own
    key_2 draw of that step). Held to tests/test_torch_train.py's bounds:
    stats and parameters F32_TOL, gradients (from JAX's new mu)
    F32_GRAD_RTOL per leaf; measured 2.6e-5 on the gradients. As in
    tests/test_torch_train.py, JAX's step runs op by op (jax.disable_jit):
    compiled whole, XLA's fusions move the compositing gradient of these
    rays by up to 2.8% of a leaf's largest gradient at step 1 (measured
    against JAX's own op-by-op step, which the port matches to 1.6e-5).
    Coarse level only: the fine depths' inverse CDF is ill-conditioned,
    and the fine-depth injection that tests/test_torch_train.py uses
    cannot reach into the ranks' processes;
    test_two_rank_steps_match_one_process holds the fine level against the
    port's one-process step."""
    cfg = dict(CFG, num_fine_samples=0)
    params = _params(14, fine=False)
    opt = _warm_adam(params, 15)
    key = random.PRNGKey(17)
    batches = [_batch(20 + k) for k in range(3)]
    sp = [np.asarray(random.uniform(random.split(random.fold_in(key, opt["count"] + k), 3)[2],
                                    (cfg["sparsity_npoints"], 3), minval=-1.5, maxval=1.5))
          for k in range(3)]
    ranks = run_ranks(WORKER, 2, dict(cfg=cfg, params=params, batches=batches,
                                      draws=[{"sp_points": s} for s in sp], opt_state=opt))
    got = ranks[0]
    for k in got["params"][-1]:
        np.testing.assert_array_equal(ranks[1]["params"][-1][k], got["params"][-1][k])

    jcfg = jconfig.default_config(**cfg)
    jmodel, _ = jax_construct_nerf(random.PRNGKey(0), jcfg)
    mesh = jax_make_mesh()
    assert mesh.shape["data"] == 8
    step = jengine.make_train_step(jmodel, jcfg, mesh, donate=False)
    for k, b in enumerate(batches):
        moments = {"count": opt["count"] + k, "mu": got["mu"][k], "nu": got["nu"][k]}
        state = replicate_pytree(_jax_state(got["params"][k], moments), mesh)
        jb = shard_pytree_batch({"rays": JaxRays(*b["rays"]), "pixels": b["pixels"]}, mesh)
        with jax.disable_jit():
            new, jstats, _ = step(state, jb, key)
        for name in STATS:
            np.testing.assert_allclose(got["stats"][k][name], float(getattr(jstats, name)),
                                       err_msg=f"step {k} {name}", **F32_TOL)
        jmu = params_from_flax(jax.device_get(new.opt_state[0].mu))
        jparams = params_from_flax(jax.device_get(new.variables["params"]))
        for name, g in got["grads"][k].items():
            jg = (jmu[name].numpy().astype(np.float64) - 0.9 * got["mu"][k][name]) / 0.1
            assert _rel(g, jg) <= F32_GRAD_RTOL, (k, name, _rel(g, jg))
            np.testing.assert_allclose(got["params"][k + 1][name], jparams[name].numpy(),
                                       err_msg=f"step {k} {name}", **F32_TOL)


@pytest.mark.parametrize("dtype,use_pallas", [("float32", False), ("bfloat16", True)])
def test_two_rank_steps_match_one_process(dtype, use_pallas):
    """A 2-rank step (each rank half of the global batch) against the port's
    one-process step on the whole batch, coarse and fine, with handed-in
    draws (randomized stratified and fine samples, the sparsity points):
    the ranks' parameters bitwise equal to each other and within F32_TOL of
    the one-process step's, stats too, gradients within F32_GRAD_RTOL.
    The gradients differ only in the order of their sums (measured 1.4e-7)."""
    cfg = dict(CFG, randomized=True, compute_dtype=dtype, use_pallas=use_pallas)
    params = _params(30)
    opt = _warm_adam(params, 31)
    rng = np.random.default_rng(32)
    batches = [_batch(33 + k) for k in range(2)]
    draws = [{"t_rand": rng.uniform(size=(B, 8)).astype(np.float32),
              "u": rng.uniform(size=(B, 9)).astype(np.float32),
              "sp_points": rng.uniform(-1.5, 1.5, (128, 3)).astype(np.float32)}
             for _ in batches]
    kw = dict(cfg=cfg, params=params, batches=batches, draws=draws, opt_state=opt)
    one = train_steps(0, 1, **kw)
    two = run_ranks(WORKER, 2, kw)
    for k in range(len(batches)):
        for name in STATS:
            np.testing.assert_allclose(two[0]["stats"][k][name], one["stats"][k][name],
                                       err_msg=name, **F32_TOL)
        for name, g in one["grads"][k].items():
            assert _rel(two[0]["grads"][k][name], g) <= F32_GRAD_RTOL, (k, name)
    for name, p in one["params"][-1].items():
        np.testing.assert_array_equal(two[1]["params"][-1][name], two[0]["params"][-1][name])
        np.testing.assert_allclose(two[0]["params"][-1][name], p, err_msg=name, **F32_TOL)
        assert not np.array_equal(p, params[name]), name  # every leaf moved


def test_collectives_average_and_broadcast():
    """all_reduce_mean_ and broadcast_params_ on 3 ranks (ranks.collectives)."""
    out = run_ranks("plenoctree_tpu_torch.parallel.ranks:collectives", 3, timeout=60)
    for means, params in out:
        np.testing.assert_array_equal(means[0], np.ones(3))
        np.testing.assert_array_equal(means[1], np.arange(4.0).reshape(2, 2) * 2)
        assert all((p == 8.0).all() for p in params)


def test_run_ranks_reports_failing_ranks():
    """A batch that does not divide fails every rank: run_ranks raises with
    their logs, and no rank is left running."""
    kw = dict(cfg=CFG, params=_params(50), batches=[_batch(51, B - 1)])
    with pytest.raises(RuntimeError, match="failed") as e:
        run_ranks(WORKER, 2, kw, timeout=60)
    assert "--- rank 1 ---" in str(e.value) and "does not divide over 2 ranks" in str(e.value)


# ---------------------------------------------------------------- inference


def _pair(fine=True):
    """(jax model, jax cfg, variables, port model) sharing parameters."""
    cfg = dict(CFG, num_fine_samples=8 if fine else 0)
    jcfg = jconfig.default_config(**cfg)
    jmodel, _ = jax_construct_nerf(random.PRNGKey(0), jcfg)
    params = _params(40, fine)
    model = NerfModel(tconfig.default_config(**cfg))
    model.load_state_dict(_t(params))
    return jmodel, jcfg, {"params": params_to_flax(_t(params))}, model


@pytest.fixture(scope="module")
def nerf_pair():
    return _pair()


@pytest.mark.parametrize("fine", [True, False])
def test_render_image_over_devices_matches_jax_and_one_device(fine):
    """render_image over ['cpu'] * 3 at a chunk of 37 rays (each chunk and
    the 26-ray tail edge-padded to 3): within 1e-6 of one device's frame
    (the CPU's matmuls block their sums by the rows they are given: one
    element of 300 moved by 6e-8). Coarse-only, against the JAX
    render_image over the 8-device mesh (its chunk must divide by 8: 40):
    rgb within 1e-5 (tests/test_torch_video_mesh.py's bound), disparity
    and acc within 1e-4, test_torch_train.py's bound for acc (a far-cap
    alpha of 1 - exp(-sigma * 1e10) moves with a near-zero sigma; measured
    2.4e-5 and 1.5e-5). With fine samples the inverse CDF's ill-conditioning
    parts the packages by 1e-3 (tests/test_torch_train.py), so that model is
    held against one device only."""
    jmodel, jcfg, variables, model = _pair(fine)
    rng = np.random.default_rng(41)
    o = np.broadcast_to(np.array([0.0, 0.0, 4.0], np.float32), (10, 10, 3)).copy()
    d = rng.normal(size=(10, 10, 3)).astype(np.float32) * 0.2
    d[..., 2] = -1.0
    v = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rays = Rays(o, d, v)
    one = engine.render_image(model, rays, chunk=37)
    many = engine.render_image(model, rays, chunk=37, devices=["cpu"] * 3)
    for a, b in zip(one, many):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    if fine:
        return
    render_fn = jengine.make_render_fn(jmodel, jcfg, randomized=False)
    want = jengine.render_image(functools.partial(render_fn, variables), JaxRays(o, d, v),
                                random.PRNGKey(0), chunk=40, mesh=jax_make_mesh())
    for a, b, tol in zip(many, want, (1e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol)


def test_eval_points_over_devices_matches_jax_and_one_device(nerf_pair):
    """engine.eval_points over ['cpu'] * 3 at a chunk of 100 points (a tail of
    50): within 1e-6 of one device (see the render test above), and within
    F32_TOL of the JAX eval_points over the 8-device mesh (at a chunk of
    104, which its 8 devices divide)."""
    jmodel, _, variables, model = nerf_pair
    pts = np.random.default_rng(42).uniform(-1.5, 1.5, (250, 3)).astype(np.float32)
    points_fn = extract_lib.make_points_fn(model, "cpu")
    rgb, sigma = engine.eval_points(points_fn, pts, 100, ["cpu"] * 3)
    one_rgb, one_sigma = points_fn(pts)
    np.testing.assert_allclose(rgb.numpy(), one_rgb.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), one_sigma.numpy(), rtol=0, atol=1e-6)
    jfn = jengine.make_eval_points_fn(jmodel, raw_rgb=True)
    jrgb, jsigma = jengine.eval_points(lambda p, v: jfn(variables, p, v), pts, None, chunk=104,
                                       mesh=jax_make_mesh())
    np.testing.assert_allclose(rgb.numpy(), jrgb, **F32_TOL)
    np.testing.assert_allclose(sigma.numpy(), jsigma, **F32_TOL)


def test_extraction_over_devices_builds_the_one_device_tree(nerf_pair):
    """auto_scale, step 1 and step 2 over ['cpu'] * 2 (dispatches split, the
    jitter stream unchanged): the same bbox and topology as on one device,
    the leaf data within 1e-6 (see the render test above)."""
    _, _, _, model = nerf_pair
    from plenoctree_tpu_torch.octree import N3Tree

    cfg = tconfig.default_config(**dict(CFG, init_grid_depth=3, samples_per_cell=3,
                                        point_chunk=100, masking_mode="sigma",
                                        alpha_thresh=0.0, scale_alpha_thresh=0.0))
    points_fn = extract_lib.make_points_fn(model, "cpu")
    trees = []
    for devices in (None, ["cpu", "cpu"]):
        c, r = extract_lib.auto_scale(cfg, [0.0] * 3, [1.5] * 3, points_fn, "cpu", devices)
        tree = N3Tree(N=2, data_dim=13, init_reserve=5000, depth_limit=3, radius=r, center=c,
                      data_format="SH4")
        extract_lib.step1_build(cfg, tree, points_fn, None, devices=devices)
        extract_lib.step2_fill(cfg, tree, points_fn, devices=devices)
        trees.append((c, r, tree))
    (c0, r0, t0), (c1, r1, t1) = trees
    assert c0 == c1 and r0 == r1 and t0.n_leaves == t1.n_leaves > 8
    np.testing.assert_array_equal(t0.child, t1.child)
    np.testing.assert_allclose(t0.data, t1.data, rtol=0, atol=1e-6)


def test_gen_mesh_over_devices_matches_one_device(tmp_path):
    """The gen_mesh CLI with --mesh_shape 3 over ['cpu'] * 3 (three 40-point
    dispatches a step): the one-device sigma volume within 1e-6 (see the
    render test above), and a mesh of it."""
    flags = ["--config", "nerf_sh/config/blender", "--net_depth", "2", "--net_width", "16",
             "--sh_deg", "1", "--device", "cpu", "--train_dir", str(tmp_path),
             "--reso", "9 8 7", "--c1", "-1.5", "--c2", "1.5", "--iso", "0.05",
             "--point_chunk", "40"]
    one = gen_mesh.main(flags)
    many = gen_mesh.main(flags + ["--mesh_shape", "3"], devices=["cpu"] * 3)
    np.testing.assert_allclose(many["volume"].numpy(), one["volume"].numpy(), rtol=0, atol=1e-6)
    assert many["vertices"] > 0 and many["triangles"] > 0


@pytest.fixture(scope="module")
def scene_tree():
    return build_scene_tree()


def test_sharded_tile_frame_bitwise_and_matches_jax(scene_tree):
    """TileRenderer(mesh=...) over ['cpu'] * 8 on tests/test_tile_render.py's
    sharded scene at 41x41 (9 tiles, 7 padded ones): bitwise the one-device
    frame, the u8 payload of render_persp_async too; against the JAX
    renderer sharded over its 8-device mesh, within 1e-4, the bound of
    tests/test_torch_tile_render.py's whole-frame parity (measured 2.6e-6).
    JAX's sharded frame is its one-device frame bitwise, but the two
    packages' one-device frames part by 2.2-4.4e-6 at odd sizes (f32 sums in
    other orders) and by 5.2e-4 at 40x40, whose centre ray meets 8 cells at
    once (tests/test_torch_tile_render.py), so 1e-6 does not hold across
    packages."""
    res = 41
    kw = dict(step_size=1e-3, grid_c=8, use_bf16=False)
    jr = J.TileRenderer(scene_tree, mesh=jax.sharding.Mesh(np.array(jax.devices()), ("data",)),
                        **kw)
    index = P.index_from_jax(jr.index)
    single = P.TileRenderer(scene_tree, index=index, device="cpu", **kw)
    mesh = parallel.make_mesh(devices=["cpu"] * 8)
    sharded = P.TileRenderer(scene_tree, index=index, mesh=mesh, **kw)
    _, c2ws, focal = render_synthetic_scene("test", 1, res, True, 2.0, 6.0)
    a = single.render_persp(c2ws[0], res, res, focal)
    b = sharded.render_persp(c2ws[0], res, res, focal)
    want = jr.render_persp(c2ws[0], res, res, focal)
    assert a.shape == (res, res, 3) and a.min() < a.max()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(b, want, rtol=0, atol=1e-4)
    assert (sharded.w1cap, sharded.ccap) == (single.w1cap, single.ccap)
    u8 = [P.TileRenderer(scene_tree, index=index, output="u8", device="cpu", **kw),
          P.TileRenderer(scene_tree, index=index, output="u8", mesh=mesh, **kw)]
    for r in u8:
        r.w1cap = single.w1cap
    pay = [r.render_persp_async(c2ws[0], res, res, focal) for r in u8]
    assert torch.equal(pay[0], pay[1])


# ---------------------------------------------------------------- CLIs


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_under_two_gloo_ranks(tmp_path):
    """torch.distributed.run with 2 CPU ranks (gloo): both ranks train and
    report, rank 0 alone writes (one TensorBoard file, one timings.txt
    entry per render, one metrics line per scalar and step), and its
    checkpoint restores in the JAX package and in the port at world size 1."""
    train_dir = str(tmp_path / "run")
    model = ["--config", "nerf_sh/config/blender", "--dataset", "synthetic", "--device", "cpu",
             "--net_depth", "2", "--net_width", "16", "--sh_deg", "1",
             "--num_coarse_samples", "4", "--num_fine_samples", "4",
             "--synthetic_resolution", "16", "--chunk", "256"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           "-m", "plenoctree_tpu_torch.cli.train", *model, "--train_dir", train_dir,
           "--batch_size", "64", "--image_batching", "--max_steps", "4", "--print_every", "2",
           "--save_every", "4", "--render_every", "2", "--sparsity_npoints", "32",
           "--mesh_shape", "2"]
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert sum(ln.startswith("* rank 0/2: 4 steps") for ln in lines) == 1
    assert sum(ln.startswith("* rank 1/2: 4 steps") for ln in lines) == 1
    assert sum("all-reduce" in ln for ln in lines) == 2
    assert sum(ln == "* Saving" for ln in lines) == 1
    names = sorted(os.listdir(train_dir))
    assert "checkpoint_4" in names and "timings.txt" in names
    assert sum(n.startswith("events.out.tfevents") for n in names) <= 1
    assert sorted(os.listdir(os.path.join(train_dir, "render"))) == [
        "0000000002.png", "0000000004.png"]
    with open(os.path.join(train_dir, "timings.txt")) as f:
        assert [ln.split()[0] for ln in f.read().splitlines()] == ["0", "2", "4"]
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    assert sorted({r["step"] for r in rows if r["tag"] == "train_loss"}) == [2, 4]
    assert len([r for r in rows if r["tag"] == "train_loss"]) == 2

    cfg = tconfig.parse_flags(train_cli.build_parser(), model + ["--train_dir", train_dir])
    _, state = get_model_state(cfg, restore=True)
    assert state.step == 4 and state.opt_state["count"] == 4
    jcfg = jconfig.default_config(**{k: getattr(cfg, k) for k in (
        "net_depth", "net_width", "sh_deg", "num_coarse_samples", "num_fine_samples",
        "use_viewdirs", "sg_dim")})
    _, jvars = jax_construct_nerf(random.PRNGKey(0), jcfg)
    restored = jckpt.restore_checkpoint(train_dir, jckpt.create_train_state(jvars))
    assert int(restored.step) == 4
    jflat = params_from_flax(jax.tree_util.tree_map(np.asarray, restored.variables["params"]))
    for k, t in state.params.items():
        np.testing.assert_array_equal(jflat[k].numpy(), t.detach().numpy())


@pytest.mark.parametrize("case", ["batch", "backend", "nccl_shared", "train_mesh",
                                  "mesh_cli", "shard_devices", "cuda"])
def test_multi_device_misuse_raises(case, monkeypatch, tmp_path):
    """Nothing silently runs on one device: an indivisible batch, a backend
    that cannot serve the device, NCCL with every rank on one card, a
    --mesh_shape that does not cover the ranks or devices, more
    --shard_devices than visible GPUs, --device cuda without a GPU."""
    if case == "batch":
        monkeypatch.setattr(mesh_lib, "world", lambda: (1, 2))
        cfg = tconfig.default_config(dataset="synthetic", batch_size=63)
        cfg.synthetic_resolution = 8
        with pytest.raises(ValueError, match="does not divide over 2 ranks"):
            datasets.get_dataset("train", cfg)
    elif case in ("backend", "nccl_shared"):
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(ValueError, match="(?i)nccl"):
            if case == "backend":
                parallel.init_distributed("nccl", "cpu")
            else:
                parallel.init_distributed(None, "cuda:0")
    elif case == "train_mesh":
        with pytest.raises(ValueError, match="torch.distributed.run"):
            train_cli.main(["--dataset", "synthetic", "--device", "cpu", "--train_dir",
                            str(tmp_path), "--mesh_shape", "2"])
    elif case == "mesh_cli":
        with pytest.raises(ValueError, match="does not cover 1 devices"):
            gen_mesh.main(["--config", "nerf_sh/config/blender", "--device", "cpu",
                           "--train_dir", str(tmp_path), "--mesh_shape", "2"])
    elif case == "shard_devices":
        cfg = tconfig.default_config(fast_eval=True, shard_devices=2)
        data = type("D", (), dict(w=8, h=8, focal=10.0, size=1))()
        with pytest.raises(ValueError, match="--shard_devices 2 but 0 CUDA devices"):
            eval_octree(build_scene_tree(), data, cfg, want_lpips=False, device="cpu")
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            parallel.init_distributed(None, "cuda")
        with pytest.raises(RuntimeError, match="is_available"):
            train_cli.main(["--dataset", "synthetic", "--device", "cuda", "--train_dir",
                            str(tmp_path)])


def test_init_distributed_is_a_no_op_without_a_group(monkeypatch):
    """No WORLD_SIZE, or WORLD_SIZE 1 without torchrun's MASTER_ADDR: no
    group is made."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert parallel.init_distributed(None, "cpu") == (0, 1, torch.device("cpu"))
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert parallel.init_distributed("gloo", "cpu") == (0, 1, torch.device("cpu"))
    assert mesh_lib.world() == (0, 1) and mesh_lib.default_group() is None


def test_train_cli_under_torchrun_with_one_rank(tmp_path):
    """torch.distributed.run --nproc_per_node 1: a group of one (gloo on the
    CPU) is made, and its all-reduce runs every step."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           "-m", "plenoctree_tpu_torch.cli.train", "--config", "nerf_sh/config/blender",
           "--dataset", "synthetic", "--device", "cpu", "--net_depth", "2", "--net_width", "16",
           "--sh_deg", "1", "--num_coarse_samples", "4", "--num_fine_samples", "4",
           "--synthetic_resolution", "16", "--train_dir", str(tmp_path / "run"),
           "--batch_size", "32", "--max_steps", "2", "--print_every", "1", "--save_every", "2",
           "--render_every", "0", "--sparsity_npoints", "16"]
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "* Rank 0 of 1 on cpu (gloo)" in res.stdout
    assert "* rank 0/1: 2 steps" in res.stdout and "all-reduce" in res.stdout
