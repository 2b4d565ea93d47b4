"""Orbit video, mesh and the train CLI's extras, against the JAX package.

pose_spherical for every up axis, the equirectangular rays and maps (numpy
on both sides: bitwise); marching tetrahedra bitwise equal to the JAX numpy
function (a sphere SDF, random noise, the iso at exact corner values so
triangles collapse, an empty volume) and save_obj's bytes; the gen_mesh
CLI's sigma grid against the JAX package's engine.eval_points at a tiny
width, and both marchers on the JAX sigma; a gen_video frame at 17 x 17
against the JAX package's engine.render_image, with the CLI's layout and
poses file; the timings log through both packages' parsers; and the train
CLI's profiler trace, timings.txt and TensorBoard events on the CPU.

The JAX side is driven through its library functions the way its CLIs
call them (its gen_video / gen_mesh modules define absl flags that clash
with the other JAX CLIs' in one test process). Its checkpoint is written by
its save_checkpoint (an orbax directory), which the port's CLIs restore.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax import random

from plenoctree_tpu import engine as jengine
from plenoctree_tpu.data import poses as jposes
from plenoctree_tpu.data import rays as jrays
from plenoctree_tpu.models import get_model_state as jax_get_model_state
from plenoctree_tpu.ops import marching as jmarching
from plenoctree_tpu.parallel import make_mesh
from plenoctree_tpu.utils import checkpoints as jckpt
from plenoctree_tpu.utils import config as jconfig
from plenoctree_tpu.utils import io as jio
from plenoctree_tpu_torch import engine
from plenoctree_tpu_torch.cli import gen_mesh, gen_video, parse_timing
from plenoctree_tpu_torch.cli import train as train_cli
from plenoctree_tpu_torch.data import poses, rays
from plenoctree_tpu_torch.models.nerf import get_model_state
from plenoctree_tpu_torch.ops import marching
from plenoctree_tpu_torch.utils import config as tconfig
from plenoctree_tpu_torch.utils import io as io_utils
from plenoctree_tpu_torch.utils.png import read_png

torch.set_num_threads(1)  # several xdist workers share the cores

MODEL = ["--config", "nerf_sh/config/blender", "--net_depth", "2", "--net_width", "16",
         "--sh_deg", "1", "--num_coarse_samples", "8", "--num_fine_samples", "8",
         "--chunk", "256", "--device", "cpu"]
TINY = dict(net_depth=2, net_width=16, sh_deg=1, num_coarse_samples=8, num_fine_samples=8,
            chunk=256)
# Whole f32 models whose sums run in other orders agree to about 1e-6
# (tests/test_torch_train.py); the comparisons below are held to 1e-5.
ATOL = 1e-5


@pytest.mark.parametrize("up_axis", range(6))
def test_pose_spherical_up_axis_bitwise(up_axis):
    for theta, phi, radius in ((-180.0, -30.0, 4.0), (37.5, 12.0, 2.5), (171.0, -89.0, 1.0)):
        mine = poses.pose_spherical(theta, phi, radius, up_axis)
        want = jposes.pose_spherical(theta, phi, radius, up_axis)
        assert mine.dtype == want.dtype
        np.testing.assert_array_equal(mine, want)


def test_equirect_rays_and_maps_bitwise():
    c2w = np.stack([jposes.pose_spherical(t, -30.0, 4.0) for t in (0.0, 100.0)])
    mine, want = rays.generate_rays(9, 7, 11.0, c2w, equirect=True), \
        jrays.generate_rays(9, 7, 11.0, c2w, equirect=True)
    for a, b in zip(mine, want):
        np.testing.assert_array_equal(a, b)
    uv = np.random.default_rng(0).uniform(-1, 1, (50, 2)).astype(np.float32)
    xyz = rays.equirect2xyz(uv)
    np.testing.assert_array_equal(xyz, jrays.equirect2xyz(uv))
    np.testing.assert_array_equal(rays.xyz2equirect(xyz), jrays.xyz2equirect(xyz))


def _volume(case):
    rng = np.random.default_rng(3)
    if case == "sphere":
        g = np.stack(np.meshgrid(*[np.linspace(-1, 1, 21)] * 3, indexing="ij"), -1)
        return 0.7 - np.linalg.norm(g, axis=-1), 0.0
    if case == "noise":
        return rng.normal(size=(13, 11, 12)).astype(np.float32), 0.3
    if case == "corners":  # the iso equals corner values: crossings at corners
        return rng.integers(0, 3, size=(10, 9, 8)).astype(np.float64), 1.0
    return np.zeros((6, 7, 5)), 0.5  # empty


@pytest.mark.parametrize("case", ["sphere", "noise", "corners", "empty"])
def test_marching_tetrahedra_bitwise(case):
    vol, iso = _volume(case)
    want_v, want_t = jmarching.marching_tetrahedra(vol, iso)
    got_v, got_t = marching.marching_tetrahedra(torch.from_numpy(np.asarray(vol)), iso)
    got_v, got_t = got_v.numpy(), got_t.numpy()
    assert got_v.dtype == want_v.dtype and got_t.dtype == want_t.dtype
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_t, want_t)
    if case == "corners":  # degenerate triangles were dropped
        n_all = sum(len(t) for t in jmarching._TET_TRIS.values())
        assert n_all and len(want_t) > 0


def test_save_obj_same_bytes(tmp_path):
    rng = np.random.default_rng(4)
    verts = rng.normal(size=(300, 3)) * np.array([1.0, 1e-7, 3e17])
    verts[:5] = [[0.0, -0.0, 1.0], [1e-5, 1e16, 0.1], [2.5, -3.25, 1e-4], [123456.789, 0.3, 7],
                 [np.float32(0.1), 2.0 / 3.0, -1e-300]]
    tris = rng.integers(0, 300, size=(500, 3))
    jmarching.save_obj(verts, tris, tmp_path / "jax.obj")
    marching.save_obj(verts, tris, tmp_path / "port.obj")
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()
    jmarching.save_obj(np.zeros((0, 3)), np.zeros((0, 3), np.int64), tmp_path / "e_jax.obj")
    marching.save_obj(np.zeros((0, 3)), np.zeros((0, 3), np.int64), tmp_path / "e_port.obj")
    assert (tmp_path / "e_port.obj").read_bytes() == (tmp_path / "e_jax.obj").read_bytes()


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A tiny blender-config JAX model with seeded biases, saved by the JAX
    package's save_checkpoint (an orbax directory) into a train dir."""
    train_dir = str(tmp_path_factory.mktemp("jax_train"))
    cfg = jconfig.default_config(config="nerf_sh/config/blender")
    jconfig.update_flags(cfg)
    for k, v in TINY.items():
        setattr(cfg, k, v)
    cfg.train_dir = train_dir
    model, state = jax_get_model_state(random.PRNGKey(3), cfg, restore=False)
    rng = np.random.default_rng(9)

    def bias(path, a):  # non-zero biases; sigma raised so rays are not empty
        if path[-1].key != "bias":
            return a
        b = rng.normal(size=a.shape).astype(np.float32) * 0.3
        if a.shape[0] == 1:
            b += 4.0
        return jax.numpy.asarray(b)

    state = state.replace(variables=jax.tree_util.tree_map_with_path(bias, state.variables))
    jckpt.save_checkpoint(train_dir, state, 5)
    assert os.path.isdir(os.path.join(train_dir, "checkpoint_5"))
    return cfg, model, jax.device_get(state.variables)


def test_gen_mesh_sigma_grid_and_mesh(jax_run, tmp_path):
    cfg, jmodel, variables = jax_run
    out = gen_mesh.main(MODEL + ["--train_dir", cfg.train_dir, "--reso", "18 16 17",
                                 "--c1", "-1.5", "--c2", "1.4 1.5 1.3", "--iso", "4.0",
                                 "--point_chunk", "1000"])
    # the JAX CLI's sigma grid: its axes, its points_fn, eval_points, relu
    reso = [18, 16, 17]
    c1 = np.asarray([-1.5] * 3, np.float32)
    c2 = np.asarray([1.4, 1.5, 1.3], np.float32)
    axes = [np.linspace(c1[i], c2[i], reso[i], dtype=np.float32) for i in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    points_fn = jengine.make_eval_points_fn(jmodel, raw_rgb=True, coarse=False)
    _, sigma = jengine.eval_points(lambda p, v: points_fn(variables, p, v), grid, None,
                                   chunk=1024, mesh=make_mesh(cfg.mesh_shape))
    sigma = np.maximum(sigma[..., 0], 0.0).reshape(reso)
    got = out["volume"].numpy()
    np.testing.assert_allclose(got, sigma, rtol=0, atol=ATOL)
    assert sigma.max() > 4.0 > sigma.min()  # the iso cuts the field
    # the JAX sigma through both marchers, then the JAX affine map and OBJ
    want_v, want_t = jmarching.marching_tetrahedra(sigma, 4.0)
    got_v, got_t = marching.marching_tetrahedra(torch.from_numpy(sigma), 4.0)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    # the CLI's own mesh: the port's sigma, the same map, a readable OBJ
    with open(out["path"]) as f:
        lines = f.read().splitlines()
    assert out["vertices"] > 0 and out["triangles"] > 0
    assert sum(ln.startswith("v ") for ln in lines) == out["vertices"]
    assert sum(ln.startswith("f ") for ln in lines) == out["triangles"]
    verts = np.array([[float(x) for x in ln.split()[1:]] for ln in lines if ln[0] == "v"])
    assert (verts >= c1 - 1e-6).all() and (verts <= c2 + 1e-6).all()


def test_gen_video_frame_layout_and_poses(jax_run, tmp_path):
    cfg, jmodel, variables = jax_run
    poses_path = str(tmp_path / "poses.txt")
    video_dir = gen_video.main(MODEL + ["--train_dir", cfg.train_dir, "--num_views", "3",
                                        "--width", "17", "--height", "17", "--elevation", "-25",
                                        "--up_axis", "2", "--write_poses", poses_path])
    assert video_dir == os.path.join(cfg.train_dir, "video", "e250")
    frames = sorted(os.listdir(os.path.join(video_dir, "frames")))
    assert frames == ["0000.png", "0001.png", "0002.png"]
    # the JAX CLI's poses and focal
    want_poses = np.stack([jposes.pose_spherical(a, -25.0, 4.0, 1)
                           for a in np.linspace(-180, 180, 4)[:-1]], 0)
    np.savetxt(tmp_path / "want.txt", want_poses.reshape(-1, 4))
    assert (tmp_path / "want.txt").read_text() == open(poses_path).read()
    focal = 0.5 * 17 / np.tan(0.5 * 0.7)
    jr = jrays.generate_rays(17, 17, focal, want_poses)
    render_fn = jengine.make_render_fn(jmodel, cfg, randomized=False)
    first = jax.tree_util.tree_map(lambda x: x[0], jr)
    want, _, _ = jengine.render_image(functools.partial(render_fn, variables), first,
                                      random.PRNGKey(0), chunk=256,
                                      mesh=make_mesh(cfg.mesh_shape))
    tcfg = tconfig.parse_flags(gen_video.build_parser(), MODEL + ["--train_dir", cfg.train_dir])
    model, _ = get_model_state(tcfg, restore=True)
    got, _, _ = engine.render_image(
        model, rays.Rays(*[np.asarray(x) for x in first]), chunk=256)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    png = read_png(os.path.join(video_dir, "frames", "0000.png"))
    np.testing.assert_array_equal(png, (np.clip(got, 0, 1) * 255).astype(np.uint8))


def test_timings_round_trip_both_parsers(tmp_path):
    port_log = io_utils.TimingsLog(str(tmp_path / "port.txt"))
    for s in (0, 5, 10, 0, 3):  # a restart at 0
        port_log.write(s)
    port_log.close()
    jax_log = jio.TimingsLog(str(tmp_path / "jax.txt"))
    for s in (0, 7):
        jax_log.write(s)
    jax_log._f.close()
    for path in (tmp_path / "port.txt", tmp_path / "jax.txt"):
        assert io_utils.parse_timings(path) == jio.parse_timings(path)
        assert io_utils.timings_total_hours(path) == jio.timings_total_hours(path)
    with open(tmp_path / "fixed.txt", "w") as f:
        f.write("0 2026-01-01T00:00:00\n100 2026-01-01T01:30:00\n0 2026-01-02T00:00:00\n"
                "50 2026-01-02T00:30:00\nnoise\n")
    assert io_utils.timings_total_hours(tmp_path / "fixed.txt") == 2.0
    assert jio.timings_total_hours(tmp_path / "fixed.txt") == 2.0


def test_train_cli_profile_timings_and_events(tmp_path, capsys):
    d = str(tmp_path / "run")
    train_cli.main([
        "--config", "nerf_sh/config/blender", "--dataset", "synthetic", "--train_dir", d,
        "--device", "cpu", "--batch_size", "32", "--image_batching", "--net_depth", "2",
        "--net_width", "16", "--sh_deg", "1", "--num_coarse_samples", "4",
        "--num_fine_samples", "4", "--sparsity_npoints", "50", "--synthetic_resolution", "16",
        "--chunk", "128", "--max_steps", "6", "--print_every", "2", "--save_every", "6",
        "--render_every", "3", "--profile_start_step", "2", "--profile_steps", "2",
    ])
    traces = sorted(os.listdir(os.path.join(d, "profile")))
    assert traces == ["spans_steps_2_4.json", "trace_steps_2_4.json"]
    with open(os.path.join(d, "profile", traces[1])) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert any(e.get("name") == "nerf.step" for e in events)
    with open(os.path.join(d, "profile", traces[0])) as f:
        spans = json.load(f)
    # Steps 2, 3 and 4 (step 3's render left out), each one step span over a
    # forward, a backward and an update; 32 * 4 coarse, 32 * (4 + 4) fine and
    # 50 sparsity rows over the trunk's 3 calls a step.
    assert spans["steps"] == 3 and spans["dropped"] == 0
    per = spans["per_step"]
    for name in ("nerf.step", "nerf.forward", "nerf.backward", "nerf.update", "nerf.coarse",
                 "nerf.fine", "nerf.sparsity"):
        assert per[name]["count"] == 1.0, name
    assert per["nerf.trunk"]["count"] == 3.0
    assert per["nerf.trunk"]["counts"]["rows"] == 32 * 4 + 32 * 8 + 50
    assert 0 < per["nerf.forward"]["total_ms"] < per["nerf.step"]["total_ms"]
    assert per["nerf.step"]["self_ms"] < per["nerf.step"]["total_ms"]
    steps = [s for s, _ in io_utils.parse_timings(os.path.join(d, "timings.txt"))]
    assert steps == [0, 3, 6]
    assert jio.timings_total_hours(os.path.join(d, "timings.txt")) > 0
    parse_timing.main([os.path.join(d, "timings.txt")])
    assert capsys.readouterr().out.strip().endswith("hours")
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(d))
