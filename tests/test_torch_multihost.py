"""Port parity on the CPU: the frame sharded by tile range (phase 1 on each
device, octree/tile_render.py) and inference across processes
(engine.render_image / eval_points over a process group, and the eval,
gen_video and gen_mesh CLIs under 2 gloo ranks, parallel/ranks.py).

The sharded frame is held bitwise to the one-device frame and within 1e-4
to the JAX renderer's (the bound of tests/test_torch_tile_render.py's
whole-frame parity), at odd sizes; phase 1 is checked to run once per
device on its own tile range. Across processes every result is held
bitwise to one process's that splits its chunks over as many devices
(['cpu'] * 2): each row is computed from the same rows, and the gather is
exact. Against one process on one device the bound is
tests/test_torch_parallel.py's 1e-6: the CPU's matmuls block their sums by
the rows they are given (on the card, chip_smoke.py holds them bitwise).
Only rank 0's train dir gains files: each rank gets a copy of the train dir
of its own, as each host of a multi-host run has its own disk (the JAX CLIs
write from process 0 only).
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from plenoctree_tpu.data.synthetic import render_synthetic_scene
from plenoctree_tpu.octree import tile_render as J
from plenoctree_tpu.octree.renderer import make_ndc_config
from plenoctree_tpu_torch import engine, parallel
from plenoctree_tpu_torch.cli import eval as eval_cli
from plenoctree_tpu_torch.cli import gen_mesh, gen_video
from plenoctree_tpu_torch.cli import train as train_cli
from plenoctree_tpu_torch.data.rays import Rays
from plenoctree_tpu_torch.data.synthetic import build_scene_tree as build_shn_tree
from plenoctree_tpu_torch.models.nerf import NerfModel
from plenoctree_tpu_torch.models.params import init_trunk_params, params_from_flax
from plenoctree_tpu_torch.octree import extract as extract_lib
from plenoctree_tpu_torch.octree import tile_render as P
from plenoctree_tpu_torch.parallel.ranks import run_ranks
from plenoctree_tpu_torch.utils import config as tconfig

from tests.test_octree import build_scene_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_C = 16
CLI_TARGET = "plenoctree_tpu_torch.parallel.ranks:cli"


# ---------------------------------------------------------------- phase 1 sharded


@pytest.fixture(scope="module")
def trees():
    return {"sh1": build_scene_tree(),
            "sh16": build_shn_tree(depth=4, basis_dim=16, sh_noise=0.05, seed=0)}


def _ff_pose(dx, dy, yaw, pitch):
    """A forward-facing camera at (dx, dy, 0) looking down -z, turned by yaw
    and pitch (tests/test_torch_tile_render.py's NDC poses)."""
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rot_x = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = (rot_y @ rot_x).astype(np.float32)
    c2w[0, 3], c2w[1, 3] = dx, dy
    return c2w


def _spy_ranges(monkeypatch):
    """Record (tiles, device) of every make_tile_inputs_fn call."""
    calls = []
    real = P.TileRenderer.make_tile_inputs_fn

    def spy(self, *args, tiles=None, device=None, **kw):
        calls.append((tiles, None if device is None else str(device)))
        return real(self, *args, tiles=tiles, device=device, **kw)

    monkeypatch.setattr(P.TileRenderer, "make_tile_inputs_fn", spy)
    return calls


@pytest.mark.parametrize("kind,name,res", [("pinhole", "sh1", 41), ("pinhole", "sh16", 33),
                                           ("ndc", "sh16", 33), ("ndc", "sh1", 41)])
def test_phase1_sharded_by_tile_range_bitwise(trees, kind, name, res, monkeypatch):
    """TileRenderer(mesh=['cpu'] * 2): phase 1 runs once per device on its
    contiguous tile range (the tile axis padded to 2: 9 tiles at 41x41 give
    5 + 4, 9 tiles at 33x33 too), the frame is bitwise the one-device frame
    (the u8 payload too), the caps grow alike, and it is within 1e-4 of the
    JAX renderer's frame (its --fast_eval path, pinhole or NDC)."""
    tree = trees[name]
    kw = dict(step_size=1e-4, grid_c=GRID_C, use_bf16=False)
    if kind == "ndc":
        focal = 40.0 * res / 32
        ndc = make_ndc_config(res, res, focal)
        kw["ndc"] = ndc
        poses = [_ff_pose(0.1, 0.0, 0.0, 0.0), _ff_pose(0.15, 0.05, 0.06, 0.02)]
    else:
        _, poses, focal = render_synthetic_scene("test", 2, res, True, 2.0, 6.0)
        focal = float(focal)
    jr = J.TileRenderer(tree, **kw)
    pkw = dict(kw, index=P.index_from_jax(jr.index))
    if kind == "ndc":
        pkw["ndc"] = dict(ndc)
    single = P.TileRenderer(tree, device="cpu", **pkw)
    sharded = P.TileRenderer(tree, mesh=parallel.make_mesh(devices=["cpu"] * 2), **pkw)
    calls = _spy_ranges(monkeypatch)
    for c2w in poses:
        a = single.render_persp(c2w, res, res, focal)
        del calls[:]
        b = sharded.render_persp(c2w, res, res, focal)
        assert calls[-2:] == [((0, 5), "cpu"), ((5, 9), "cpu")], calls
        np.testing.assert_array_equal(a, b)
        want = jr.render_persp(c2w, res, res, focal)
        assert np.abs(b - np.asarray(want)).max() <= 1e-4
        assert np.abs(b - 1.0).max() > 0.1  # the scene is in view
    assert (sharded.w1cap, sharded.ccap) == (single.w1cap, single.ccap)
    u8 = [P.TileRenderer(tree, device="cpu", output="u8", **pkw),
          P.TileRenderer(tree, mesh=parallel.make_mesh(devices=["cpu"] * 2), output="u8", **pkw)]
    for r in u8:
        r.w1cap = single.w1cap
    pay = [r.render_persp_async(poses[-1], res, res, focal) for r in u8]
    assert torch.equal(pay[0], pay[1])


def test_tile_ranges_cover_the_frame_once(trees):
    """3 devices over a 3x3-tile frame take 3 tiles each; 4 take 3, 3, 3 and
    none (the padded tiles are never computed); the ranges tile the frame."""
    r = P.TileRenderer(trees["sh1"], grid_c=8, mesh=parallel.make_mesh(devices=["cpu"] * 4))
    assert [t for *_, t in r.tile_ranges(41, 41)] == [(0, 3), (3, 6), (6, 9)]
    assert [t for *_, t in r.tile_ranges(64, 48)] == [(0, 3), (3, 6), (6, 9), (9, 12)]


# ---------------------------------------------------------------- across processes


def _params(seed, width=16):
    rng = np.random.default_rng(seed)
    tree = {name: init_trunk_params(rng, 63, 2, width, 4, 1, 12, bias_std=0.05)
            for name in ("MLP_0", "MLP_1")}
    return {k: v.numpy() for k, v in params_from_flax(tree).items()}


CFG = dict(net_depth=2, net_width=16, skip_layer=4, sh_deg=1, use_viewdirs=False,
           num_coarse_samples=8, num_fine_samples=8, dataset="synthetic")


def test_render_image_and_eval_points_across_ranks_bitwise():
    """engine.render_image (a 13x11 image at a chunk of 37 rays: every chunk
    and the 32-ray tail edge-padded to 2 ranks) and engine.eval_points (250
    points at a chunk of 100) on 2 gloo ranks, each rank its share: every
    rank gets the whole result, bitwise one process's over ['cpu'] * 2 and
    within 1e-6 of one process on one device."""
    params = _params(50)
    rng = np.random.default_rng(51)
    o = np.broadcast_to(np.array([0.0, 0.0, 4.0], np.float32), (13, 11, 3)).copy()
    d = rng.normal(size=(13, 11, 3)).astype(np.float32) * 0.2
    d[..., 2] = -1.0
    v = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pts = rng.uniform(-1.5, 1.5, (250, 3)).astype(np.float32)
    model = NerfModel(tconfig.default_config(**CFG))
    model.load_state_dict({k: torch.as_tensor(x) for k, x in params.items()})
    points_fn = extract_lib.make_points_fn(model, "cpu")
    ones = []
    for devices in (["cpu"] * 2, None):
        one = list(engine.render_image(model, Rays(o, d, v), chunk=37, devices=devices))
        rgb, sigma = engine.eval_points(points_fn, pts, 100, devices)
        ones.append(one + [rgb.numpy(), sigma.numpy()])
    ranks = run_ranks("plenoctree_tpu_torch.parallel.ranks:inference", 2,
                      dict(cfg=CFG, params=params, rays=(o, d, v), points=pts, chunk=37,
                           points_chunk=100))
    for got in ranks:
        for a, b, c in zip(ones[0], got, ones[1]):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
            np.testing.assert_allclose(b, c, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-step checkpoint of a small synthetic model, and its flags."""
    train_dir = str(tmp_path_factory.mktemp("mh") / "run")
    model = ["--config", "nerf_sh/config/blender", "--device", "cpu", "--net_depth", "2",
             "--net_width", "16", "--sh_deg", "1", "--num_coarse_samples", "4",
             "--num_fine_samples", "4"]
    data = ["--dataset", "synthetic", "--synthetic_resolution", "12"]
    train_cli.main(model + data + ["--train_dir", train_dir, "--batch_size", "32",
                                   "--max_steps", "2", "--print_every", "1", "--save_every", "2",
                                   "--render_every", "0", "--sparsity_npoints", "16"])
    return train_dir, model, data


def _files(root):
    """The files under root, an events file's host and time stamp left out."""
    out = []
    for d, _, fs in os.walk(root):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), root)
            if "events.out.tfevents" in rel:
                rel = rel[: rel.index("events.out.tfevents") + len("events.out.tfevents")]
            out.append(rel)
    return sorted(out)


def _content(root, rel):
    """A file's bytes; metrics.jsonl's records without their wall-clock "ts"
    (an events file's records carry wall times too: its name only)."""
    if rel.endswith("events.out.tfevents"):
        return None
    with open(os.path.join(root, rel), "rb") as f:
        data = f.read()
    if rel.endswith("metrics.jsonl"):
        return [{k: v for k, v in json.loads(ln).items() if k != "ts"}
                for ln in data.decode().splitlines()]
    return data


def _rank_dirs(tmp_path, train_dir, n):
    """A copy of train_dir per rank ("host"), and the files it starts with."""
    dirs = []
    for r in range(n):
        dst = tmp_path / f"rank{r}"
        shutil.copytree(train_dir, dst)
        dirs.append(str(dst))
    return dirs, _files(dirs[0])


@pytest.mark.parametrize("cli", ["eval", "gen_video", "gen_mesh"])
def test_inference_cli_across_two_ranks_writes_one_process_files(trained, cli, tmp_path):
    """Each CLI on 2 gloo ranks (run_ranks; each rank's --train_dir its own
    copy): rank 0's outputs are bitwise those of one process over ['cpu'] *
    2 (PNG bytes, psnr.txt and ssim.txt, the eval scalars, mesh.obj), and
    rank 1's train dir holds only what it started with; gen_mesh's volume is
    the same on both ranks and within 1e-6 of one process on one device."""
    train_dir, model, data = trained
    flags = {"eval": data + ["--eval_once", "--chunk", "50"],
             "gen_video": ["--num_views", "2", "--width", "9", "--height", "11", "--chunk", "40"],
             "gen_mesh": ["--reso", "9 8 7", "--c1", "-1.5", "--c2", "1.5", "--iso", "0.05",
                          "--point_chunk", "40"]}[cli]
    module = {"eval": eval_cli, "gen_video": gen_video, "gen_mesh": gen_mesh}[cli]
    one_dir = str(tmp_path / "one")
    shutil.copytree(train_dir, one_dir)
    one = module.main(model + flags + ["--train_dir", one_dir], devices=["cpu"] * 2)
    dirs, before = _rank_dirs(tmp_path, train_dir, 2)
    argv = model + flags + ["--train_dir", str(tmp_path / "rank{rank}")]
    out = run_ranks(CLI_TARGET, 2, dict(module=cli, argv=argv))
    made = sorted(set(_files(one_dir)) - set(before))
    assert made and sorted(set(_files(dirs[0])) - set(before)) == made
    assert _files(dirs[1]) == before
    for rel in made:
        assert _content(one_dir, rel) == _content(dirs[0], rel), rel
    if cli == "gen_mesh":
        assert out[0]["vertices"] == out[1]["vertices"] == one["vertices"] > 0
        np.testing.assert_array_equal(out[0]["volume"], out[1]["volume"])
        np.testing.assert_array_equal(out[0]["volume"], one["volume"].numpy())
        shutil.copytree(train_dir, tmp_path / "single")
        single = gen_mesh.main(model + flags + ["--train_dir", str(tmp_path / "single")])
        np.testing.assert_allclose(out[0]["volume"], single["volume"].numpy(), rtol=0, atol=1e-6)


def test_inference_cli_mesh_shape_covers_every_rank(trained, tmp_path):
    """Under 2 ranks --mesh_shape names the ranks' devices together: 2 runs,
    1 raises on every rank."""
    train_dir, model, _ = trained
    argv = model + ["--train_dir", train_dir, "--reso", "5", "--point_chunk", "40"]
    run_ranks(CLI_TARGET, 2, dict(module="gen_mesh", argv=argv + ["--mesh_shape", "2"]))
    with pytest.raises(RuntimeError, match="does not cover 2 devices"):
        run_ranks(CLI_TARGET, 2, dict(module="gen_mesh", argv=argv + ["--mesh_shape", "1"]))


def test_gen_mesh_under_torchrun(trained, tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2` on the CPU: the
    CLI makes torchrun's group itself (mesh.cli_group) and leaves it; each
    rank prints its closing line, and mesh.obj is the one process's, bit
    for bit."""
    train_dir, model, _ = trained
    flags = model + ["--reso", "9 8 7", "--c1", "-1.5", "--c2", "1.5", "--iso", "0.05",
                     "--point_chunk", "40"]
    shutil.copytree(train_dir, tmp_path / "one")
    shutil.copytree(train_dir, tmp_path / "ranks")
    gen_mesh.main(flags + ["--train_dir", str(tmp_path / "one")], devices=["cpu"] * 2)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(port), "-m",
           "plenoctree_tpu_torch.cli.gen_mesh", *flags, "--train_dir", str(tmp_path / "ranks")]
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert sum(ln.startswith("* rank ") for ln in res.stdout.splitlines()) == 2
    with open(tmp_path / "one" / "mesh.obj", "rb") as a, open(tmp_path / "ranks" / "mesh.obj",
                                                              "rb") as b:
        assert a.read() == b.read()


def test_train_cli_render_stays_on_rank_zero(monkeypatch):
    """The train CLI's in-train render runs on rank 0 alone, so it must not
    split over the default group: render_image is given group=None."""
    seen = []
    real = engine.render_image

    def spy(*a, **k):
        seen.append(k.get("group", engine.WORLD))
        return real(*a, **k)

    monkeypatch.setattr(engine, "render_image", spy)
    cfg = ["--config", "nerf_sh/config/blender", "--dataset", "synthetic", "--device", "cpu",
           "--net_depth", "2", "--net_width", "16", "--sh_deg", "1", "--num_coarse_samples", "4",
           "--num_fine_samples", "0", "--synthetic_resolution", "16", "--batch_size", "16",
           "--max_steps", "1", "--print_every", "1", "--save_every", "1", "--render_every", "1",
           "--sparsity_npoints", "8"]
    with tempfile.TemporaryDirectory() as d:
        train_cli.main(cfg + ["--train_dir", d])
    assert seen == [None]

