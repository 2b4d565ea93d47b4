"""The port runs on a machine without the JAX package or its dependencies:
with plenoctree_tpu itself and jax, flax, msgpack, absl, yaml, PIL, imageio
and tensorboardX blocked, the serving slice imports and renders a frame on
the CPU, the march renders one and the gather probes run at a tiny size,
the training slice runs train steps through its CLI with a checkpoint save
and restore, the conversion slice extracts a tree from that checkpoint and
optimizes it through their CLIs (the tile optimizer and the march), the
eval CLI evaluates it through the march, and jax stays unimported; with cv2
blocked too, a blender-layout scene loads and the eval CLI writes its
frames as PNG files; an SG model trains, the NeRF eval CLI evaluates
it, it is extracted, a fleet of one SG task runs (its subprocesses under
the same block, through a sitecustomize.py) and its tree compresses; and
NSVF and LLFF fixtures are written and loaded, the eval CLI serves an LLFF
scene through the NDC tile path (--fast_eval), and a view-conditioned
model projects onto SH; and, with zstandard, tensorstore, orbax, zarr and
numcodecs blocked as well, a full-width checkpoint directory that the JAX
package's save_checkpoint wrote restores bitwise and the gen_video and
gen_mesh CLIs run on it; and the data-parallel slice
(plenoctree_tpu_torch.parallel) trains on a 2-rank gloo group whose ranks
are blocked alike, and serves a frame sharded over CPU devices."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
from PIL import Image

from plenoctree_tpu_torch.utils.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
for name in ("plenoctree_tpu", "jax", "jaxlib", "flax", "msgpack", "absl", "yaml", "PIL",
             "imageio", "cv2", "tensorboardX", "zstandard", "tensorstore", "orbax", "zarr",
             "numcodecs"):
    sys.modules[name] = None  # any import of these now raises ImportError

import numpy as np
import plenoctree_tpu_torch
import plenoctree_tpu_torch.bench_gather
import plenoctree_tpu_torch.cli.evaluate
import plenoctree_tpu_torch.cli.optimize
import plenoctree_tpu_torch.data
import plenoctree_tpu_torch.data.datasets
import plenoctree_tpu_torch.data.poses
import plenoctree_tpu_torch.data.rays
import plenoctree_tpu_torch.data.synthetic
import plenoctree_tpu_torch.kernels._build
import plenoctree_tpu_torch.kernels.gather_sum
import plenoctree_tpu_torch.kernels.tile_composite
import plenoctree_tpu_torch.native
import plenoctree_tpu_torch.octree
import plenoctree_tpu_torch.octree.evaluate
import plenoctree_tpu_torch.octree.extract
import plenoctree_tpu_torch.octree.grid_weight
import plenoctree_tpu_torch.octree.march
import plenoctree_tpu_torch.octree.n3tree
import plenoctree_tpu_torch.octree.optimize
import plenoctree_tpu_torch.octree.renderer
import plenoctree_tpu_torch.octree.tile_opt
import plenoctree_tpu_torch.octree.tile_render
import plenoctree_tpu_torch.ops.lpips
import plenoctree_tpu_torch.ops.metrics
import plenoctree_tpu_torch.ops.sh
import plenoctree_tpu_torch.utils.config
from plenoctree_tpu_torch.data.poses import orbit_pose
from plenoctree_tpu_torch.data.synthetic import build_scene_tree
from plenoctree_tpu_torch.octree.tile_render import TileRenderer

cfg = plenoctree_tpu_torch.utils.config.default_config()
plenoctree_tpu_torch.utils.config.update_flags(
    plenoctree_tpu_torch.utils.config.default_config(config="nerf_sh/config/blender")
)
tree = build_scene_tree(depth=3)
img = TileRenderer(tree, grid_c=16, device="cpu").render_persp(orbit_pose(0.3), 16, 16, 17.6)
assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.min() < 0.99
from plenoctree_tpu_torch.octree.renderer import VolumeRenderer
img = VolumeRenderer(tree, device="cpu").render_persp(orbit_pose(0.3), 15, 15, 16.5)
assert img.shape == (15, 15, 3) and np.isfinite(img).all() and img.min() < 0.99
res = plenoctree_tpu_torch.bench_gather.run(40000, 1024, 8, 16, device="cpu")
assert len(res["ns_per_row"]) == 19
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "plenoctree_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


_TRAIN_SCRIPT = r"""
import os, sys, tempfile
for name in ("plenoctree_tpu", "jax", "jaxlib", "flax", "msgpack", "absl", "yaml", "PIL",
             "imageio", "cv2", "tensorboardX", "zstandard", "tensorstore", "orbax", "zarr",
             "numcodecs"):
    sys.modules[name] = None  # any import of these now raises ImportError

import torch
import plenoctree_tpu_torch.bench
import plenoctree_tpu_torch.cli.train as train_cli
import plenoctree_tpu_torch.engine
import plenoctree_tpu_torch.kernels.fused_mlp
import plenoctree_tpu_torch.models.mlp
import plenoctree_tpu_torch.models.nerf
import plenoctree_tpu_torch.models.params
import plenoctree_tpu_torch.ops.posenc
import plenoctree_tpu_torch.ops.rendering
import plenoctree_tpu_torch.ops.sampling
import plenoctree_tpu_torch.utils.checkpoints as ckpt
import plenoctree_tpu_torch.utils.lr
import plenoctree_tpu_torch.utils.metrics_writer as mw
import plenoctree_tpu_torch.utils.msgpack_lite

d = tempfile.mkdtemp()
flags = [
    "--config", "nerf_sh/config/blender", "--dataset", "synthetic", "--train_dir", d,
    "--device", "cpu", "--use_pallas", "--compute_dtype", "bfloat16", "--image_batching",
    "--batch_size", "32", "--net_depth", "2", "--net_width", "16", "--sh_deg", "1",
    "--num_coarse_samples", "4", "--num_fine_samples", "4", "--sparsity_npoints", "50",
    "--synthetic_resolution", "16", "--print_every", "1", "--render_every", "2",
    "--chunk", "64",
]
model, state = train_cli.main(flags + ["--max_steps", "2", "--save_every", "2"])
assert state.step == 2 and os.path.exists(os.path.join(d, "checkpoint_2"))
assert len(mw.read_scalars(d, "train_psnr")) == 2 and os.listdir(os.path.join(d, "render"))
model2, state2 = train_cli.main(flags + ["--max_steps", "3", "--save_every", "3"])
assert state2.step == 3 and os.path.exists(os.path.join(d, "checkpoint_3"))
restored = ckpt.restore_checkpoint(d, ckpt.create_train_state(model))
assert restored.step == 3 and restored.opt_state["count"] == 3
assert all(torch.equal(p, model2.state_dict()[k]) for k, p in model.state_dict().items())

import plenoctree_tpu_torch.cli.extract as extract_cli
import plenoctree_tpu_torch.cli.optimize as optimize_cli
from plenoctree_tpu_torch.octree import N3Tree

model_flags = flags[:2] + ["--dataset", "synthetic", "--device", "cpu", "--net_depth", "2",
                           "--net_width", "16", "--sh_deg", "1", "--num_coarse_samples", "4",
                           "--num_fine_samples", "4", "--synthetic_resolution", "16"]
tree_path, opt_path = os.path.join(d, "tree.npz"), os.path.join(d, "tree_opt.npz")
tree = extract_cli.main(model_flags + [
    "--train_dir", d, "--output", tree_path, "--init_grid_depth", "3", "--samples_per_cell", "2",
    "--masking_mode", "sigma", "--alpha_thresh", "0.0", "--noeval",
])
assert tree.n_leaves > 0 and N3Tree.load(tree_path).n_leaves == tree.n_leaves
optimize_cli.main(model_flags + [
    "--input", tree_path, "--output", opt_path, "--tile_opt", "--num_epochs", "1",
    "--tile_grid_c", "8", "--lr", "1e2", "--nosave",
])
optimize_cli.main(model_flags + [
    "--input", tree_path, "--output", opt_path, "--num_epochs", "1", "--lr", "1e2", "--nosave",
])
import plenoctree_tpu_torch.cli.evaluate as eval_cli
psnr, ssim, lpips = eval_cli.main(model_flags + ["--input", tree_path])
assert psnr == psnr and ssim == ssim and lpips != lpips  # finite, finite, NaN
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "plenoctree_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


def _run_blocked(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")


def test_slice_imports_and_renders_without_jax_stack():
    _run_blocked(_SCRIPT)


def test_training_slice_trains_without_jax_stack():
    """Also runs the conversion CLIs (extract, optimize --tile_opt) on the
    checkpoint the training run wrote."""
    _run_blocked(_TRAIN_SCRIPT)


_BLENDER_SCRIPT = r"""
import sys
for name in ("plenoctree_tpu", "jax", "jaxlib", "flax", "msgpack", "absl", "yaml", "PIL",
             "imageio", "cv2", "tensorboardX", "zstandard", "tensorstore", "orbax", "zarr",
             "numcodecs"):
    sys.modules[name] = None  # any import of these now raises ImportError

import numpy as np
from plenoctree_tpu_torch.cli import evaluate as eval_cli
from plenoctree_tpu_torch.data import get_dataset
from plenoctree_tpu_torch.utils import config as config_lib
from plenoctree_tpu_torch.utils.png import read_png

scene, out = sys.argv[1], sys.argv[2]
want = np.load(scene + "/want.npz")
for split, factor in (("test", 0), ("train", 2)):
    args = config_lib.default_config(config="nerf_sh/config/blender", dataset="blender",
                                     data_dir=scene, factor=factor, image_batching=False)
    ds = get_dataset(split, args)
    got = ds.images.reshape(want[split].shape)
    assert got.dtype == np.float32, got.dtype
    tol = 0.0 if factor == 0 else 1e-6
    assert float(np.abs(got - want[split]).max()) <= tol, float(np.abs(got - want[split]).max())
eval_cli.main(["--input", scene + "/tree.npz", "--config", "nerf_sh/config/blender",
               "--dataset", "blender", "--data_dir", scene, "--fast_eval", "--device", "cpu",
               "--write_images", out])
frames = [read_png(f"{out}/{i:03d}.png") for i in range(2)]
assert all(f.shape == (16, 16, 3) for f in frames)
try:
    eval_cli.main(["--input", scene + "/tree.npz", "--config", "nerf_sh/config/blender",
                   "--dataset", "blender", "--data_dir", scene, "--fast_eval", "--device", "cpu",
                   "--write_vid", out + "/v.mp4"])
    raise AssertionError("--write_vid without imageio did not raise")
except RuntimeError as e:
    assert "--write_images" in str(e), e
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "cv2", "imageio")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


def test_blender_scene_loads_and_evaluates_without_pil(tmp_path):
    """A blender-layout scene (transforms_{train,test}.json + RGBA PNGs that
    PIL writes) through get_dataset, and the eval CLI writing its frames,
    with PIL, imageio and cv2 blocked: pixels equal PIL's (cv2's
    INTER_AREA for --factor 2)."""
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.data.synthetic import build_scene_tree

    scene = tmp_path / "scene"
    want = {}
    for split, n, res in (("train", 3, 18), ("test", 2, 16)):
        (scene / split).mkdir(parents=True)
        frames, images = [], []
        for i in range(n):
            img = np.random.default_rng(10 * i + res).integers(0, 256, (res, res, 4), np.uint8)
            Image.fromarray(img, "RGBA").save(scene / split / f"r_{i}.png")
            rgba = np.array(Image.open(scene / split / f"r_{i}.png"), dtype=np.float32) / 255.0
            if split == "train":
                rgba = cv2.resize(rgba, (res // 2, res // 2), interpolation=cv2.INTER_AREA)
            images.append(rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:]))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": orbit_pose(0.5 + i).tolist()})
        with open(scene / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
        want[split] = np.stack(images)
    np.savez(scene / "want.npz", **want)
    build_scene_tree(depth=3).save(str(scene / "tree.npz"))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", _BLENDER_SCRIPT, str(scene), str(tmp_path / "out")], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")
    for i in range(2):
        np.testing.assert_array_equal(
            np.array(Image.open(tmp_path / "out" / f"{i:03d}.png")),
            read_png(tmp_path / "out" / f"{i:03d}.png"))


_BLOCK = """import sys
for name in ("plenoctree_tpu", "jax", "jaxlib", "flax", "msgpack", "absl", "yaml", "PIL",
             "imageio", "cv2", "tensorboardX", "zstandard", "tensorstore", "orbax", "zarr",
             "numcodecs"):
    sys.modules[name] = None  # any import of these now raises ImportError
"""

_SG_SCRIPT = r"""
import json, os, sys
assert sys.modules["jax"] is None  # the sitecustomize block is in force
import numpy as np
from plenoctree_tpu_torch.cli import compress as compress_cli
from plenoctree_tpu_torch.cli import eval as nerf_eval_cli
from plenoctree_tpu_torch.cli import extract as extract_cli
from plenoctree_tpu_torch.cli import task_manager
from plenoctree_tpu_torch.cli import train as train_cli
from plenoctree_tpu_torch.data.synthetic import write_blender_dataset
from plenoctree_tpu_torch.octree import N3Tree
from plenoctree_tpu_torch.utils.png import read_png

root = sys.argv[1]
scene = write_blender_dataset(root + "/data/scene", n_train=3, n_test=1, resolution=16)
d = root + "/ckpt/sg"
model = ["--config", "nerf_sh/config/misc/sg", "--sg_dim", "4", "--device", "cpu",
         "--net_depth", "2", "--net_width", "16", "--num_coarse_samples", "4",
         "--num_fine_samples", "4", "--chunk", "512", "--data_dir", scene, "--train_dir", d]
_, state = train_cli.main(model + ["--use_pallas", "--compute_dtype", "bfloat16",
                                   "--batch_size", "32", "--max_steps", "2", "--save_every", "2",
                                   "--render_every", "0", "--sparsity_npoints", "50"])
assert state.step == 2 and state.params["sg_mu_spher"].shape == (4, 2)
psnr, ssim = nerf_eval_cli.main(model)
assert psnr == psnr and ssim == ssim and read_png(d + "/test_preds/disp_000.png").shape == (16, 16, 1)
tree = extract_cli.main(model + ["--output", d + "/tree.npz", "--init_grid_depth", "3",
                                 "--samples_per_cell", "2", "--noeval"])
assert repr(tree.data_format) == "SG4" and N3Tree.load(d + "/tree.npz").extra_data.shape == (4, 4)
with open(root + "/tasks.json", "w") as f:
    json.dump({"data_root": root + "/data", "train_root": root + "/ckpt", "tasks": [{
        "train_dir": "sg", "data_dir": "scene", "config": "nerf_sh/config/misc/sg",
        "extr_flags": model[2:-4] + ["--init_grid_depth", "3", "--samples_per_cell", "2"],
        "opt_flags": model[2:-4] + ["--num_epochs", "1", "--sgd", "--lr", "1e9"],
        "eval_flags": model[2:-4]}]}, f)
task_manager.main([root + "/tasks.json", "--gpus", "0"])
with open(root + "/results.txt") as f:
    res = json.loads(f.read())
assert "error" not in res and res["raw_psnr"] == res["raw_psnr"], res
compress_cli.main([d + "/octrees/tree.npz", "--out_dir", root + "/min", "--bits", "6"])
qc = np.load(root + "/min/tree.npz")["quant_colors"]
assert qc.shape[0] == 4 and 0 < qc.shape[1] <= 64, qc.shape
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "plenoctree_tpu", "PIL")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


def test_sg_eval_fleet_and_compression_without_jax_stack(tmp_path):
    """SG training (through the fused trunk's plain version), the NeRF eval
    CLI, SG extraction and compression in one process, and the fleet's
    extract / optimize / evaluate subprocesses, all with the JAX stack,
    PIL, imageio and cv2 blocked by a sitecustomize.py on PYTHONPATH."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCK)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(site), REPO, env.get("PYTHONPATH", "")])
    res = subprocess.run(
        [sys.executable, "-c", _SG_SCRIPT, str(tmp_path / "run")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert res.stdout.strip().endswith("OK")


_CAPTURES_SCRIPT = r"""
import sys
for name in ("plenoctree_tpu", "jax", "jaxlib", "flax", "msgpack", "absl", "yaml", "PIL",
             "imageio", "cv2", "tensorboardX", "zstandard", "tensorstore", "orbax", "zarr",
             "numcodecs"):
    sys.modules[name] = None  # any import of these now raises ImportError

import numpy as np
from plenoctree_tpu_torch.cli import evaluate as eval_cli
from plenoctree_tpu_torch.data import get_dataset
from plenoctree_tpu_torch.data.synthetic import (build_scene_tree, write_llff_dataset,
                                                 write_nsvf_dataset)
from plenoctree_tpu_torch.kernels import tile_composite
from plenoctree_tpu_torch.models.nerf import construct_nerf
from plenoctree_tpu_torch.octree import extract
from plenoctree_tpu_torch.utils import config as config_lib

root = sys.argv[1]
nsvf = write_nsvf_dataset(root + "/nsvf", n_train=3, n_test=2, resolution=16)
args = config_lib.default_config(config="nerf_sh/config/tt")
config_lib.update_flags(args)
args.data_dir, args.factor = nsvf, 2
ds = get_dataset("train", args)
assert ds.images.shape == (3, 64, 3) and ds.bbox.shape == (7,), (ds.images.shape, ds.bbox)
assert abs(ds.focal - 1.1 * 16 / 2) < 1e-9, ds.focal
llff = write_llff_dataset(root + "/llff", n_views=6, resolution=16)
with open(root + "/llff_tiny.yaml", "w") as f:
    f.write("dataset: llff\nllffhold: 3\nfactor: 0\nwhite_bkgd: false\n")
for spherify in (False, True):
    args = config_lib.default_config(config=root + "/llff_tiny")
    config_lib.update_flags(args)
    args.data_dir, args.spherify, args.render_path = llff, spherify, True
    case = next(get_dataset("test", args))
    assert "pixels" not in case and case["rays"].origins.shape == (16, 16, 3)
build_scene_tree(depth=3).save(root + "/tree.npz")
tile_composite.launches = 0
psnr, ssim, _ = eval_cli.main(["--input", root + "/tree.npz", "--config", root + "/llff_tiny",
                               "--data_dir", llff, "--fast_eval", "--device", "cpu"])
assert np.isfinite(psnr) and np.isfinite(ssim) and tile_composite.launches == 0  # plain on CPU
cfg = config_lib.default_config(config="nerf_sh/config/misc/proj")
config_lib.update_flags(cfg)
cfg.net_depth, cfg.net_width, cfg.net_width_condition = 2, 16, 8
model = construct_nerf(cfg, seed=0)
cross = extract.make_cross_fn(model, "cpu")
coeffs, sigma = extract.project_nerf_to_sh(cross, cfg.sh_deg, np.zeros((2, 3), np.float32), 64,
                                           np.random.default_rng(0))
assert tuple(coeffs.shape) == (2, 75) and tuple(sigma.shape) == (2, 1)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "plenoctree_tpu",
                "PIL", "cv2", "imageio") and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


def test_nsvf_llff_and_ndc_serving_without_jax_stack(tmp_path):
    """NSVF and LLFF fixtures written (utils/png.py) and loaded (NDC,
    spherify, the render path), an LLFF scene evaluated by the eval CLI
    through the NDC tile path (--fast_eval, a config with llff in its
    path), and SH projection of a proj.yaml model, with the JAX stack, PIL,
    imageio and cv2 blocked."""
    _run_blocked_args(_CAPTURES_SCRIPT, str(tmp_path))


def _run_blocked_args(script, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", script, *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert res.stdout.strip().endswith("OK")


_JAX_CKPT_SCRIPT = r"""
import sys
for name in ("plenoctree_tpu", "jax", "jaxlib", "flax", "msgpack", "absl", "yaml", "PIL",
             "imageio", "cv2", "tensorboardX", "zstandard", "tensorstore", "orbax", "zarr",
             "numcodecs"):
    sys.modules[name] = None  # any import of these now raises ImportError

import os
import numpy as np
from plenoctree_tpu_torch.cli import gen_mesh, gen_video
from plenoctree_tpu_torch.models.nerf import get_model_state
from plenoctree_tpu_torch.utils import config as config_lib
from plenoctree_tpu_torch.utils.png import read_png

train_dir = sys.argv[1]
want = np.load(train_dir + "/want.npz")
cfg = config_lib.default_config(config="nerf_sh/config/blender", train_dir=train_dir)
config_lib.update_flags(cfg)
model, state = get_model_state(cfg, restore=True)
assert state.step == int(want["step"]) and state.opt_state["count"] == int(want["count"])
for group, tensors in (("params", state.params), ("mu", state.opt_state["mu"]),
                       ("nu", state.opt_state["nu"])):
    for k, t in tensors.items():
        assert np.array_equal(t.detach().numpy(), want[group + "/" + k]), (group, k)
flags = ["--config", "nerf_sh/config/blender", "--train_dir", train_dir, "--device", "cpu",
         "--chunk", "1024"]
video_dir = gen_video.main(flags + ["--num_views", "2", "--width", "9", "--height", "9"])
assert read_png(video_dir + "/frames/0001.png").shape == (9, 9, 3)
out = gen_mesh.main(flags + ["--reso", "12", "--iso", "0.0", "--point_chunk", "500"])
assert os.path.getsize(out["path"]) > 0 and out["vertices"] > 0, out
leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "flax", "plenoctree_tpu", "zstandard", "tensorstore", "orbax", "zarr", "numcodecs",
    "imageio") and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


def test_jax_checkpoint_directory_restores_without_jax_stack(tmp_path):
    """The JAX package's save_checkpoint (an orbax OCDBT directory, zstd
    inside) of a full-width blender SH16 TrainState with non-zero Adam
    moments; a process with the JAX stack, orbax, tensorstore, zstandard,
    zarr, numcodecs and imageio blocked restores it bitwise (params, mu, nu,
    count, step), then renders an orbit through gen_video and meshes it
    through gen_mesh on the CPU."""
    import jax
    from jax import random

    from plenoctree_tpu.models import get_model_state as jax_get_model_state
    from plenoctree_tpu.utils import checkpoints as jckpt
    from plenoctree_tpu.utils import config as jconfig
    from plenoctree_tpu_torch.models.params import params_from_flax

    cfg = jconfig.default_config(config=os.path.join(REPO, "nerf_sh/config/blender"))
    jconfig.update_flags(cfg)
    _, state = jax_get_model_state(random.PRNGKey(1), cfg, restore=False)
    rng = np.random.default_rng(2)
    adam = state.opt_state[0]
    draw = lambda t, s: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.abs(rng.normal(size=a.shape)).astype(np.float32) * s, t)
    adam = adam._replace(count=np.int32(17), mu=draw(adam.mu, 1e-3), nu=draw(adam.nu, 1e-6))
    state = state.replace(step=17, opt_state=(adam,) + tuple(state.opt_state[1:]))
    jckpt.save_checkpoint(str(tmp_path), state, 17)
    assert os.path.isdir(tmp_path / "checkpoint_17")
    want = {"step": 17, "count": 17}
    for group, tree in (("params", state.variables["params"]), ("mu", adam.mu),
                        ("nu", adam.nu)):
        for k, t in params_from_flax(jax.tree_util.tree_map(np.asarray, tree)).items():
            want[f"{group}/{k}"] = t.numpy()
    np.savez(tmp_path / "want.npz", **want)
    _run_blocked_args(_JAX_CKPT_SCRIPT, str(tmp_path))


_PARALLEL_SCRIPT = r"""
import sys
assert sys.modules["jax"] is None  # the sitecustomize block is in force
import numpy as np
import plenoctree_tpu_torch.parallel
import plenoctree_tpu_torch.parallel.mesh
import plenoctree_tpu_torch.parallel.partition
from plenoctree_tpu_torch import engine
from plenoctree_tpu_torch.data.rays import Rays
from plenoctree_tpu_torch.data.synthetic import build_scene_tree, render_synthetic_scene
from plenoctree_tpu_torch.models.nerf import construct_nerf
from plenoctree_tpu_torch.octree.tile_render import TileRenderer
from plenoctree_tpu_torch.parallel import make_mesh
from plenoctree_tpu_torch.parallel.ranks import run_ranks, train_steps
from plenoctree_tpu_torch.utils import config as config_lib

cfg = dict(net_depth=2, net_width=16, sh_deg=1, use_viewdirs=False, num_coarse_samples=4,
           num_fine_samples=4, batch_size=32, sparsity_npoints=16, randomized=False,
           dataset="synthetic", use_pallas=True, compute_dtype="bfloat16")
params = {k: v.numpy() for k, v in construct_nerf(config_lib.default_config(**cfg)).state_dict().items()}
rng = np.random.default_rng(0)
d = rng.normal(size=(32, 3)).astype(np.float32)
batch = {"pixels": rng.uniform(size=(32, 3)).astype(np.float32),
         "rays": Rays(np.tile(np.float32([0, 0, 4]), (32, 1)), d,
                      d / np.linalg.norm(d, axis=-1, keepdims=True))}
draws = [{"sp_points": rng.uniform(-1, 1, (16, 3)).astype(np.float32)}]
kw = dict(cfg=cfg, params=params, batches=[batch], draws=draws)
two = run_ranks("plenoctree_tpu_torch.parallel.ranks:train_steps", 2, kw, timeout=120)
one = train_steps(0, 1, **kw)
tp = run_ranks("plenoctree_tpu_torch.parallel.ranks:train_steps", 2, dict(kw, mesh_shape="1,2"),
               timeout=120)
for k, p in one["params"][-1].items():
    assert np.array_equal(two[0]["params"][-1][k], two[1]["params"][-1][k]), k
    assert np.abs(two[0]["params"][-1][k] - p).max() <= 1e-5, k
    assert np.array_equal(tp[0]["params"][-1][k], tp[1]["params"][-1][k]), k
    assert np.abs(tp[0]["params"][-1][k] - p).max() <= 1e-5, k
o = np.tile(np.float32([0, 0, 4]), (5, 7, 1))
dirs = rng.normal(size=(5, 7, 3)).astype(np.float32)
rays = (o, dirs, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
inf = run_ranks("plenoctree_tpu_torch.parallel.ranks:inference", 2,
                dict(cfg=cfg, params=params, rays=rays, points=pts, chunk=16, points_chunk=20))
assert all(np.array_equal(a, b) for a, b in zip(inf[0], inf[1]))
model = construct_nerf(config_lib.default_config(**cfg))
split = engine.render_image(model, Rays(*rays), chunk=16, devices=["cpu"] * 2)
assert all(np.array_equal(a, b) for a, b in zip(split, inf[0]))
tree = build_scene_tree(3, 1, 0.0, 0)
_, c2ws, focal = render_synthetic_scene("test", 1, 24, True, 2.0, 6.0)
a = TileRenderer(tree, device="cpu").render_persp(c2ws[0], 24, 24, focal)
b = TileRenderer(tree, mesh=make_mesh(devices=["cpu"] * 3)).render_persp(c2ws[0], 24, 24, focal)
assert np.array_equal(a, b)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "plenoctree_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


def test_parallel_slice_runs_without_jax_stack(tmp_path):
    """plenoctree_tpu_torch.parallel imports, a 2-rank gloo train step (its
    ranks' processes under the same block, through a sitecustomize.py) and
    a 1 x 2 tensor-parallel one match the one-process step, render_image
    across 2 ranks equals one process split over two devices, and a frame
    sharded over three CPU devices equals the one-device frame, with the
    JAX stack blocked."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCK)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(site), REPO, env.get("PYTHONPATH", "")])
    res = subprocess.run(
        [sys.executable, "-c", _PARALLEL_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert res.stdout.strip().endswith("OK")
