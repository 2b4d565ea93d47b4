"""The port runs on a machine without the JAX package or its dependencies:
with plenoctree_tpu itself and jax, flax, msgpack, absl, yaml, PIL, imageio
and tensorboardX blocked, the serving slice imports and renders a frame on
the CPU, the march renders one and the gather probes run at a tiny size,
the training slice runs train steps through its CLI with a checkpoint save
and restore, the conversion slice extracts a tree from that checkpoint and
optimizes it through their CLIs (the tile optimizer and the march), the
eval CLI evaluates it through the march, and jax stays unimported."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
for name in ("plenoctree_tpu", "jax", "jaxlib", "flax", "msgpack", "absl", "yaml", "PIL",
             "imageio", "tensorboardX"):
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
assert len(res["ns_per_row"]) == 17
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "plenoctree_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


_TRAIN_SCRIPT = r"""
import os, sys, tempfile
for name in ("plenoctree_tpu", "jax", "jaxlib", "flax", "msgpack", "absl", "yaml", "PIL",
             "imageio", "tensorboardX"):
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
