"""The port runs on a machine without the JAX package's dependencies: with
jax, flax, msgpack, absl, yaml, PIL and imageio blocked, the shared tree
contract (`N3Tree`, `native`) and the whole serving slice import and render
a frame on the CPU, and jax stays unimported."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "msgpack", "absl", "yaml", "PIL", "imageio"):
    sys.modules[name] = None  # any import of these now raises ImportError

import numpy as np
import plenoctree_tpu.native  # the two pieces the port shares with the JAX package
import plenoctree_tpu.octree.n3tree
import plenoctree_tpu_torch
import plenoctree_tpu_torch.cli.evaluate
import plenoctree_tpu_torch.data
import plenoctree_tpu_torch.data.datasets
import plenoctree_tpu_torch.data.poses
import plenoctree_tpu_torch.data.rays
import plenoctree_tpu_torch.data.synthetic
import plenoctree_tpu_torch.kernels._build
import plenoctree_tpu_torch.kernels.tile_composite
import plenoctree_tpu_torch.octree
import plenoctree_tpu_torch.octree.evaluate
import plenoctree_tpu_torch.octree.renderer
import plenoctree_tpu_torch.octree.tile_render
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
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax") and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


def test_slice_imports_and_renders_without_jax_stack():
    env = dict(os.environ)
    env.pop("PLENOCTREE_PLATFORM", None)  # would make plenoctree_tpu import jax
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")
