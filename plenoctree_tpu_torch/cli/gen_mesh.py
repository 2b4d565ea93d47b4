"""Extract an isosurface mesh from a trained NeRF's density field.

Port of plenoctree_tpu/cli/gen_mesh.py: the same flags
(reso, c1, c2, iso, coarse, point_chunk), a dense sigma grid over
[c1, c2], marching tetrahedra at --iso (ops/marching.py, equal to the JAX
package's numpy function bit for bit), the JAX affine map back to world
coordinates and `train_dir/mesh.obj`.

The grid axes are the JAX CLI's, built with numpy (np.linspace in float32
computes in float64 and then casts); the meshgrid is built on the device,
so the points never cross PCIe. Sigma is the raw output of the fine trunk
(the coarse one with --coarse) through octree/extract.py::make_points_fn,
--point_chunk rows per dispatch: with --use_pallas on a GPU each dispatch
is one launch of the fused trunk forward kernel (csrc/fused_mlp.cu),
which fails loudly rather than fall back. With --device cuda the
dispatches are split over every visible GPU, shaped by --mesh_shape
(engine.eval_points, --point_chunk points per device a dispatch, the
volume gathered on the first). A use_viewdirs model is queried at zero
view directions, as in extraction. Then relu, the marching on the device,
and the OBJ.

Under `python -m torch.distributed.run` (or in a process group its caller
made) each dispatch holds --point_chunk points per device of every rank:
each rank evaluates its contiguous share on its own device (the fused
kernel with --use_pallas on every rank), the shares are gathered in rank
order, every rank marches the volume, and rank 0 alone writes mesh.obj, as
the JAX CLI's process 0. Each rank ends with one line: its sigma grid's
seconds and, with the fused kernel, its launches.

Usage:
  python -m plenoctree_tpu_torch.cli.gen_mesh --config nerf_sh/config/blender \\
      --train_dir <ckpt dir> [--reso "300 300 300" --iso 6.0] --device cuda
"""

import argparse
import os
import time

import numpy as np
import torch

from plenoctree_tpu_torch import engine, parallel
from plenoctree_tpu_torch.models.nerf import get_model_state
from plenoctree_tpu_torch.octree.extract import make_points_fn
from plenoctree_tpu_torch.ops.marching import marching_tetrahedra, save_obj
from plenoctree_tpu_torch.utils import config as config_lib

SEED = 20200823  # the JAX CLI's PRNGKey seed (model init before the restore)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reso", default="300 300 300",
                        help="Marching resolution per dimension: x y z")
    parser.add_argument("--c1", default="-2 -2 -2",
                        help="Bounds lower corner x y z OR single number")
    parser.add_argument("--c2", default="2 2 2", help="Bounds upper corner x y z OR single number")
    parser.add_argument("--iso", type=float, default=6.0, help="Isosurface sigma level")
    config_lib.add_bool_flag(parser, "coarse", False, "Force the coarse network")
    parser.add_argument("--point_chunk", type=int, default=720720,
                        help="Point batch size for evaluation (--chunk ignored)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to evaluate on; 'cuda' raises when there is no GPU")
    parallel.mesh.add_dist_backend_flag(parser)
    config_lib.add_flags(parser, extra=("point_chunk",))
    return parser


def _triple(text, cast):
    vals = list(map(cast, text.split()))
    return vals * 3 if len(vals) == 1 else vals


def grid_axes(reso, c1, c2):
    """The JAX CLI's three float32 axes (numpy)."""
    return [np.linspace(c1[i], c2[i], reso[i], dtype=np.float32) for i in range(3)]


def device_grid(axes, device):
    """The [X * Y * Z, 3] meshgrid of `axes` ("ij"), built on `device`."""
    ax = [torch.from_numpy(a).to(device) for a in axes]
    return torch.stack(torch.meshgrid(*ax, indexing="ij"), dim=-1).reshape(-1, 3)


def sigma_grid(points_fn, grid, reso, chunk, devices=None):
    """relu(raw sigma) at the grid's points, chunk points per device a
    dispatch (split over `devices` where given, and over the ranks of the
    default process group), as an [X, Y, Z] f32 volume on the grid's
    device."""
    per_call = chunk * (len(devices) if devices else 1) * parallel.mesh.world()[1]
    sigma = engine.eval_points(lambda p: points_fn(p)[1][:, 0], grid, per_call,
                               devices).to(grid.device)
    sigma = torch.maximum(sigma, torch.zeros((), device=grid.device))
    return sigma.reshape(reso)


def main(argv=None, devices=None):
    """Returns {"path", "vertices", "triangles", "sigma_max", "seconds" (per
    step: grid, sigma, marching, obj; obj on rank 0 only), "volume" (the
    sigma grid)}.
    `devices` overrides the device list the dispatches are split over."""
    cfg = config_lib.parse_flags(build_parser(), argv)
    if cfg.train_dir is None:
        raise ValueError("train_dir must be set. None set now.")
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False")
    with parallel.mesh.cli_group(cfg.dist_backend, device) as (rank, world, device):
        return _mesh(cfg, parallel.cli_devices(cfg, device, devices), rank, world)


def _mesh(cfg, devices, rank, world):
    lead = rank == 0
    device = devices[0]
    kernels = cfg.use_pallas and device.type == "cuda"
    if kernels:
        from plenoctree_tpu_torch.kernels import fused_mlp

        launches0 = fused_mlp.fwd_launches
    if len(devices) == 1:
        devices = None
    say = print if lead else (lambda *a, **k: None)  # the JAX CLI's h0print

    reso = _triple(cfg.reso, int)
    c1 = np.asarray(_triple(cfg.c1, float), np.float32)
    c2 = np.asarray(_triple(cfg.c2, float), np.float32)

    say("* Creating model")
    model, state = get_model_state(cfg, seed=SEED, restore=True, device=device)
    model.eval()
    say("* Eval reso", cfg.reso, "coarse?", cfg.coarse, "step", int(state.step))
    points_fn = make_points_fn(model, device, coarse=cfg.coarse)

    seconds = {}
    t0 = time.perf_counter()
    grid = device_grid(grid_axes(reso, c1, c2), device)
    float(grid[-1, -1])  # waits for the device
    seconds["grid"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sigma = sigma_grid(points_fn, grid, reso, cfg.point_chunk, devices)
    del grid
    sigma_max = float(sigma.max())
    seconds["sigma"] = time.perf_counter() - t0

    say("* Marching tetrahedra at iso", cfg.iso)
    t0 = time.perf_counter()
    verts, tris = marching_tetrahedra(sigma, cfg.iso)
    verts, tris = verts.cpu().numpy(), tris.cpu().numpy()
    verts = c1 + verts / (np.asarray(reso) - 1) * (c2 - c1)
    seconds["marching"] = time.perf_counter() - t0
    say(f"  {len(verts)} vertices, {len(tris)} triangles")

    line = f"* rank {rank}/{world}: sigma grid {seconds['sigma']:.3f} s"
    if kernels:
        line += f", trunk launches fwd {fused_mlp.fwd_launches - launches0}"
    print(line, flush=True)
    mesh_path = os.path.join(cfg.train_dir, "mesh.obj")
    if lead:
        say(" Saving to", mesh_path)
        t0 = time.perf_counter()
        save_obj(verts, tris, mesh_path)
        seconds["obj"] = time.perf_counter() - t0
    return {"path": mesh_path, "vertices": len(verts), "triangles": len(tris),
            "sigma_max": sigma_max, "seconds": seconds, "volume": sigma}


if __name__ == "__main__":
    main()
