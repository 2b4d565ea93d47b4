"""Visibility-weight grid rendering for octree masking (plain PyTorch).

Port of plenoctree_tpu/octree/grid_weight.py (the equivalent of svox's
`_C.grid_weight_render`): for every training camera, march rays through
the dense sigma grid with a fixed step count, accumulate compositing
weights, and keep the per-voxel maximum weight over all rays and cameras.
The per-voxel max is a `scatter_reduce_(..., "amax")`. A max is exact and
order-free, so every ray of every camera goes through one batched march,
`chunk` rays at a time.

Rounding mirrors the JAX package on its own backends: XLA contracts
`a*b + c` into a fused multiply-add, so the two such sites here (the sample
depth and the sample position) go through `_fma`.
"""

import numpy as np
import torch

from plenoctree_tpu_torch.data.rays import generate_rays
from plenoctree_tpu_torch.kernels.tile_composite import _fma


def _march_accumulate(sigma_grid, origins, dirs, offset, invradius, reso, n_steps, weight_acc):
    """March rays [N, 3] and fold their weights into weight_acc [reso^3]
    (in place)."""
    viewdirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    o = origins * invradius + offset
    d = viewdirs * invradius
    delta_scale = 1.0 / torch.linalg.norm(d, dim=-1)
    dn = d * delta_scale[..., None]

    safe_dn = torch.where(dn.abs() < 1e-9, 1e-9, dn)
    t0 = (0.0 - o) / safe_dn
    t1 = (1.0 - o) / safe_dn
    tmin = torch.minimum(t0, t1).amax(-1).clamp(min=0.0) + 1e-6
    tmax = torch.maximum(t0, t1).amin(-1) - 1e-6
    span = (tmax - tmin).clamp(min=0.0)
    dt = span / n_steps  # per-ray step in tree units
    seen = span > 0

    light = torch.ones_like(tmin)
    for i in range(n_steps):
        t = _fma(torch.full_like(dt, i + 0.5), dt, tmin)
        pos = _fma(t[..., None], dn, o)
        idx = (pos * reso).to(torch.int32).clamp(0, reso - 1).long()
        flat = (idx[..., 0] * reso + idx[..., 1]) * reso + idx[..., 2]
        alpha = 1.0 - torch.exp(-sigma_grid[flat] * dt * delta_scale)
        w = torch.where(seen, light * alpha, 0.0)
        weight_acc.scatter_reduce_(0, flat, w, "amax")
        light = light * (1.0 - alpha)
    return weight_acc


def calculate_grid_weights(
    dataset, sigmas, reso, invradius, offset, step_factor=2, chunk=65536, device="cpu"
):
    """Max per-voxel compositing weight over all training cameras.

    Args:
      dataset: loader exposing w/h/focal/camtoworlds/size.
      sigmas: [reso^3] (or [reso, reso, reso]) density grid (relu'd).
      reso: grid resolution.
      invradius, offset: world->tree transform of the target octree.

    Returns:
      [reso, reso, reso] float32 numpy max weights.
    """
    dev = torch.device(device)
    f32 = torch.float32
    sigma_grid = torch.as_tensor(np.asarray(sigmas, np.float32).reshape(-1)).to(dev)
    weight_acc = torch.zeros(reso**3, dtype=f32, device=dev)
    offset = torch.as_tensor(np.asarray(offset, np.float32)).to(dev)
    invradius = torch.as_tensor(np.asarray(invradius, np.float32)).to(dev)
    rays = generate_rays(dataset.w, dataset.h, dataset.focal, dataset.camtoworlds[: dataset.size])
    origins = rays.origins.reshape(-1, 3)
    dirs = rays.directions.reshape(-1, 3)
    n_steps = int(step_factor * reso)
    with torch.no_grad():
        for i in range(0, origins.shape[0], chunk):
            _march_accumulate(
                sigma_grid,
                torch.as_tensor(origins[i : i + chunk], dtype=f32).to(dev),
                torch.as_tensor(dirs[i : i + chunk], dtype=f32).to(dev),
                offset, invradius, reso, n_steps, weight_acc,
            )
    return weight_acc.cpu().numpy().reshape(reso, reso, reso)
