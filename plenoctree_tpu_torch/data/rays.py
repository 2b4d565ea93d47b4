"""Camera ray generation, the NDC conversion and the equirectangular maps
(host numpy).

A copy of plenoctree_tpu/data/rays.py with its own `Rays` type: the JAX
package's `data` package imports flax on the way in (`types.py`), which the
port must not need.
"""

import collections

import numpy as np

Rays = collections.namedtuple("Rays", ("origins", "directions", "viewdirs"))


def namedtuple_map(fn, tup):
    """Apply `fn` to each element of a namedtuple."""
    return type(tup)(*map(fn, tup))


def generate_rays(w, h, focal, camtoworlds, equirect=False):
    """Generate per-pixel camera rays.

    Args:
      w, h: image size.
      focal: focal length in pixels.
      camtoworlds: [B, 4, 4] (or [B, 3, 4]) camera-to-world poses.
      equirect: spherical (equirectangular) rays instead of pinhole.

    Returns:
      Rays of [B, h, w, 3] origins / directions / unit viewdirs.
    """
    x, y = np.meshgrid(
        np.arange(w, dtype=np.float32),
        np.arange(h, dtype=np.float32),
        indexing="xy",
    )
    if equirect:
        uv = np.stack([x * (2.0 / w) - 1.0, y * (2.0 / h) - 1.0], axis=-1)
        camera_dirs = equirect2xyz(uv)
    else:
        camera_dirs = np.stack(
            [(x - w * 0.5) / focal, -(y - h * 0.5) / focal, -np.ones_like(x)],
            axis=-1,
        )
    c2w = camtoworlds[:, None, None, :3, :3]
    directions = np.matmul(c2w, camera_dirs[None, ..., None])[..., 0]
    origins = np.broadcast_to(camtoworlds[:, None, None, :3, -1], directions.shape)
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    return Rays(
        origins=np.ascontiguousarray(origins.astype(np.float32)),
        directions=np.ascontiguousarray(directions.astype(np.float32)),
        viewdirs=np.ascontiguousarray(viewdirs.astype(np.float32)),
    )


def convert_to_ndc(origins, directions, focal, w, h, near=1.0):
    """Shift rays to the near plane and project into NDC (LLFF forward-facing)."""
    t = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions

    dx, dy, dz = np.moveaxis(directions, -1, 0)
    ox, oy, oz = np.moveaxis(origins, -1, 0)

    o0 = -((2 * focal) / w) * (ox / oz)
    o1 = -((2 * focal) / h) * (oy / oz)
    o2 = 1 + 2 * near / oz
    d0 = -((2 * focal) / w) * (dx / dz - ox / oz)
    d1 = -((2 * focal) / h) * (dy / dz - oy / oz)
    d2 = -2 * near / oz

    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)


def equirect2xyz(uv):
    """Equirectangular image coords in [-1, 1] -> unit vectors."""
    lon = uv[..., 0] * np.pi
    lat = uv[..., 1] * (np.pi * 0.5)
    coslat = np.cos(lat)
    return np.stack(
        [coslat * np.sin(lon), np.sin(lat), coslat * np.cos(lon)], axis=-1
    )


def xyz2equirect(xyz):
    """Unit vectors -> equirectangular coords in [-1, 1]."""
    lat = np.arcsin(np.clip(xyz[..., 1], -1.0, 1.0))
    lon = np.arctan2(xyz[..., 0], xyz[..., 2])
    return np.stack([lon / np.pi, 2.0 * lat / np.pi], axis=-1)
