"""The benchmark's scene: the analytic blobs baked into a depth-limited octree.

The blobs are a copy of plenoctree_tpu_torch/data/synthetic.py's constants
(the port's procedural test scene). The tree they give is the port's
`build_scene_tree` recipe: the unit tree box covers world center +
[-radius, radius] on each axis (`tree.radius` one number, or one per axis),
every cell whose region holds a finest-grid cell centre with density above
`occupied_sigma` is split down to `depth`, and only the cells at the full
depth carry data. So the cells at the full depth are exactly the finest-grid
cells whose parent (one level up) holds an occupied centre, and this module
describes the scene as a dense mask over the finest grid, independent of any
tree code:

  * `leaf_mask(depth, ...)`: [R, R, R] bool, R = 2^(depth + 1), the finest
    cells that are leaves with data ("canonical leaves", in C order of
    (x, y, z) tree coordinates);
  * `leaf_values(...)`: each canonical leaf's data row (colour coefficients
    per channel, then sigma), drawn on the device: sigma and the SH DC term
    from the scene, every other coefficient (and the SG lobes) from the seed.

Both the program's tree (benchmark/port_inputs.py) and the plain reference
(benchmark/reference/) are built from these arrays.
"""

import hashlib
import json

import numpy as np
import torch

# x, y, z, radius, r, g, b, density: plenoctree_tpu_torch/data/synthetic.py.
BLOBS = (
    (0.0, 0.0, 0.0, 0.45, 0.9, 0.2, 0.2, 40.0),
    (0.55, 0.0, 0.25, 0.28, 0.2, 0.85, 0.3, 50.0),
    (-0.5, 0.3, -0.2, 0.3, 0.25, 0.35, 0.95, 45.0),
    (0.1, -0.55, 0.4, 0.22, 0.95, 0.85, 0.2, 60.0),
)
SH_C0 = 0.28209479177387814


def sub_seed(seed, tag):
    """A 63-bit seed for one purpose (`tag`) of a run's `--seed`."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed, tag, device):
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def scene_sigma_rgb(points):
    """(sigma [...], rgb [..., 3]) of the blobs at world points [..., 3] (f32)."""
    sigma = torch.zeros(points.shape[:-1], dtype=torch.float32, device=points.device)
    acc = torch.zeros(points.shape[:-1] + (3,), dtype=torch.float32, device=points.device)
    for cx, cy, cz, rad, r, g, b, dens in BLOBS:
        c = torch.tensor([cx, cy, cz], dtype=torch.float32, device=points.device)
        d2 = ((points - c) ** 2).sum(-1)
        w = dens * torch.exp(-d2 / (2 * (rad / 2.0) ** 2))
        sigma += w
        acc += w[..., None] * torch.tensor([r, g, b], dtype=torch.float32, device=points.device)
    rgb = acc / torch.clamp(sigma[..., None], min=1e-8)
    rgb = torch.where(sigma[..., None] > 1e-6, rgb, torch.full_like(rgb, 0.5))
    return sigma, rgb


def tree_to_world(t, radius, center):
    """Tree coordinates [0, 1]^3 -> world (the port's N3Tree transform);
    `radius` is one number or one per axis."""
    scale = 2.0 * torch.as_tensor(radius, dtype=t.dtype, device=t.device)
    return (t - 0.5) * scale + torch.as_tensor(center, dtype=t.dtype, device=t.device)


def _centres(res, device, x0, x1):
    """Centres of the res^3 grid's cells in the x slab [x0, x1)."""
    a = (torch.arange(res, device=device, dtype=torch.float32) + 0.5) / res
    return torch.stack(torch.meshgrid(a[x0:x1], a, a, indexing="ij"), -1)


def leaf_mask(depth, radius, center, occupied_sigma, device):
    """(occupied, leaves): [R, R, R] bool each, the finest cells whose centre
    is occupied, and the finest cells that are data leaves (module doc)."""
    res = 2 ** (depth + 1)
    occ = torch.zeros((res, res, res), dtype=torch.bool, device=device)
    step = max(1, (1 << 22) // (res * res))
    for x in range(0, res, step):
        pts = tree_to_world(_centres(res, device, x, x + step), radius, center)
        occ[x : x + step] = scene_sigma_rgb(pts)[0] > occupied_sigma
    parent = occ.reshape(res // 2, 2, res // 2, 2, res // 2, 2).any(5).any(3).any(1)
    leaves = parent.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)
    return occ, leaves


def leaf_coords(mask):
    """[L, 3] int64 grid coordinates of the canonical leaves, C order."""
    return torch.nonzero(mask)


def leaf_values(cfg, seed, coords, res, device):
    """(data [L, D] f32, extra_data [K, 4] f32 or None) of the canonical
    leaves for a configuration's `tree` section, on `device`.

    SH: DC coefficient logit(rgb) / C0 per channel from the scene, the other
    basis functions N(0, tree.coeff_std) from the seed; SG: every amplitude
    N(0, tree.coeff_std) from the seed, lobes lambda U[0.5, 3) and unit mu
    from the seed. Sigma from the scene."""
    t = cfg["tree"]
    fmt, bd = t["format"], t["basis_dim"]
    n = coords.shape[0]
    centres = (coords.to(torch.float32) + 0.5) / res
    sigma, rgb = scene_sigma_rgb(tree_to_world(centres, t["radius"], t["center"]))
    gen = generator(seed, "coefficients", device)
    coef = torch.randn((n, 3, bd), generator=gen, device=device) * float(t["coeff_std"])
    extra = None
    if fmt == "SH":
        rgbc = rgb.clamp(1e-4, 1 - 1e-4)
        coef[:, :, 0] = torch.log(rgbc / (1 - rgbc)) / SH_C0
    elif fmt == "SG":
        g2 = generator(seed, "lobes", device)
        lam = torch.rand((bd, 1), generator=g2, device=device) * 2.5 + 0.5
        mu = torch.randn((bd, 3), generator=g2, device=device)
        mu = mu / mu.norm(dim=-1, keepdim=True)
        extra = torch.cat([lam, mu], -1)
    else:
        raise ValueError(f"unknown tree format {fmt!r}")
    data = torch.cat([coef.reshape(n, 3 * bd), sigma[:, None]], -1).contiguous()
    return data, extra


def scene_key(cfg):
    """The parameters that fix the scene's topology, as a short hash."""
    t = cfg["tree"]
    key = {"blobs": BLOBS, "depth": t["depth"], "radius": t["radius"], "center": t["center"],
           "occupied_sigma": t["occupied_sigma"], "version": 1}
    return hashlib.sha256(json.dumps(key, sort_keys=True).encode()).hexdigest()[:16]


def grid_ids(mask):
    """[R, R, R] int32: each finest cell's canonical leaf index, -1 where it
    holds no data leaf."""
    ids = torch.cumsum(mask.reshape(-1).to(torch.int64), 0) - 1
    return torch.where(mask.reshape(-1), ids, torch.full_like(ids, -1)).to(torch.int32).reshape(
        mask.shape)


def as_numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def reference_scene(cfg, seed, device, dtype):
    """The reference's view of a configuration's scene (benchmark/reference/
    octree_ref.py::Scene): the leaf map and the leaf rows, made anew from
    the seed, in `dtype`."""
    from benchmark.reference.octree_ref import Scene

    t = cfg["tree"]
    _, mask = leaf_mask(t["depth"], t["radius"], t["center"], t["occupied_sigma"], device)
    data, extra = leaf_values(cfg, seed, leaf_coords(mask), mask.shape[0], device)
    return Scene(grid_ids(mask), data.to(dtype), None if extra is None else extra.to(dtype),
                 t["format"], t["basis_dim"], t["radius"], t["center"])
