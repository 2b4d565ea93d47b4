"""Procedural analytic test scene (host numpy).

A copy of plenoctree_tpu/data/synthetic.py's scene and ground-truth
renderer: gaussian blobs of distinct colours inside the unit box, rendered
by dense quadrature of the volume rendering integral. Same constants and
same arithmetic, so both packages see identical images for a split.
"""

import functools

import numpy as np

from plenoctree_tpu_torch.data.poses import pose_spherical
from plenoctree_tpu_torch.data.rays import generate_rays

# Blob centers / radii / colors (inside [-1, 1]^3).
_BLOBS = np.array(
    [
        # x      y      z     radius   r    g    b    density
        [0.0, 0.0, 0.0, 0.45, 0.9, 0.2, 0.2, 40.0],
        [0.55, 0.0, 0.25, 0.28, 0.2, 0.85, 0.3, 50.0],
        [-0.5, 0.3, -0.2, 0.3, 0.25, 0.35, 0.95, 45.0],
        [0.1, -0.55, 0.4, 0.22, 0.95, 0.85, 0.2, 60.0],
    ],
    dtype=np.float32,
)


def scene_sigma_rgb(points, density_scale=1.0):
    """Analytic (sigma, rgb) of the test scene at [..., 3] points."""
    points = np.asarray(points, dtype=np.float32)
    sigma = np.zeros(points.shape[:-1], dtype=np.float32)
    rgb_accum = np.zeros(points.shape[:-1] + (3,), dtype=np.float32)
    for cx, cy, cz, rad, r, g, b, dens in _BLOBS:
        dens = dens * density_scale
        d2 = ((points - np.array([cx, cy, cz])) ** 2).sum(-1)
        w = dens * np.exp(-d2 / (2 * (rad / 2.0) ** 2)).astype(np.float32)
        sigma += w
        rgb_accum += w[..., None] * np.array([r, g, b], dtype=np.float32)
    rgb = rgb_accum / np.maximum(sigma[..., None], 1e-8)
    rgb = np.where(sigma[..., None] > 1e-6, rgb, 0.5)
    return sigma, rgb.astype(np.float32)


def render_rays_analytic(origins, directions, near, far, n_samples=192, white_bkgd=True,
                         density_scale=1.0):
    """Dense-quadrature volumetric render of the analytic scene."""
    t = np.linspace(near, far, n_samples, dtype=np.float32)
    pts = origins[..., None, :] + t[:, None] * directions[..., None, :]
    sigma, rgb = scene_sigma_rgb(pts, density_scale)
    dists = np.diff(t, append=t[-1] + (t[-1] - t[-2]))
    dists = dists * np.linalg.norm(directions, axis=-1, keepdims=True)
    alpha = 1.0 - np.exp(-sigma * dists)
    trans = np.cumprod(1.0 - alpha + 1e-10, axis=-1)
    trans = np.concatenate([np.ones_like(trans[..., :1]), trans[..., :-1]], axis=-1)
    weights = alpha * trans
    comp = (weights[..., None] * rgb).sum(-2)
    acc = weights.sum(-1)
    if white_bkgd:
        comp = comp + (1.0 - acc[..., None])
    return np.clip(comp, 0.0, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _render_synthetic_scene(split, n_views, resolution, white_bkgd, near, far, density_scale):
    images, camtoworlds, focal = _render_views(
        split, n_views, resolution, white_bkgd, near, far, density_scale
    )
    images.flags.writeable = False
    camtoworlds.flags.writeable = False
    return images, camtoworlds, focal


def render_synthetic_scene(split, n_views, resolution, white_bkgd, near, far,
                           density_scale=1.0):
    """Render n_views orbit cameras at `resolution`^2; returns
    (images [N,H,W,3], camtoworlds [N,4,4], focal).

    Memoized in the process on all arguments: the host quadrature takes
    tens of seconds at 200x200, and every CLI run of a process (eval,
    optimize, their checks) asks for the same views. The arrays are
    read-only; copy them to modify."""
    return _render_synthetic_scene(
        str(split), int(n_views), int(resolution), bool(white_bkgd), float(near), float(far),
        float(density_scale),
    )


def _render_views(split, n_views, resolution, white_bkgd, near, far, density_scale):
    radius = 3.2
    offset = {"train": 0.0, "val": 9.0, "test": 15.0}.get(split, 15.0)
    thetas = np.linspace(0, 360, n_views, endpoint=False) + offset
    if split == "train":
        perm = np.random.default_rng(11).permutation(n_views)
        phis = -45.0 + 37.0 * perm / max(n_views - 1, 1)
    else:
        phis = np.full(n_views, {"val": -32.0}.get(split, -40.0))
    camtoworlds = np.stack(
        [pose_spherical(th, ph, radius) for th, ph in zip(thetas, phis)], axis=0
    ).astype(np.float32)
    focal = 1.1 * resolution
    rays = generate_rays(resolution, resolution, focal, camtoworlds)
    images = render_rays_analytic(
        rays.origins.reshape(-1, 3),
        rays.directions.reshape(-1, 3),
        near,
        far,
        white_bkgd=white_bkgd,
        density_scale=density_scale,
    ).reshape(n_views, resolution, resolution, 3)
    return images, camtoworlds, focal


def build_scene_tree(depth=4, basis_dim=1, sh_noise=0.0, seed=0):
    """Bake the analytic scene into an SH octree (the recipe of
    tests/test_octree.py::build_scene_tree, generalised to SH degree > 0).

    The tree covers world [-1.2, 1.2]^3 and is refined `depth` times
    wherever the scene's density exceeds 0.05 on the finest grid. Leaves at
    the full depth get DC coefficients logit(rgb)/C0 per channel (so the
    degree-0 colour equals the scene's), the other basis_dim-1 coefficients
    per channel seeded N(0, sh_noise) noise, and the scene's sigma; coarser
    leaves stay empty.
    """
    from plenoctree_tpu_torch.octree.n3tree import N3Tree
    from plenoctree_tpu_torch.ops.sh import SH_C0

    tree = N3Tree(
        data_dim=3 * basis_dim + 1,
        depth_limit=depth,
        radius=1.2,
        center=(0.0, 0.0, 0.0),
        data_format=f"SH{basis_dim}",
        init_reserve=1000,
    )
    reso = 2 ** (depth + 1)
    arr = (np.arange(reso) + 0.5) / reso
    grid_t = np.stack(np.meshgrid(arr, arr, arr, indexing="ij"), -1).reshape(-1, 3)
    grid_w = tree.tree2world(grid_t)
    sigma, _ = scene_sigma_rgb(grid_w)
    occupied = grid_w[sigma > 0.05]
    del grid_t, grid_w, sigma
    for _ in range(depth):
        tree.refine_points(occupied)

    leaf_ind = np.nonzero(tree.depths == depth)[0]
    centers_w = tree.tree2world(tree.leaf_centers()[leaf_ind])
    sigma, rgb = scene_sigma_rgb(centers_w)
    rgbc = np.clip(rgb, 1e-4, 1 - 1e-4)
    coeff = np.zeros((leaf_ind.shape[0], 3, basis_dim), np.float32)
    coeff[:, :, 0] = np.log(rgbc / (1 - rgbc)) / SH_C0  # inverse sigmoid, deg-0 SH
    if basis_dim > 1 and sh_noise > 0:
        rng = np.random.default_rng(seed)
        coeff[:, :, 1:] = sh_noise * rng.standard_normal(
            (leaf_ind.shape[0], 3, basis_dim - 1)
        ).astype(np.float32)
    data = np.concatenate(
        [coeff.reshape(-1, 3 * basis_dim), sigma[:, None]], -1
    ).astype(np.float32)
    tree.set_leaf_data(leaf_ind, data)
    return tree
