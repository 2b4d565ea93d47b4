"""Procedural analytic test scene (host numpy).

A copy of plenoctree_tpu/data/synthetic.py's scene and ground-truth
renderer: gaussian blobs of distinct colours inside the unit box, rendered
by dense quadrature of the volume rendering integral. Same constants and
same arithmetic, so both packages see identical images for a split.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

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


# Rays per task of the host quadrature: the views render on threads (numpy's
# large elementwise ops release the GIL), in blocks that stay in cache.
_RAYS_PER_TASK = 8192


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
    origins = rays.origins.reshape(-1, 3)
    directions = rays.directions.reshape(-1, 3)

    def render(i):  # rays are independent: any split gives the same pixels
        sl = slice(i, i + _RAYS_PER_TASK)
        return render_rays_analytic(origins[sl], directions[sl], near, far,
                                    white_bkgd=white_bkgd, density_scale=density_scale)

    starts = range(0, origins.shape[0], _RAYS_PER_TASK)
    with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as pool:
        parts = list(pool.map(render, starts))
    images = np.concatenate(parts).reshape(n_views, resolution, resolution, 3)
    return images, camtoworlds, focal


def write_blender_dataset(out_dir, n_train=12, n_test=4, resolution=64, white_bkgd=True,
                          density_scale=1.0):
    """The synthetic scene as an on-disk blender-format dataset
    (transforms_{train,test,val}.json + 8-bit RGB PNGs written by
    utils/png.py), as plenoctree_tpu/data/synthetic.py::write_blender_dataset
    writes it; returns out_dir."""
    import json
    import os

    from plenoctree_tpu_torch.utils.png import write_png

    camera_angle_x = 2.0 * np.arctan(0.5 * resolution / (1.1 * resolution))
    for split, n in (("train", n_train), ("test", n_test), ("val", n_test)):
        images, c2ws, _ = render_synthetic_scene(
            split, n, resolution, white_bkgd, near=2.0, far=6.0, density_scale=density_scale,
        )
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        frames = []
        for i in range(n):
            rel = f"./{split}/r_{i}"
            write_png(os.path.join(out_dir, f"{rel}.png"), (images[i] * 255).astype(np.uint8))
            frames.append({"file_path": rel, "transform_matrix": c2ws[i].tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": float(camera_angle_x), "frames": frames}, f)
    return out_dir


def write_nsvf_dataset(out_dir, n_train=8, n_test=3, resolution=48, white_bkgd=True):
    """The synthetic scene in NSVF layout (intrinsics.txt, pose/, rgb/ as
    8-bit RGB PNGs written by utils/png.py, bbox.txt), as
    plenoctree_tpu/data/synthetic.py::write_nsvf_dataset writes it: train
    views prefixed 0_, test views 1_ (the loader's test split falls back to
    them); returns out_dir."""
    import os

    from plenoctree_tpu_torch.utils.png import write_png

    os.makedirs(os.path.join(out_dir, "pose"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    focal = 1.1 * resolution
    K = np.eye(4)
    K[0, 0] = K[1, 1] = focal
    K[0, 2] = K[1, 2] = resolution / 2
    np.savetxt(os.path.join(out_dir, "intrinsics.txt"), K)
    # Scene bbox: the blobs live within ~[-0.9, 0.9].
    np.savetxt(
        os.path.join(out_dir, "bbox.txt"),
        np.array([[-1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 0.01]]),
    )
    cam_trans = np.diag(np.array([1, -1, -1, 1], dtype=np.float32))
    for split, prefix, n in (("train", "0", n_train), ("test", "1", n_test)):
        images, c2ws, _ = render_synthetic_scene(
            split, n, resolution, white_bkgd, near=2.0, far=6.0
        )
        for i in range(n):
            name = f"{prefix}_{i:04d}"
            write_png(os.path.join(out_dir, "rgb", name + ".png"),
                      (images[i] * 255).astype(np.uint8))
            # The loader right-multiplies by cam_trans (its own inverse).
            np.savetxt(os.path.join(out_dir, "pose", name + ".txt"), c2ws[i] @ cam_trans)
    return out_dir


def write_llff_dataset(out_dir, n_views=10, resolution=32):
    """A forward-facing capture of the synthetic scene in LLFF layout
    (images/ as 8-bit RGB PNGs written by utils/png.py, poses_bounds.npy),
    as plenoctree_tpu/data/synthetic.py::write_llff_dataset writes it:
    cameras look down -z from z ~ 4 with seeded lateral offsets and slightly
    jittered axes (spherify's closest-point solve needs them not all
    parallel); returns out_dir."""
    import os

    from plenoctree_tpu_torch.data.poses import viewmatrix
    from plenoctree_tpu_torch.utils.png import write_png

    imgdir = os.path.join(out_dir, "images")
    os.makedirs(imgdir, exist_ok=True)
    focal = 1.2 * resolution
    rows = []
    rng = np.random.default_rng(7)
    for i in range(n_views):
        c2w = np.eye(4, dtype=np.float32)
        pos = np.array(
            [0.4 * rng.standard_normal(), 0.4 * rng.standard_normal(), 4.0], dtype=np.float32
        )
        back = np.array(
            [0.05 * rng.standard_normal(), 0.05 * rng.standard_normal(), 1.0], dtype=np.float32
        )
        c2w[:3, :4] = viewmatrix(back, np.array([0.0, 1.0, 0.0]), pos)
        rays = generate_rays(resolution, resolution, focal, c2w[None])
        img = render_rays_analytic(
            rays.origins.reshape(-1, 3), rays.directions.reshape(-1, 3), 1.0, 8.0
        ).reshape(resolution, resolution, 3)
        write_png(os.path.join(imgdir, f"img_{i:03d}.png"), (img * 255).astype(np.uint8))
        r = c2w[:3, :3]
        # LLFF storage convention: the loader maps rows [s1, -s0, s2] -> c2w.
        stored = np.stack([-r[1], r[0], r[2]], axis=0)
        m = np.concatenate(
            [stored, c2w[:3, 3:4], np.array([[resolution], [resolution], [focal]])], axis=1
        )
        rows.append(np.concatenate([m.reshape(-1), [2.0, 7.0]]))
    np.save(os.path.join(out_dir, "poses_bounds.npy"), np.stack(rows))
    return out_dir


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
