"""NeRF -> PlenOctree extraction (library).

Port of plenoctree_tpu/octree/extract.py: auto_scale (shrink the bbox to
the sigma support), step1_build (dense grid evaluation, sigma or
visibility-weight mask, tree build to init_grid_depth) and step2_fill
(antialiased leaf fill: the mean of `samples_per_cell` jittered NeRF
samples per leaf, alpha-weighted for RGBA trees). Tree bookkeeping is host
numpy; the NeRF queries go through a `points_fn` on the device
(`make_points_fn`: the model's raw trunk outputs, through the fused trunk
kernel with --use_pallas on a GPU), and only sigma (step 0/1) or the
per-leaf means (step 2) come back to the host.

A use_viewdirs model (nerf_sh/config/misc/proj) is converted by SH
projection: steps 0 and 1 read sigma at zero view directions, and step 2
projects each jittered sample's radiance onto SH of degree cfg.sh_deg by
Monte-Carlo integration over cfg.projection_samples uniform directions
(`project_nerf_to_sh`, ops/sh_project.py; `make_cross_fn` runs the trunk
once per point and the view branch per point and direction). Its chunks,
and the order of its draws (each chunk's jitter, then its directions, from
one generator), are the JAX package's.

The jitter comes from np.random.default_rng(20200823), drawn chunk by chunk
as the JAX package draws it, so both packages sample the same points. The
chunks' draws and their arithmetic run on host threads a few chunks ahead
of the device: each thread draws from a copy of the generator advanced to
its chunk's first draw (PCG64.advance), so the stream is the sequential
one. Drawn on the calling thread, the jitter held step 2 up: 60.4 s
against 11.2 s on threads at init_grid_depth 7 and 256 samples per leaf
(`python -m plenoctree_tpu_torch.bench_fleet --step2_ab`, NVIDIA H100 80GB
HBM3, 700 W).

"""

import copy
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from plenoctree_tpu_torch.octree.grid_weight import calculate_grid_weights
from plenoctree_tpu_torch.ops import sh_project

# Default points per device dispatch: 2^20 on a GPU (12 MB in; each
# dispatch is a host round trip: the points copied in, the eager posenc,
# the trunk, a sync on the result copied out), the JAX package's 2^17 on
# the CPU, where a full-width trunk's activations then take 128 MB a layer.
# No value depends on the chunking: points are evaluated row by row and a
# leaf's samples never straddle chunks.
_POINT_CHUNK = {"cuda": 1 << 20, "cpu": 1 << 17}


def _point_chunk(cfg, device):
    default = _POINT_CHUNK["cuda" if torch.device(device).type == "cuda" else "cpu"]
    return max(int(getattr(cfg, "point_chunk", 0) or 0), 0) or max(cfg.chunk, default)


def _grid_points(reso, offset, invradius, z_min=None, z_max=None):
    """World-coord centers of a reso^3 grid covering the tree volume."""
    arr = (np.arange(0, reso, dtype=np.float32) + 0.5) / reso
    xx = (arr - offset[0]) / invradius[0]
    yy = (arr - offset[1]) / invradius[1]
    zz = (arr - offset[2]) / invradius[2]
    if z_min is not None:
        zz = zz[zz >= z_min]
    if z_max is not None:
        zz = zz[zz <= z_max]
    return np.stack(np.meshgrid(xx, yy, zz, indexing="ij"), axis=-1).reshape(-1, 3)


def make_points_fn(model, device, coarse=False):
    """points [N, 3] (numpy f32, or a tensor) -> (raw_rgb [N, C*K],
    raw_sigma [N, 1]), f32 tensors on `device`: the fine trunk's raw
    outputs (the coarse one's with `coarse`; no activation), as the JAX
    CLI's eval_points_raw; a use_viewdirs model is queried at zero view
    directions (sigma does not depend on them)."""

    @torch.no_grad()
    def points_fn(points):
        pts = torch.as_tensor(points, dtype=torch.float32).to(device)
        raw_rgb, raw_sigma = model.eval_points_raw(pts, coarse=coarse)
        return raw_rgb.float(), raw_sigma.float()

    return points_fn


def make_cross_fn(model, device):
    """(points [P, 3], dirs [D, 3]) numpy -> (raw_rgb [P, D, 3], raw_sigma
    [P, 1]) f32 tensors on `device`: a use_viewdirs model's raw outputs of
    every point against every direction (the JAX CLI's eval_points_cross)."""

    @torch.no_grad()
    def cross_fn(points, dirs):
        pts = torch.as_tensor(points, dtype=torch.float32).to(device)
        d = torch.as_tensor(dirs, dtype=torch.float32).to(device)
        raw_rgb, raw_sigma = model.eval_points_cross(pts, d)
        return raw_rgb.float(), raw_sigma.float()

    return cross_fn


def _as_tensor(x, device):
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def _eval_sigma(points_fn, grid, chunk):
    """Chunked sigma-only grid evaluation (only sigma leaves the device)."""
    out = np.empty(grid.shape[0], np.float32)
    for i in range(0, grid.shape[0], chunk):
        _, sigma = points_fn(grid[i : i + chunk])
        out[i : i + chunk] = torch.as_tensor(sigma).reshape(-1).float().cpu().numpy()
    return out


def sg_extra_data(sg_lambda, sg_mu_spher):
    """The SG tree's extra_data [N, 4]: (softplus lambda, cartesian mu) in
    f32, baked so the renderers need no activation (the JAX CLI's
    np.logaddexp softplus and its sin/cos, in float64 then cast)."""
    sg_lambda = np.asarray(sg_lambda)
    sg_mu = np.asarray(sg_mu_spher)
    lam = np.logaddexp(0.0, sg_lambda)
    mu = np.stack(
        [
            np.sin(sg_mu[:, 0]) * np.cos(sg_mu[:, 1]),
            np.sin(sg_mu[:, 0]) * np.sin(sg_mu[:, 1]),
            np.cos(sg_mu[:, 0]),
        ],
        axis=-1,
    )
    return np.concatenate([lam[:, None], mu], axis=-1).astype(np.float32)


def auto_scale(cfg, center, radius, points_fn, device="cpu"):
    """Shrink the bbox to the sigma support (parity: extraction.py:244-286);
    `device` is where points_fn evaluates (it sizes the dispatches)."""
    print("* Step 0: Auto scale")
    reso = 2**cfg.init_grid_depth
    radius = np.asarray(radius, np.float32)
    center = np.asarray(center, np.float32)
    scale = 0.5 / radius
    offset = 0.5 * (1.0 - center / radius)
    grid = _grid_points(reso, offset, scale, cfg.z_min, cfg.z_max)

    sigmas = _eval_sigma(points_fn, grid, _point_chunk(cfg, device))
    approx_delta = 2.0 / reso
    sigma_thresh = -np.log(1.0 - cfg.scale_alpha_thresh) / approx_delta
    grid = grid[sigmas >= sigma_thresh]
    if grid.shape[0] == 0:
        print("  (no voxels above threshold; keeping original bbox)")
        return center.tolist(), radius.tolist()
    lc = grid.min(axis=0) - 0.5 / reso
    uc = grid.max(axis=0) + 0.5 / reso
    return ((lc + uc) * 0.5).tolist(), ((uc - lc) * 0.5).tolist()


def step1_build(cfg, tree, points_fn, dataset, device="cpu"):
    """Dense grid eval -> sigma/weight mask -> refine to init_grid_depth.
    The weight mask's march runs on `device`."""
    print("* Step 1: Grid eval")
    reso = 2 ** (cfg.init_grid_depth + 1)
    grid = _grid_points(reso, tree.offset, tree.invradius, cfg.z_min, cfg.z_max)
    print("  init grid", grid.shape)

    sigmas = _eval_sigma(points_fn, grid, _point_chunk(cfg, device))
    approx_delta = 2.0 / reso
    sigma_thresh = -np.log(1.0 - cfg.alpha_thresh) / approx_delta

    if cfg.masking_mode == "sigma":
        mask = sigmas >= sigma_thresh
    elif cfg.masking_mode == "weight":
        print("* Calculating grid weights")
        grid_weights = calculate_grid_weights(
            dataset, np.maximum(sigmas, 0.0), reso, tree.invradius, tree.offset, device=device,
        )
        mask = grid_weights.reshape(-1) >= cfg.weight_thresh
    else:
        raise ValueError(f"unknown masking_mode {cfg.masking_mode}")

    grid = grid[mask]
    print("  masked grid", grid.shape)
    print("  Building octree")
    if tree.n_internal == 1:
        tree.build_from_points(grid, depth=cfg.init_grid_depth)
    else:
        for _ in range(cfg.init_grid_depth):
            tree.refine_points(grid)
    print(" ", tree)
    assert tree.max_depth == cfg.init_grid_depth
    return tree


def _jitter_chunks(tree, corner, size, S, chunk_size, rng):
    """Yields (lo, hi, points [(hi - lo) * S, 3] f32 world coordinates) for
    every chunk of leaves in order: the leaf's corner plus U[0, 1)^3 times
    its size, the uniforms drawn from `rng` (a generator whose bit generator
    has advance(), as default_rng's PCG64) in leaf order, float64, as one
    sequential pass would draw them. The chunks are made on threads, a
    window ahead, from copies of the generator advanced to their first
    draw; `rng` ends where the sequential pass leaves it."""
    n = corner.shape[0]
    bounds = [(lo, min(lo + chunk_size, n)) for lo in range(0, n, chunk_size)]

    def make_at(lo, hi):
        bitgen = copy.deepcopy(rng.bit_generator)
        bitgen.advance(lo * S * 3)  # one 64-bit draw per float64 uniform
        u = np.random.Generator(bitgen).random((hi - lo, S, 3), dtype=np.float64)
        t = corner[lo:hi, None, :] + u * size[lo:hi, None, None]
        return tree.tree2world(t.astype(np.float32)).reshape(-1, 3)

    workers = max(1, min(8, os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        pending = [pool.submit(make_at, lo, hi) for lo, hi in bounds[: 2 * workers]]
        for i, (lo, hi) in enumerate(bounds):
            points = pending[i].result()
            pending[i] = None
            if i + 2 * workers < len(bounds):
                pending.append(pool.submit(make_at, *bounds[i + 2 * workers]))
            yield lo, hi, points
    rng.bit_generator.advance(n * S * 3)


def project_nerf_to_sh(cross_fn, sh_deg, points, projection_samples, rng):
    """A view-dependent NeRF's radiance at points [P, 3] projected onto SH
    of degree sh_deg: (coeffs [P, 3 * (sh_deg + 1)^2] in channel-major
    order, the SH trees' layout; sigma [P, 1]), on cross_fn's device."""
    coeffs, sigma = sh_project.project_function_nerf(
        sh_deg, lambda dirs: cross_fn(points, dirs), projection_samples, rng
    )
    return coeffs.reshape(points.shape[0], -1), sigma


def _step2_project(cfg, tree, cross_fn, sel, corner, size, rng, device):
    """Step 2 for use_viewdirs models: for each chunk of leaves, draw its
    jitter, then its projection directions, project every sample, and
    average a leaf's samples (on the device; the leaf means go to the
    host). The chunk holds chunk / (S * projection_samples / 10) leaves,
    as in the JAX package."""
    S = cfg.samples_per_cell
    chunk_size = max(1, cfg.chunk // (S * max(cfg.projection_samples // 10, 1)))
    for lo in range(0, sel.shape[0], chunk_size):
        hi = min(lo + chunk_size, sel.shape[0])
        u = rng.random((hi - lo, S, 3), dtype=np.float64)
        t = corner[lo:hi, None, :] + u * size[lo:hi, None, None]
        points = tree.tree2world(t.astype(np.float32)).reshape(-1, 3)
        rgb, sigma = project_nerf_to_sh(cross_fn, cfg.sh_deg, points, cfg.projection_samples,
                                        rng)
        rgba = torch.cat([rgb, _as_tensor(sigma, device)], dim=-1)
        rgba = rgba.reshape(hi - lo, S, tree.data_dim).mean(dim=1)
        rows = sel[lo:hi]
        tree.data[rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]] = (
            rgba.cpu().numpy().astype(tree.data.dtype)
        )
    return tree


def step2_fill(cfg, tree, points_fn, rng=None, device="cpu", cross_fn=None):
    """Antialiased leaf fill of the leaves at the tree's full depth: the
    mean of samples_per_cell jittered samples per leaf (alpha-weighted
    colour for RGBA trees), reduced on `device`; for a use_viewdirs model
    (cfg.use_viewdirs) each sample is projected onto SH through
    `cross_fn` (make_cross_fn) instead."""
    print("* Step 2: AA", cfg.samples_per_cell)
    rng = rng or np.random.default_rng(20200823)
    S = cfg.samples_per_cell
    is_rgba = tree.data_format.format == "RGBA"
    approx_delta = 2.0 / 2 ** (cfg.init_grid_depth + 1)

    # Leaf geometry once up front: rows into tree.data + tree-space corner/size.
    leaves_all = tree._leaf_nodes()
    depth_all = tree.parent_depth[leaves_all[:, 0], 1]
    sel = leaves_all[depth_all == tree.max_depth]
    corner = tree._cell_corner(sel).astype(np.float64)
    size = tree._cell_size(sel).astype(np.float64)
    if cfg.use_viewdirs:
        if cross_fn is None:
            raise ValueError("step 2 of a use_viewdirs model needs cross_fn (make_cross_fn)")
        with torch.no_grad():
            return _step2_project(cfg, tree, cross_fn, sel, corner, size, rng, device)
    chunk_size = max(1, _point_chunk(cfg, device) // S)

    with torch.no_grad():
        for lo, hi, points in _jitter_chunks(tree, corner, size, S, chunk_size, rng):
            rgb, sigma = points_fn(points)
            rgb = _as_tensor(rgb, device).reshape(hi - lo, S, -1)
            sigma = _as_tensor(sigma, device).reshape(hi - lo, S, 1)
            if is_rgba:
                # Alpha-weighted colour average (octree/extraction.py:377-388).
                sigma_avg = sigma.mean(dim=1)
                alpha = 1.0 - torch.exp(-approx_delta * sigma)
                msum = alpha.sum(dim=1)
                rgb_avg = (rgb * alpha).sum(dim=1) / msum.clamp(min=1e-12)
                rgb_avg = torch.where(msum[..., :1] < 1e-3, 0.0, rgb_avg)
                rgba = torch.cat([rgb_avg, sigma_avg], dim=-1)
            else:
                rgba = torch.cat([rgb, sigma], dim=-1).mean(dim=1)
            rows = sel[lo:hi]
            tree.data[rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]] = (
                rgba.cpu().numpy().astype(tree.data.dtype)
            )
    return tree
