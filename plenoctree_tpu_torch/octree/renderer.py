"""PlenOctree volume renderer: the tree's device tables, the exact march's
building blocks, the fixed-length oracle and `VolumeRenderer`.

Port of plenoctree_tpu/octree/renderer.py. Semantics match the svox
renderer:
  * rays are transformed into tree coords; delta_scale converts tree-space
    path lengths back to world lengths for the attenuation integral;
  * each segment covers exactly one leaf: delta_t = (cube exit - t) + eps
    with eps = `step_size`;
  * colours decode per-ray basis (SH/SG evaluated at the world view
    direction, sigmoid-activated; RGBA raw), sigma is clamped at 0;
  * remaining transmittance composites onto `background_brightness`;
  * `fast` mode raises the sigma/stop thresholds to 1e-2.

Two execution modes, as in the JAX package:
  * `render_rays`: one fixed-length loop of `max_segments` steps,
    differentiable in the leaf data through autograd (the parity oracle);
  * `VolumeRenderer.render_persp`: the two-phase deferred pipeline of
    octree/march.py (march, then shade the contributor slots), with
    pass-level early termination and ray compaction.

The tables live on one torch device. The accel grid is built there with
the JAX package's word encoding, budget and float64 arithmetic, so both
packages build the same grid. Where XLA contracts `a*b + c` into a fused multiply-add inside
its compiled march (the ray position `o + t*dn`, the descent's
`corner + idx*(size/N)` and `local*N - idx`), the port mirrors it with the
f64-emulated `_fma`; for N = 2 those products are exact and the plain form
is used. Divisions by a scalar go through a device tensor: on the GPU a
division by a host scalar becomes a multiply by its reciprocal.
"""

from dataclasses import dataclass, replace

import numpy as np
import torch

from plenoctree_tpu_torch.kernels.tile_composite import _fma
from plenoctree_tpu_torch.ops.sh import sh_basis

_F32 = torch.float32
_I32 = torch.int32


@dataclass(frozen=True)
class RenderOptions:
    """Parity: svox RenderOptions (octree/extraction.py:184-188)."""

    step_size: float = 1e-4
    background_brightness: float = 1.0
    stop_thresh: float = 0.0  # transmittance early-stop (fast mode: 1e-2)
    sigma_thresh: float = 0.0  # skip leaves with sigma below (fast: 1e-2)
    max_segments: int = 256  # scan length bound (training path)


MAX_ACCEL_RESO = 512  # hard cap on grid side length
ACCEL_BYTES_BUDGET = 160 * 1024 * 1024  # device budget for the dense i32 grid
# Both values are the JAX package's, so both packages build the same grid.
# The budget was sized on the TPU, whose gather cost rises with table size;
# whether it suits the H100 (50 MB of L2) is what the gather probes
# (plenoctree_tpu_torch/bench_gather.py) measure; see PERF.md.


def resolve_device(device, who):
    """torch.device(device); raises for 'cuda' when there is no GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device='cuda') but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _div(x, s):
    """x / s with s a Python number, as a true division on every device."""
    return x / torch.tensor(float(s), dtype=x.dtype, device=x.device)


def accel_grid_level(tree, bytes_budget=None):
    """Choose the accel grid level k (reso = N**k) within the byte budget.

    Full depth needs k = max_depth + 1; when that grid exceeds the budget or
    MAX_ACCEL_RESO, drop k until it fits. Voxels that still contain deeper
    subtrees then store an internal-node pointer and the march finishes
    with a short per-step descent (`_locate`).
    """
    bytes_budget = bytes_budget or ACCEL_BYTES_BUDGET
    k = tree.max_depth + 1
    while k > 1 and (
        tree.N**k > MAX_ACCEL_RESO or 4 * tree.N ** (3 * k) > bytes_budget
    ):
        k -= 1
    return k


def build_accel_grid(tree, bytes_budget=None, device="cpu"):
    """Dense pointer grid: one i32 gather replaces the per-step tree descent.

    Word encoding (i32), indexed by voxel at reso = N**k:
      >= 0: containing LEAF — (flat_cell_index << 6) | leaf_node_depth
      <  0: voxel holds a deeper subtree — -(node_id + 1); the march
            descends from that node for the remaining depth_limit+1-k levels.

    Built with torch on `device` (the JAX package builds it in numpy on the
    host; the same float64 and int64 arithmetic, so the same grid: at depth
    7 the host build took ~28 s per renderer on the card's host).
    Returns (grid [reso^3] int32 tensor on `device`, reso, k).
    """
    k = accel_grid_level(tree, bytes_budget)
    N = tree.N
    reso = N**k
    n = tree.n_internal
    if n * N**3 >= 1 << 25:
        raise ValueError(
            f"tree has {n * N**3} cells; leaf words need cell < 2^25 "
            "(shrink the tree or extend the accel word to int64)"
        )
    dev = torch.device(device)
    child = torch.as_tensor(tree.child[:n].astype(np.int64)).to(dev)
    depth_of = torch.as_tensor(tree.parent_depth[:n, 1].astype(np.int64)).to(dev)
    arr = (torch.arange(reso, dtype=torch.float64, device=dev) + 0.5) / reso
    grid = torch.empty(reso * reso * reso, dtype=_I32, device=dev)
    block = max(1, (2**22) // (reso * reso))
    for x0 in range(0, reso, block):
        xs = arr[x0 : x0 + block]
        pts = torch.stack(torch.meshgrid(xs, arr, arr, indexing="ij"), dim=-1).reshape(-1, 3)
        node, cell, depth, internal = _query_capped(child, depth_of, N, pts, k)
        flat = node * N**3 + (cell[:, 0] * N + cell[:, 1]) * N + cell[:, 2]
        word = torch.where(internal, -(node + 1), (flat << 6) | depth)
        grid[x0 * reso * reso : x0 * reso * reso + pts.shape[0]] = word.to(_I32)
    return grid, reso, k


def _query_capped(child, depth_of, N, pts, k):
    """Locate each point's leaf, descending at most k-1 node levels, in
    the tree's relative child table [n, N, N, N] (int64) and node depths.

    Returns (node, cell_ijk, depth, internal): when `internal` is set, the
    point's voxel (at reso N**k) contains a subtree rooted at child node
    `node` (depth k) rather than a single leaf cell.
    """
    pos = pts.clamp(0.0, 1.0 - 1e-9)
    node = torch.zeros(pos.shape[0], dtype=torch.int64, device=pos.device)
    for _ in range(max(k - 1, 0)):
        idx = (pos * N).to(torch.int64).clamp(max=N - 1)
        rel = child[node, idx[:, 0], idx[:, 1], idx[:, 2]]
        live = rel != 0
        node = torch.where(live, node + rel, node)
        pos = torch.where(live[:, None], pos * N - idx, pos)
    idx = (pos * N).to(torch.int64).clamp(max=N - 1)
    rel = child[node, idx[:, 0], idx[:, 1], idx[:, 2]]
    internal = rel != 0
    return torch.where(internal, node + rel, node), idx, depth_of[node], internal


def tree_arrays(tree, accel=True, bytes_budget=None, device="cuda"):
    """Flatten an N3Tree into device tables for rendering.

    Returns a dict:
      child  [n*N^3]  int32 absolute child node id, -1 for leaf
      data   [n*N^3, data_dim] float32 (color coeffs + sigma)
      sigma  [n*N^3] float32 — the sigma-only table the march gathers
             instead of the ~50x wider `data` rows
      offset/invradius [3]
      extra_data (SG lambda/mu) or None
      accel  [reso^3] int32 pointer grid (see build_accel_grid), accel_reso,
      accel_level k, N, depth_limit (ints)
    """
    dev = resolve_device(device, "tree_arrays")
    n = tree.n_internal
    child_rel = tree.child[:n].reshape(n, -1).astype(np.int64)
    node_ids = np.arange(n, dtype=np.int64)[:, None]
    child_abs = np.where(child_rel == 0, -1, child_rel + node_ids)
    data = tree.data[:n].reshape(n * tree.N**3, tree.data_dim).astype(np.float32)

    def t(x, dtype=_F32):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dtype).to(dev)

    out = {
        "child": t(child_abs.reshape(-1), _I32),
        "data": t(data),
        "sigma": t(data[:, -1]),
        "offset": t(tree.offset),
        "invradius": t(tree.invradius),
        "extra_data": None if tree.extra_data is None else t(tree.extra_data),
        "accel": None,
        "accel_reso": 0,
        "accel_level": 0,
        "N": int(tree.N),
        "depth_limit": int(tree.max_depth),
    }
    if accel:
        grid, reso, k = build_accel_grid(tree, bytes_budget, dev)
        out["accel"] = grid
        out["accel_reso"] = reso
        out["accel_level"] = k
    return out


def write_back_data(tree, data):
    """Write optimized flat leaf data (a tensor) back into the host tree."""
    n = tree.n_internal
    tree.data[:n] = data.detach().cpu().numpy().reshape(n, tree.N, tree.N, tree.N, tree.data_dim)
    return tree


def _gather(table, index):
    """table[index] for an int32 index of any shape (one index_select)."""
    out = table.index_select(0, index.reshape(-1))
    return out.reshape(index.shape + table.shape[1:])


def _descend(child, pos, levels, N=2, node=None, corner=None, size=None):
    """Branch-free fixed-depth descent over `levels` levels. pos in [0,1)^3.

    Optionally starts from a given (node, corner, size) state — used by the
    budgeted accel grid, whose internal-pointer voxels leave a short
    residual descent. Returns (cell_flat_index, cube_corner, cube_size) of
    the containing leaf. Generic in branch factor N.
    """
    shape = pos.shape[:-1]
    dev = pos.device
    node = torch.zeros(shape, dtype=_I32, device=dev) if node is None else node
    corner = torch.zeros_like(pos) if corner is None else corner
    size = torch.ones(shape, dtype=pos.dtype, device=dev) if size is None else size
    local = (pos - corner) / size[..., None]
    cell = torch.zeros(shape, dtype=_I32, device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    n3 = N * N * N
    for _ in range(levels):
        idx = (local * N).to(_I32).clamp(0, N - 1)
        flat = node * n3 + (idx[..., 0] * N + idx[..., 1]) * N + idx[..., 2]
        nxt = _gather(child, flat)
        is_leaf = nxt < 0
        newly_done = is_leaf & ~done
        cell = torch.where(newly_done, flat, cell)
        idx_f = idx.to(pos.dtype)
        sub = _div(size[..., None], N)
        step = corner + idx_f * sub if N == 2 else _fma(idx_f, sub, corner)
        corner = torch.where((~done)[..., None], step, corner)
        size = torch.where(done, size, _div(size, N))
        stop = is_leaf | done
        node = torch.where(stop, node, nxt)
        down = local * N - idx_f if N == 2 else _fma(local, float(N), -idx_f)
        local = torch.where(stop[..., None], local, down)
        done = stop
    return cell, corner, size


def _ray_basis(fmt, basis_dim, viewdirs, extra_data):
    """Per-ray color basis [R, basis_dim] from world view directions.

    SH: the real SH basis; SG: exp(lambda * (mu . d - 1)) from the tree's
    extra_data [K, 4] = (lambda, mu xyz); RGBA: ones. The SG cosine is an
    explicit f32 sum (the JAX einsum runs at precision="highest").
    """
    if fmt == "SH":
        deg = int(round(basis_dim**0.5)) - 1
        return sh_basis(deg, viewdirs)
    if fmt == "SG":
        sg_lambda = extra_data[:, 0]
        sg_mu = extra_data[:, 1:4]
        cosine = (
            sg_mu[None, :, 0] * viewdirs[:, None, 0]
            + sg_mu[None, :, 1] * viewdirs[:, None, 1]
            + sg_mu[None, :, 2] * viewdirs[:, None, 2]
        )
        return torch.exp(sg_lambda[None, :] * (cosine - 1.0))
    return torch.ones(viewdirs.shape[:-1] + (1,), dtype=viewdirs.dtype, device=viewdirs.device)


def _norm3(v):
    """|v| over the last axis (size 3) with the sum of squares as an FMA
    chain, as XLA computes jnp.linalg.norm on the CPU."""
    sq = _fma(v[..., 2], v[..., 2], _fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0]))
    return torch.sqrt(sq)


def _prep_rays(arrays, origins, dirs, fmt, basis_dim):
    """World rays [R, 3] (tensors on the tables' device) -> tree-space
    marching state + per-ray color basis:
    (o, dn, safe_dn, delta_scale, tmin, tmax, basis)."""
    offset = arrays["offset"]
    invradius = arrays["invradius"]
    viewdirs = dirs / _norm3(dirs)[..., None]
    o = origins * invradius + offset
    d = viewdirs * invradius
    delta_scale = 1.0 / _norm3(d)  # world length per tree t
    dn = d * delta_scale[..., None]  # unit in tree space
    safe_dn = torch.where(dn.abs() < 1e-9, 1e-9, dn)
    t0 = (0.0 - o) / safe_dn
    t1 = (1.0 - o) / safe_dn
    tmin = torch.minimum(t0, t1).amax(-1).clamp(min=0.0) + 1e-5
    tmax = torch.maximum(t0, t1).amin(-1) - 1e-5
    basis = _ray_basis(fmt, basis_dim, viewdirs, arrays.get("extra_data"))
    return o, dn, safe_dn, delta_scale, tmin, tmax, basis


@dataclass(frozen=True)
class TreeMeta:
    """Static tree facts, kept apart from the tensor tables."""

    N: int
    depth_limit: int
    accel_reso: int
    accel_level: int


def split_arrays(arrays):
    """(tables, meta): the tensor-only dict + the static meta."""
    meta = TreeMeta(
        arrays["N"],
        arrays["depth_limit"],
        arrays["accel_reso"],
        arrays["accel_level"],
    )
    tables = {
        k: v
        for k, v in arrays.items()
        if k not in ("N", "depth_limit", "accel_reso", "accel_level")
    }
    return tables, meta


def _cell_size_from_depth(depth, N, dtype):
    e = -(depth + 1).to(dtype)
    if N == 2:
        return torch.exp2(e)
    return torch.exp(e * float(np.log(N)))


def _locate(tables, meta, pos):
    """(cell, corner, size) of the leaf containing pos, via the accel grid.

    One i32 gather for voxels whose leaf is at/above the grid level; a short
    residual `_descend` (depth_limit+1-k gathers) where the tree is deeper
    than the budgeted grid. Without a grid, a full-depth descent.
    """
    N = meta.N
    accel = tables.get("accel")
    if accel is None:
        return _descend(tables["child"], pos, meta.depth_limit + 1, N)
    reso = meta.accel_reso
    v = (pos * reso).to(_I32).clamp(0, reso - 1)
    word = _gather(accel, (v[..., 0] * reso + v[..., 1]) * reso + v[..., 2])
    cell = word >> 6
    depth = word & 63
    size = _cell_size_from_depth(depth, N, pos.dtype)
    corner = torch.floor(pos / size[..., None]) * size[..., None]
    residual = meta.depth_limit + 1 - meta.accel_level
    if residual <= 0:
        return cell, corner, size
    # Voxels holding subtrees: word < 0 encodes -(node+1) at level k.
    is_int = word < 0
    vsize = torch.full(pos.shape[:-1], 1.0 / reso, dtype=pos.dtype, device=pos.device)
    vcorner = _div(v.to(pos.dtype), reso)
    dcell, dcorner, dsize = _descend(
        tables["child"],
        pos,
        residual,
        N,
        node=torch.where(is_int, -word - 1, 0),
        corner=vcorner,
        size=vsize,
    )
    return (
        torch.where(is_int, dcell, cell),
        torch.where(is_int[..., None], dcorner, corner),
        torch.where(is_int, dsize, size),
    )


def _ray_position(t, dn, o):
    """clip(o + t*dn) inside the unit cube, o + t*dn as one FMA (XLA
    contracts it in the compiled march)."""
    return _fma(t[..., None], dn, o).clamp(0.0, 1.0 - 1e-7)


def _exit_delta(pos, corner, size, safe_dn, step_size):
    """Tree-space length from pos to the leaf cube's exit plane, + eps.

    Keyed off safe_dn, not dn: a zero component substitutes +1e-9 in
    safe_dn, and (dn > 0) would pick the near plane for it — exactly
    axis-aligned rays (every NDC centre ray) would crawl at step_size.
    """
    far_planes = corner + (safe_dn > 0) * size[..., None]
    t_exit = ((far_planes - pos) / safe_dn).amin(-1)
    return t_exit.clamp(min=0.0) + step_size


def _decode_rgb(fmt, coeffs, basis):
    """Colours of coeffs [R, ..., C, B] under the per-ray basis [R, B]."""
    raw = torch.einsum("r...cb,rb->r...c", coeffs, basis)
    return torch.sigmoid(raw) if fmt in ("SH", "SG") else raw


def _make_step(arrays, rp, fmt, basis_dim, opts):
    """One leaf segment: (t, light, accum) -> (t, light, accum)."""
    data = arrays["data"]
    tables, meta = split_arrays(arrays)
    o, dn, safe_dn, delta_scale, _, tmax, basis = rp
    n_channels = (data.shape[-1] - 1) // basis_dim
    zero = torch.zeros((), dtype=_F32, device=data.device)

    def step(t, light, accum):
        pos = _ray_position(t, dn, o)
        cell, corner, size = _locate(tables, meta, pos)
        delta_t = _exit_delta(pos, corner, size, safe_dn, opts.step_size)

        active = (t <= tmax) & (light > opts.stop_thresh)
        vals = _gather(data, cell)  # [R, data_dim]
        sigma = torch.maximum(vals[..., -1], zero)
        sigma = torch.where(sigma >= opts.sigma_thresh, sigma, zero)
        att = torch.exp(-delta_t * delta_scale * sigma)
        weight = torch.where(active, light * (1.0 - att), zero)

        coeffs = vals[..., :-1].reshape(vals.shape[:-1] + (n_channels, basis_dim))
        rgb = _decode_rgb(fmt, coeffs, basis)

        accum = accum + weight[..., None] * rgb
        light = torch.where(active, light * att, light)
        t = torch.where(active, t + delta_t, t)
        return t, light, accum

    return step, n_channels


def render_rays(arrays, origins, dirs, fmt, basis_dim, depth_limit, opts):
    """Render rays with one fixed-length loop (the differentiable oracle).

    Args:
      arrays: dict from `tree_arrays` (data may require grad).
      origins, dirs: [R, 3] world-space rays (dirs need not be unit),
        tensors on the tables' device.
      fmt: "SH" | "SG" | "RGBA".
      basis_dim: basis function count per channel.
      depth_limit: unused (the tree's depth is in arrays); kept for the
        JAX signature.
      opts: RenderOptions.

    Returns:
      rgb [R, n_channels].
    """
    del depth_limit
    rp = _prep_rays(arrays, origins, dirs, fmt, basis_dim)
    step, n_channels = _make_step(arrays, rp, fmt, basis_dim, opts)
    t = rp[4]
    light = torch.ones_like(t)
    accum = torch.zeros(origins.shape[:-1] + (n_channels,), dtype=_F32, device=t.device)
    for _ in range(opts.max_segments):
        t, light, accum = step(t, light, accum)
    return accum + light[..., None] * opts.background_brightness


class VolumeRenderer:
    """svox.VolumeRenderer's API surface over the deferred pipeline.

    Holds the host tree + device tables; `render_persp(c2w, ...)` renders a
    full pinhole image through the two-phase deferred pipeline (march.py)
    with pass-level early termination + ray compaction. The differentiable
    path is march + shade with a leaf-data tensor that requires grad
    (octree/optimize.py); `render_rays` above is the single-loop oracle.
    """

    def __init__(
        self,
        tree,
        step_size=1e-4,
        ndc=None,
        background_brightness=1.0,
        segs_per_pass=48,
        max_segments=None,
        contrib_slots=None,
        accel_bytes_budget=None,
        device="cuda",
    ):
        from plenoctree_tpu_torch.octree.march import estimate_contrib_slots

        self.device = resolve_device(device, "VolumeRenderer")
        self.tree = tree
        self.arrays = tree_arrays(tree, bytes_budget=accel_bytes_budget, device=self.device)
        self.ndc = ndc
        self.opts = RenderOptions(
            step_size=step_size,
            background_brightness=background_brightness,
            max_segments=max_segments or default_max_segments(tree),
        )
        self.fmt = tree.data_format.format
        self.basis_dim = tree.data_format.basis_dim
        self.depth_limit = int(tree.max_depth)
        self.segs_per_pass = segs_per_pass
        if contrib_slots is None:
            # Upfront K sizing from occupancy columns; sticky regrowth in
            # the march's pass loop stays as the backstop.
            contrib_slots = estimate_contrib_slots(tree, self.opts.sigma_thresh)
        self.contrib_slots = contrib_slots
        self._deferred = {}

    def _get_deferred(self, fast):
        if fast not in self._deferred:
            from plenoctree_tpu_torch.octree.march import DeferredRenderer

            opts = self.opts
            if fast:
                opts = replace(opts, sigma_thresh=1e-2, stop_thresh=1e-2)
            self._deferred[fast] = DeferredRenderer(
                self.arrays, self.fmt, self.basis_dim, opts, K=self.contrib_slots
            )
        return self._deferred[fast]

    def render_rays_early_stop(self, origins, dirs, fast=False):
        """Render [R, 3] rays (host arrays) via the deferred pipeline."""
        renderer = self._get_deferred(fast)
        # 1x + 4x + 11x = one 16x budget in exactly three passes (the
        # default budget, 1.5 * N^(depth+1), is a multiple of 16 * 48 for
        # depth-8 trees).
        schedule = (self.segs_per_pass, 4 * self.segs_per_pass, 11 * self.segs_per_pass)
        return renderer.render_chunk(
            np.asarray(origins, np.float32),
            np.asarray(dirs, np.float32),
            pass_schedule=schedule,
        )

    def render_persp(self, c2w, height, width, fx, fy=None, fast=False, chunk=65536):
        """Image [height, width, C] (numpy f32) of the pinhole camera c2w."""
        from plenoctree_tpu_torch.data.rays import convert_to_ndc, generate_rays

        rays = generate_rays(width, height, fx, np.asarray(c2w)[None])
        origins = rays.origins.reshape(-1, 3)
        dirs = rays.directions.reshape(-1, 3)
        if self.ndc is not None:
            origins, dirs = convert_to_ndc(
                origins, dirs, self.ndc["focal"], self.ndc["width"], self.ndc["height"]
            )
        n = origins.shape[0]
        chunk = min(chunk, n)
        outs = []
        for i in range(0, n, chunk):
            o = origins[i : i + chunk]
            d = dirs[i : i + chunk]
            pad = chunk - o.shape[0]
            if pad:
                o = np.pad(o, ((0, pad), (0, 0)), mode="edge")
                d = np.pad(d, ((0, pad), (0, 0)), mode="edge")
            out = self.render_rays_early_stop(o, d, fast=fast)
            outs.append(out[: chunk - pad] if pad else out)
        return np.concatenate(outs, 0).reshape(height, width, -1)


def default_max_segments(tree):
    """Scan length bound: enough segments to cross the deepest grid 1.5x."""
    return int(1.5 * tree.N ** (tree.max_depth + 1))


def make_ndc_config(width, height, focal):
    return {"width": width, "height": height, "focal": focal}
