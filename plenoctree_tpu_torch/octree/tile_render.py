"""Tile-frustum PlenOctree renderer — the serving path, in PyTorch + CUDA.

Port of plenoctree_tpu/octree/tile_render.py (see its docstring for the
algorithm). The three stages keep their JAX structure:

  * Build (per scene): `build_tile_index` — every leaf above the sigma
    threshold is split into clipped replicas, one per coarse C^3 cell it
    overlaps, sorted in three axis-major orders, and laid out as a blocked
    soa [n_blk, fields, quantum]. In torch on the renderer's device,
    bitwise the JAX package's numpy build. Row ids are int32 from the index
    to the kernel, so an index holds fewer than 2^31 rows (MAX_INDEX_ROWS);
    the JAX package refuses 2^24 and more, which its phase 1 moves through
    f32 one-hot matmuls.
  * Phase 1 (PyTorch on the device, all tiles at once): the per-tile
    frustum walk through the grid giving tight contiguous row ranges,
    window-merged runs and quantum-aligned piece descriptors with 4-bit
    quad-group masks. `jax.vmap` becomes a leading tile dimension; the
    stable `lax.sort` compactions become `torch.sort(stable=True)`; the
    one-hot f32 matmul that expands runs into pieces becomes a
    searchsorted + gather. The piece lists are identical to the JAX ones.
  * Phase 2 (the CUDA kernel, kernels/tile_composite.py): composite every
    tile's pieces.

NDC serving (LLFF forward-facing scenes, `ndc=make_ndc_config(...)`)
converts each ray on the device as data/rays.py::convert_to_ndc does, so
origins are per ray; the quad-group masks then come from the AABB of each
group's segment endpoints, since NDC rays share no apex. Over a mesh of
devices (`TileRenderer(mesh=...)`, where the JAX renderer shards phase 1
through GSPMD and phase 2 through shard_map) the frame is split by tile
range: each device runs phase 1 and the compositing on its own contiguous
range of tiles, against its own replicas of the index, and only the
composited tiles and three per-frame maxima come back to the first device.

On one CUDA device every shape of a frame is fixed by (height, width, fx)
and the sticky caps (w1cap, ccap), and the frame copies nothing from the
host and never waits on it: its constants are made once per renderer and
device. So `render_persp` captures the frame's device work as CUDA graphs
once a (height, width, fx, caps) comes back, and replays them under it
(`_FrameGraph`, through utils/graphs.py): three graph launches where the
eager chain makes some 860 launch calls, the same kernels in the same
order, bitwise the same frame. The CPU, a mesh and the tile optimizer run
the eager chain.
"""

import contextlib
import warnings

import numpy as np
import torch

from plenoctree_tpu_torch.kernels.tile_composite import _fma, composite_tiles
from plenoctree_tpu_torch.octree.renderer import RenderOptions, _norm3, _ray_basis, resolve_device
from plenoctree_tpu_torch.utils import graphs, tracing

TILE = 16  # pixels per tile side (256 rays)
RUNROWS = 128  # default instance rows per compute chunk
# Same layout version as the JAX package: one index serves both.
INDEX_FORMAT_VERSION = 6
# Rows of an axis copy that build_tile_index lays out at a time (its
# temporaries are a few copies of them).
_BUILD_ROWS = 1 << 20
# Row ids (csr, base, col_leaf, run bounds, piece descriptors) are int32 on
# the whole path from the index to the kernel; the kernel addresses the soa
# through 64-bit block offsets.
MAX_INDEX_ROWS = 2**31
# Axis copies are padded to a COPY_PAD multiple so one index serves any
# runrows <= COPY_PAD.
COPY_PAD = 1024

_F32 = torch.float32
_I32 = torch.int32


# ---------------------------------------------------------------------------
# Build: clipped instance replication, 3 axis-major sort orders
# ---------------------------------------------------------------------------


def build_tile_index(
    tree, sigma_thresh=0.0, grid_c=64, fine_c2=None, runrows=RUNROWS,
    keep_all=False, quantum=128, device=None,
):
    """Per-scene preprocessing, in torch on `device` (the renderer's; a
    depth-8 SH16 index builds in 6 s on an H100, in 53 s in numpy on its
    host). It is bit-identical to the JAX package's numpy build_tile_index: the same
    operations in f64, true divisions by tensors, stable sorts, the
    threshold compared in the dtype numpy compares f32 with it in. With
    `device` None it runs on the CPU and returns numpy arrays, as the JAX
    package's does (which returns jax arrays for some keys); else tensors on
    `device`. The tree's rows and node placement go to the device once; the
    leaf corners and sizes are N3Tree._cell_corner's and _cell_size's
    arithmetic.

    Returns dict with:
      soa  [3*npad/quantum, fields, quantum] f32 blocked field-major rows:
           lo(3) hi(3) + data(data_dim) + pad, three axis-major copies
      csr  [3, C*C*c2 + 1] i32 — per-axis row starts (local to each copy)
      base [3] i32 — row offset of each copy
      margin [3] f32 — per-axis max clipped lateral-2 half-extent
      blk_bbox [3*npad/quantum, 8] f32 — per-block row bboxes
      col_leaf, keep_mask, n_kept, blk_quantum, grid_c, fine_c2,
      n_instances, sigma_row
    """
    del runrows  # layout is chunking-independent (see COPY_PAD)
    dev = torch.device("cpu" if device is None else device)
    f32, f64, i64 = torch.float32, torch.float64, torch.int64
    C = grid_c
    c2 = fine_c2 or 4 * C
    n_int = tree.n_internal
    node_origin, node_scale = tree._node_origins()
    rows = torch.from_numpy(
        np.ascontiguousarray(tree.data[:n_int]).reshape(n_int * tree.N**3, -1)).to(dev)
    flat = torch.from_numpy(np.flatnonzero(tree.child[:n_int] == 0)).to(dev)  # leaf cells
    if keep_all:
        keep = torch.ones(flat.shape, dtype=torch.bool, device=dev)
    else:
        dt = torch.from_numpy(np.zeros(0, np.result_type(np.float32, sigma_thresh))).dtype
        sigma = rows[flat, -1].to(f32)
        keep = (sigma > 0.0) & (sigma.to(dt) > torch.tensor(sigma_thresh, dtype=dt, device=dev))
        flat = flat[keep]
    data = rows[flat].to(f32)
    del rows
    node = flat // tree.N**3
    ijk = torch.stack([(flat // tree.N**2) % tree.N, (flat // tree.N) % tree.N,
                       flat % tree.N], -1).to(f64)
    sz = torch.from_numpy(node_scale).to(dev)[node] / torch.tensor(float(tree.N), dtype=f64,
                                                                   device=dev)
    corner = (torch.from_numpy(node_origin).to(dev)[node] + ijk * sz[:, None]).to(f32).to(f64)
    size = sz.to(f32).to(f64)
    del node, ijk, sz, flat

    lo_cell = (corner * C).to(i64).clamp(0, C - 1)
    hi_cell = (torch.ceil((corner + size[:, None]) * C).to(i64) - 1).clamp(0, C - 1)
    span = hi_cell - lo_cell + 1

    max_span = int(span.max()) if span.numel() else 1
    # Only leaves wider than one coarse cell have replicas past (0, 0, 0):
    # scanning just those keeps the build linear in the leaf count where a
    # keep_all index holds a few large empty leaves (max_span up to C/2).
    # Same instances, in the same order, as scanning every leaf.
    wide = torch.nonzero(span.amax(1) > 1).squeeze(1)
    span_w = span[wide]
    inst_leaf, inst_vox = [], []
    for dx in range(max_span):
        for dy in range(max_span):
            for dz in range(max_span):
                if dx == dy == dz == 0:
                    idx = torch.arange(span.shape[0], device=dev)
                else:
                    idx = wide[(dx < span_w[:, 0]) & (dy < span_w[:, 1]) & (dz < span_w[:, 2])]
                if idx.numel() == 0:
                    continue
                inst_leaf.append(idx)
                inst_vox.append(lo_cell[idx] + torch.tensor([dx, dy, dz], device=dev))
    inst_leaf = torch.cat(inst_leaf) if inst_leaf else torch.zeros(0, dtype=i64, device=dev)
    inst_vox = (torch.cat(inst_vox) if inst_vox
                else torch.zeros((0, 3), dtype=i64, device=dev))
    n = inst_leaf.shape[0]

    Ct = torch.tensor(float(C), dtype=f64, device=dev)
    box_lo = torch.maximum(corner[inst_leaf], inst_vox.to(f64) / Ct)
    box_hi = torch.minimum((corner + size[:, None])[inst_leaf], (inst_vox + 1).to(f64) / Ct)
    del corner, size, lo_cell, hi_cell, span
    d_cols = data.shape[1]

    npad = _padded_rows(n)
    fields = 6 + d_cols
    fpad = -(-fields // 8) * 8
    nblk = npad // quantum
    soa3 = torch.zeros((3 * nblk, fpad, quantum), dtype=f32, device=dev)
    csr = torch.zeros((3, C * C * c2 + 1), dtype=i64, device=dev)
    margin = torch.zeros(3, dtype=f32, device=dev)
    n_kept = int(keep.sum())
    col_leaf = torch.full((3 * npad,), n_kept, dtype=torch.int32, device=dev)
    ctr = 0.5 * (box_lo + box_hi)
    ext = box_hi - box_lo
    blk_bbox = torch.zeros((3 * nblk, 8), dtype=f32, device=dev)
    # Each axis-major copy is sorted, then written into its blocks (rows
    # lo(3) hi(3) data, transposed to fields x quantum) _BUILD_ROWS rows at
    # a time, so the temporaries stay a few copies of that.
    step = max(1, _BUILD_ROWS // quantum)
    for axis in range(3):
        p = (axis, (axis + 1) % 3, (axis + 2) % 3)
        v2 = (ctr[:, p[2]] * c2).to(i64).clamp(0, c2 - 1)
        key = (inst_vox[:, p[0]] * C + inst_vox[:, p[1]]) * c2 + v2
        order = torch.sort(key, stable=True).indices
        col_leaf[axis * npad : axis * npad + n] = inst_leaf[order].to(torch.int32)
        csr[axis, 1:] = torch.cumsum(torch.bincount(key, minlength=C * C * c2), 0)
        if n:
            margin[axis] = (0.5 * ext[:, p[2]].max()).to(f32)
        del v2, key
        for b0 in range(0, nblk, step):
            b1 = min(b0 + step, nblk)
            o = order[b0 * quantum : b1 * quantum]
            m = o.shape[0]
            srt = torch.zeros(((b1 - b0) * quantum, fields), dtype=f32, device=dev)
            srt[:m, 0:3] = box_lo[o].to(f32)
            srt[:m, 3:6] = box_hi[o].to(f32)
            srt[:m, 6:] = data[inst_leaf[o]]
            soa3[axis * nblk + b0 : axis * nblk + b1, :fields] = srt.reshape(
                b1 - b0, quantum, fields).transpose(1, 2)
            srt[m:, 0:3] = float("inf")
            srt[m:, 3:6] = -float("inf")
            blk = srt[:, 0:6].reshape(b1 - b0, quantum, 6)
            blk_bbox[axis * nblk + b0 : axis * nblk + b1, 0:3] = blk[:, :, 0:3].amin(1)
            blk_bbox[axis * nblk + b0 : axis * nblk + b1, 3:6] = blk[:, :, 3:6].amax(1)
    index = {
        "col_leaf": col_leaf,
        "n_kept": n_kept,
        "keep_mask": keep,
        "blk_bbox": blk_bbox,
        "blk_quantum": quantum,
        "soa": soa3,
        "csr": csr.to(torch.int32),
        "base": torch.tensor([0, npad, 2 * npad], dtype=torch.int32, device=dev),
        "margin": margin,
        "grid_c": C,
        "fine_c2": c2,
        "n_instances": n,
        "sigma_row": 6 + d_cols - 1,
    }
    if device is None:
        index = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in index.items()}
    return index


def _padded_rows(n):
    """npad, the rows of each axis copy of n instances; refuses an index of
    MAX_INDEX_ROWS rows or more."""
    npad = max(-(-n // COPY_PAD) * COPY_PAD, COPY_PAD)
    if 3 * npad >= MAX_INDEX_ROWS:
        raise ValueError(
            f"tile index too large: 3*npad = {3*npad} rows, the limit is "
            f"{MAX_INDEX_ROWS - 1}: row ids (csr, base, col_leaf, run bounds, piece "
            "descriptors) are int32"
        )
    return npad


def index_from_jax(index):
    """The JAX package's build_tile_index output -> this package's index.

    Array entries (jax or numpy) become torch tensors on the CPU with the
    same dtype and values; integer entries stay Python ints. TileRenderer
    accepts the result as `index=` and moves it to its device.
    """
    out = {}
    for k, v in index.items():
        if isinstance(v, (bool, int, float, np.integer, np.floating)):
            out[k] = v.item() if hasattr(v, "item") else v
        else:
            out[k] = torch.from_numpy(np.array(v, copy=True))
    return out


# ---------------------------------------------------------------------------
# Ray layout
# ---------------------------------------------------------------------------


_SEG_II, _SEG_JJ = np.triu_indices(8, k=1)  # all 28 point pairs


def _tilize(x, hp, wp, tile):
    """[hp, wp, c] -> [T, RAYS, c] in QUAD-MAJOR ray order: each tile's
    rays are 4 contiguous (tile/2)^2 blocks (its 2x2 pixel quads)."""
    q = tile // 2
    c = x.shape[-1]
    return (
        x.reshape(hp // tile, 2, q, wp // tile, 2, q, c)
        .permute(0, 3, 1, 4, 2, 5, 6)
        .reshape(-1, tile * tile, c)
    )


def _untile(tiles, hp, wp, tile):
    """Inverse of _tilize for kernel outputs [T, RAYS, c] -> [hp, wp, c]."""
    q = tile // 2
    c = tiles.shape[-1]
    return (
        tiles.reshape(hp // tile, wp // tile, 2, 2, q, q, c)
        .permute(0, 2, 4, 1, 3, 5, 6)
        .reshape(hp, wp, c)
    )


def _tile_corner_idx(tile):
    """Ray indices of the tile's 4 corner pixels in quad-major order."""
    q = tile // 2
    return np.array(
        [0, q * q + q - 1, 2 * q * q + (q - 1) * q, tile * tile - 1], np.int32
    )


_GROUP_CORNER_OFF = lambda q: np.array(  # noqa: E731
    [0, q - 1, (q - 1) * q, q * q - 1], np.int32
)


# Rounding mirrors the JAX package on its own backends: XLA contracts
# `a*b + c` into fused multiply-adds and computes a length-3 dot as an FMA
# chain, so the helpers below do the same (via `_fma`).


def _dot3(a, b):
    """Sum over the last axis (size 3) of a*b, as an f32 FMA chain."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _cross(a, b):
    return torch.stack(
        [
            _fma(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
            _fma(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
            _fma(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0])),
        ],
        dim=-1,
    )


def _segment_aabb_planes(o, dn, tmin, tmax, ray_ok, Q, axnorm):
    """Quad-group planes for rays without a shared apex (NDC): each ray's
    [tmin, tmax] span is a segment in tree space, so the AABB of a group's
    segment endpoints bounds all of its segments. Four axis normals (+x,
    -x, +y, -y) per group, with offsets from that AABB (misses excluded by
    a 1e4 sentinel): a sound, segment-limited group test through the same
    plane machinery (goff generalises n . apex). `axnorm` [4, 3] holds the
    four normals on the device. Returns gplanes [T, 16, 3] and goff [T, 16]."""
    n_tiles = o.shape[0]
    gplanes = axnorm.repeat(4, 1)[None].expand(n_tiles, 16, 3)
    e0 = _fma(tmin[..., None], dn, o)  # [T, RAYS, 3]
    e1 = _fma(tmax[..., None], dn, o)
    okr = ray_ok[..., None]
    big = 1e4
    elo = torch.minimum(torch.where(okr, e0, big), torch.where(okr, e1, big))
    ehi = torch.maximum(torch.where(okr, e0, -big), torch.where(okr, e1, -big))
    glo = elo.reshape(n_tiles, 4, Q * Q, 3).amin(dim=2)  # [T, 4, 3]
    ghi = ehi.reshape(n_tiles, 4, Q * Q, 3).amax(dim=2)
    goff = torch.stack(
        [glo[..., 0], -ghi[..., 0], glo[..., 1], -ghi[..., 1]], dim=-1
    ).reshape(n_tiles, 16)
    return gplanes, goff


def _floor_to_i32(x, lo, hi):
    """floor(x) as int32 clipped to [lo, hi] (clipped in float first, so
    out-of-range values never reach an undefined float->int conversion)."""
    return torch.floor(x).clamp(lo - 1, hi + 1).to(_I32).clamp(lo, hi)


# ---------------------------------------------------------------------------
# Phase 1: per-tile frustum walk -> compacted contiguous row ranges
# ---------------------------------------------------------------------------


def _phase1(
    csr, base, margin, blk_bbox, o4, d4, gplanes, goff, span_lo, span_hi,
    any_hit, grid_c, fine_c2, w1cap, quantum, ccap, consts,
):
    """All tiles' candidate row ranges, front-to-back slab order.

    Batched port of the JAX `_phase1` (which is vmapped over tiles): every
    per-tile tensor here has a leading tile dimension T. o4/d4 [T, 4, 3]
    are the tile's corner rays (tree space, unit dn); gplanes [T, 16, 3] /
    goff [T, 16] the quad-group half-spaces; span_lo/span_hi/any_hit [T];
    `consts` the renderer's device constants (`TileRenderer._constants`).
    Returns (piece_c0, piece_lo, piece_hi, piece_mask [T, ccap] each,
    n_pieces [T] post-drop, n_total [T], w1_over [T], n_pieces_pre [T]).
    """
    dev = o4.device
    T = o4.shape[0]
    C = grid_c
    min_abs = d4.abs().amin(dim=1)  # [T, 3]
    axis = torch.argmax(min_abs, dim=1)  # [T]
    perm = torch.stack([axis, (axis + 1) % 3, (axis + 2) % 3], dim=1)  # [T, 3]
    perm4 = perm[:, None, :].expand(T, 4, 3)
    op = torch.gather(o4, 2, perm4)  # component 0 = dominant
    dp = torch.gather(d4, 2, perm4)
    sgn = torch.sign(dp[:, :, 0].sum(1))
    safe_d = torch.where(dp.abs() < 1e-9, 1e-9, dp)

    # Slab planes along the dominant axis, enumerated in travel order.
    s = torch.arange(C, dtype=_F32, device=dev)
    a_pos = torch.where(sgn[:, None] >= 0, s[None], C - 1.0 - s[None]).to(_I32)  # [T, C]
    plane_lo = a_pos.to(_F32) / C
    plane_hi = (a_pos.to(_F32) + 1.0) / C
    ta = (plane_lo[:, :, None] - op[:, None, :, 0]) / safe_d[:, None, :, 0]  # [T, C, 4]
    tb = (plane_hi[:, :, None] - op[:, None, :, 0]) / safe_d[:, None, :, 0]
    t_in = torch.minimum(ta, tb)
    t_out = torch.maximum(ta, tb)
    tguard = 2e-2 * (1.0 + torch.maximum(span_lo.abs(), span_hi.abs()))
    slab_valid = (
        (t_in <= (span_hi + tguard)[:, None, None])
        & (t_out >= (span_lo - tguard)[:, None, None])
    ).any(dim=2) & any_hit[:, None]  # [T, C]

    # Lateral footprint: corner positions at both plane crossings.
    ts = torch.stack([t_in, t_out], dim=-1)  # [T, C, 4, 2]
    lat = _fma(ts[..., None], dp[:, None, :, None, 1:], op[:, None, :, None, 1:])
    lat = lat.clamp(-1.0, 2.0)
    pts = lat.reshape(T, C, 8, 2)
    lat_lo = pts.amin(dim=2)  # [T, C, 2]
    lat_hi = pts.amax(dim=2)
    eps = consts["eps"]
    v_lo = _floor_to_i32(_fma(lat_lo[..., 0], C, -eps), 0, C - 1)
    v_hi = _floor_to_i32(_fma(lat_hi[..., 0], C, eps), 0, C - 1)

    # lateral-1 window, enumerated along travel sign.
    sgn1 = torch.sign(dp[:, :, 1].sum(1))
    j = torch.arange(w1cap, dtype=_I32, device=dev)
    w1 = torch.where(
        sgn1[:, None, None] >= 0, v_lo[:, :, None] + j, v_hi[:, :, None] - j
    )  # [T, C, w1cap]
    w1_ok = (j <= (v_hi - v_lo)[:, :, None]) & slab_valid[:, :, None]
    w1c = w1.clamp(0, C - 1)
    w1_over = torch.where(slab_valid, v_hi - v_lo + 1 - w1cap, 0).amax(dim=1)

    # Exact lateral-2 range of (hull of the 8 points) ∩ (lateral-1 strip).
    c2 = fine_c2
    w1f = w1c.to(_F32)
    lo1 = w1f / C
    hi1 = (w1f + 1.0) / C
    ep1 = pts[:, :, None, :, 0]  # [T, C, 1, 8]
    ep2 = pts[:, :, None, :, 1]
    ep_in = (ep1 >= lo1[..., None] - 5e-5) & (ep1 <= hi1[..., None] + 5e-5)
    ii, jj = consts["seg_ii"], consts["seg_jj"]
    p1 = pts[:, :, ii, 0][:, :, None, :]  # [T, C, 1, 28]
    q1 = pts[:, :, jj, 0][:, :, None, :]
    p2 = pts[:, :, ii, 1][:, :, None, :]
    q2 = pts[:, :, jj, 1][:, :, None, :]
    den = q1 - p1
    nz = den.abs() > 1e-12
    safe_den = torch.where(nz, den, 1.0)
    big = 1e9

    def cross_l2(bound):
        t = (bound[..., None] - p1) / safe_den
        ok = nz & (t >= -1e-4) & (t <= 1.0 + 1e-4)
        return ok, _fma(t, q2 - p2, p2)

    ok_a, x_a = cross_l2(lo1)
    ok_b, x_b = cross_l2(hi1)
    ep2b = ep2.expand(ep_in.shape)
    l2_min = torch.minimum(
        torch.where(ep_in, ep2b, big).amin(-1),
        torch.minimum(
            torch.where(ok_a, x_a, big).amin(-1),
            torch.where(ok_b, x_b, big).amin(-1),
        ),
    )
    l2_max = torch.maximum(
        torch.where(ep_in, ep2b, -big).amax(-1),
        torch.maximum(
            torch.where(ok_a, x_a, -big).amax(-1),
            torch.where(ok_b, x_b, -big).amax(-1),
        ),
    )
    has = ep_in.any(-1) | ok_a.any(-1) | ok_b.any(-1)
    w1_ok = w1_ok & has
    mh = (margin[axis] + 5e-5)[:, None, None]  # [T, 1, 1]
    eps2 = consts["eps2"]
    v2_lo = _floor_to_i32(_fma(l2_min - mh, c2, -eps2), 0, c2 - 1)
    v2_hi = _floor_to_i32(_fma(l2_max + mh, c2, eps2), 0, c2 - 1)

    cell = (a_pos[:, :, None] * C + w1c) * c2
    ncsr = csr.shape[1]
    csr_flat = csr.reshape(-1)
    row0 = (axis.to(_I32) * ncsr)[:, None, None]
    base_t = base[axis][:, None, None]
    r_start = csr_flat[(row0 + cell + v2_lo).long()] + base_t
    r_end = csr_flat[(row0 + cell + v2_hi + 1).long()] + base_t
    r_len = torch.where(w1_ok, r_end - r_start, 0)

    # 4-bit quad-group mask per range: p-vertex test of the range's cell box
    # against each quad frustum's 4 inward planes, in explicit f32 sums.
    box_lo_p = torch.stack(
        [plane_lo[:, :, None].expand_as(w1f), w1f / C, v2_lo.to(_F32) / c2 - mh],
        dim=-1,
    )  # [T, C, w1cap, 3] in (dominant, lat1, lat2) order
    box_hi_p = torch.stack(
        [plane_hi[:, :, None].expand_as(w1f), (w1f + 1.0) / C,
         (v2_hi.to(_F32) + 1.0) / c2 + mh],
        dim=-1,
    )
    perm16 = perm[:, None, :].expand(T, 16, 3)
    pos_p = torch.gather(gplanes.clamp(min=0.0), 2, perm16)[:, None, None]  # [T,1,1,16,3]
    neg_p = torch.gather(gplanes.clamp(max=0.0), 2, perm16)[:, None, None]
    sd = (
        _dot3(box_hi_p[..., None, :], pos_p)
        + _dot3(box_lo_p[..., None, :], neg_p)
        - goff[:, None, None, :]
    )  # [T, C, w1cap, 16]
    bits = consts["bits"]
    gmask = (sd.reshape(T, C, w1cap, 4, 4) >= -3e-4).all(-1)
    r_mask = (gmask.to(_I32) * bits).sum(-1, dtype=_I32)

    M = C * w1cap
    flat_start = r_start.reshape(T, M)
    flat_len = r_len.reshape(T, M)
    flat_mask = r_mask.reshape(T, M)
    n_total = (flat_len > 0).sum(1, dtype=_I32)

    rev = (torch.sign(dp[:, :, 2].sum(1)) < 0).to(_I32)
    runs_start, runs_len, runs_mask, _ = _merge_runs(
        flat_start, flat_len, flat_mask, rev, quantum
    )
    piece_c0, piece_lo, piece_hi, piece_mask, n_pieces = _expand_pieces(
        runs_start, runs_len, runs_mask, rev, quantum, ccap
    )

    # Per-piece mask refinement against the static per-block bboxes, then
    # compact zero-mask pieces away.
    pvalid = (
        torch.arange(ccap, dtype=_I32, device=dev)[None]
        < n_pieces.clamp(max=ccap)[:, None]
    )
    bb = blk_bbox[(piece_c0 // quantum).long()]  # [T, ccap, 8]
    nrm = gplanes[:, None]  # [T, 1, 16, 3]
    sdist = (
        _dot3(bb[:, :, None, 3:6], nrm.clamp(min=0.0))
        + _dot3(bb[:, :, None, 0:3], nrm.clamp(max=0.0))
        - goff[:, None, :]
    )  # [T, ccap, 16]
    bmask_bits = (sdist.reshape(T, ccap, 4, 4) >= -3e-4).all(-1)
    bmask = (bmask_bits.to(_I32) * bits).sum(-1, dtype=_I32)
    mask2 = torch.where(pvalid, piece_mask & bmask, 0)
    keep_p = mask2 > 0
    n_kept_p = keep_p.sum(1, dtype=_I32)
    piece_c0, piece_lo, piece_hi, piece_mask = _compact_by_flag(
        keep_p, (piece_c0, piece_lo, piece_hi, mask2)
    )
    return (
        piece_c0,
        piece_lo,
        piece_hi,
        piece_mask,
        n_kept_p,
        n_total.clamp(max=2**30),
        w1_over,
        n_pieces,
    )


def _live_rows(piece_c0, piece_lo, piece_hi, quantum):
    """The rows of each tile's pieces' soa blocks that lie inside their runs
    ([T] int32 of [T, ..., ccap] descriptors): |[max(lo, c0), min(hi, c0 +
    quantum))| a piece, never empty (each piece's block is one its run
    overlaps, `_expand_pieces`); an empty slot (c0 = lo = hi = 0) has none."""
    live = torch.minimum(piece_hi, piece_c0 + quantum) - torch.maximum(piece_lo, piece_c0)
    return live.reshape(live.shape[0], -1).sum(-1, dtype=_I32)


def _compact_by_flag(flag, cols):
    """Stable front-compaction along the last axis: flagged entries move to
    the front in order; the tail is zero (one stable sort on the flag)."""
    key = torch.where(flag, 0, 1).to(torch.uint8)
    _, order = torch.sort(key, dim=-1, stable=True)
    return tuple(torch.gather(torch.where(flag, c, 0), -1, order) for c in cols)


def _carry_forward(valid, vals):
    """Inclusive last-valid-value scan along the last axis: out[m] =
    vals[k] for the largest k <= m with valid[k]; where no such k exists,
    vals[0] (what the JAX associative_scan yields there). Also returns the
    seen-any-valid flag."""
    pos = torch.arange(valid.shape[-1], device=valid.device).expand(valid.shape)
    last = torch.where(valid, pos, -1).cummax(dim=-1).values
    seen = last >= 0
    idx = last.clamp(min=0)
    out = tuple(
        torch.where(seen, torch.gather(v, -1, idx), v[..., :1].expand(v.shape))
        for v in vals
    )
    return seen, out


def _expand_pieces(runs_start, runs_len, runs_mask, rev, quantum, ccap):
    """Flatten merged runs [T, M] into quantum-aligned piece descriptors
    [T, ccap]: (c0 aligned block start, lo/hi the owning run's row interval,
    mask). Piece slot p belongs to the run m with cum_excl[m] <= p < cum[m],
    found by a searchsorted over the cumulative piece counts (the JAX code
    uses an exact one-hot matmul; the result is the same)."""
    T, M = runs_start.shape
    dev = runs_start.device
    s = runs_start
    l = runs_len
    first = (s // quantum) * quantum
    last = ((s + l.clamp(min=1) - 1) // quantum) * quantum
    nck = torch.where(l > 0, (last - first) // quantum + 1, 0)
    cum = torch.cumsum(nck, dim=-1, dtype=_I32)
    cum_excl = cum - nck
    n_pieces = cum[:, -1]
    p = torch.arange(ccap, dtype=_I32, device=dev)[None].expand(T, ccap).contiguous()
    m = torch.searchsorted(cum.contiguous(), p, right=True).clamp(max=M - 1)

    def sel(v):
        return torch.gather(v, 1, m)

    w = p - sel(cum_excl)
    c0 = torch.where(
        (rev == 1)[:, None], sel(last) - w * quantum, sel(first) + w * quantum
    )
    ok = p < n_pieces.clamp(max=ccap)[:, None]
    return (
        torch.where(ok, c0, 0),
        torch.where(ok, sel(s), 0),
        torch.where(ok, sel(s + l), 0),
        torch.where(ok, sel(runs_mask), 0),
        n_pieces.clamp(max=2**30),
    )


def _merge_runs(runs_start, runs_len, runs_mask, rev, quantum):
    """Fuse emission-consecutive runs [T, M] whose quantum windows overlap or
    abut, in travel order (see the JAX `_merge_runs` for the reasoning).
    Invalid slots (len 0) may sit anywhere; chains bridge them via a
    carry-forward of the previous valid run."""
    s = runs_start
    e = runs_start + runs_len
    T, M = s.shape
    dev = s.device
    valid = runs_len > 0
    rank = torch.cumsum(valid.to(_I32), dim=-1, dtype=_I32) - 1
    rev1 = (rev == 1)[:, None]

    def align(v):
        return (v // quantum) * quantum

    _, (cf_s, cf_e) = _carry_forward(valid, (s, e))
    ps = torch.cat([s[:, :1], cf_s[:, :-1]], dim=1)
    pe = torch.cat([e[:, :1], cf_e[:, :-1]], dim=1)
    dir_ok = torch.where(rev1, s <= ps, s >= ps)
    win_ok = torch.where(
        rev1,
        align(ps) <= align(e - 1) + quantum,
        align(s) <= align(pe - 1) + quantum,
    )
    merge_prev = valid & dir_ok & win_ok & (rank > 0)
    is_first = valid & ~merge_prev
    nok_r, (nmp_r,) = _carry_forward(
        valid.flip(-1), (merge_prev.to(_I32).flip(-1),)
    )
    nxt_ok = torch.cat(
        [nok_r.flip(-1)[:, 1:], torch.zeros(T, 1, dtype=torch.bool, device=dev)], 1
    )
    nxt_mp = torch.cat(
        [nmp_r.flip(-1)[:, 1:], torch.zeros(T, 1, dtype=_I32, device=dev)], 1
    )
    is_last = valid & (~nxt_ok | (nxt_mp == 0))
    n_merged = is_first.sum(-1, dtype=_I32)

    masked = torch.where(valid, runs_mask, 0)
    bit = [(masked >> b) & 1 for b in range(4)]
    csum = [torch.cumsum(b_, dim=-1, dtype=_I32) for b_ in bit]
    f_cols = _compact_by_flag(
        is_first, (s, e) + tuple(c - b_ for c, b_ in zip(csum, bit))
    )
    l_cols = _compact_by_flag(is_last, (s, e) + tuple(csum))
    new_s = torch.where(rev1, l_cols[0], f_cols[0])
    new_e = torch.where(rev1, f_cols[1], l_cols[1])
    new_mask = torch.zeros(T, M, dtype=_I32, device=dev)
    for b in range(4):
        new_mask = new_mask + ((l_cols[2 + b] - f_cols[2 + b]) > 0).to(_I32) * (2**b)
    gvalid = torch.arange(M, device=dev)[None] < n_merged[:, None]
    new_s = torch.where(gvalid, new_s, 0)
    new_len = torch.where(gvalid, new_e - new_s, 0)
    new_mask = torch.where(gvalid, new_mask, 0)
    return new_s, new_len, new_mask, n_merged


# ---------------------------------------------------------------------------
# Renderer: the frame loop
# ---------------------------------------------------------------------------


class _FrameGraph:
    """A frame's device work on one CUDA slot, captured (utils/graphs.py) as
    three phases: the tile inputs, kernel #3 and the assembly. The pose
    enters through a pinned buffer. Every shape is fixed by `key` (height,
    width, fx, w1cap, ccap), and the same kernels run in the same order as
    the eager chain's, so a replayed frame is bitwise the eager frame. It
    holds no reference to the renderer: dropping it frees the graphs and
    their pool."""

    def __init__(self, r, key):
        height, width, fx, w1cap, ccap = key
        dev, rep, _ = r._slots[0]
        self.pose = graphs.Pinned((3, 4), dev)
        inputs = r._inputs_fn(height, width, fx, w1cap, ccap, device=self.pose.dev.device)

        def tile_inputs():
            p2_args, *counts, nck = inputs(
                self.pose.dev, rep["csr"], rep["base"], rep["extra_data"], rep["blk_bbox"]
            )
            # What a traced replay sums: the chunks handed to the kernel and
            # their live rows, per tile.
            return p2_args, counts, torch.stack([nck, _live_rows(*p2_args[1:4], r.quantum)])

        def count(s, out):
            pieces, rows = out[2].sum(1)
            s.count(pieces=pieces, rows=rows)

        self.phases = graphs.Phases(dev, [
            ("tile.inputs", tile_inputs, count),
            ("tile.composite", lambda inp: composite_tiles(*inp[0], rep["soa"], **r._kernel_kw)),
            ("tile.assemble",
             lambda inp, out: r._assemble([(out, tuple(inp[1]), None)], height, width)),
        ])

    def replay(self, c2w):
        """Enqueue the frame at pose c2w; returns the static outputs."""
        self.pose.put(np.asarray(c2w, np.float32)[:3, :4])
        return self.phases.replay()[-1]


class TileRenderer:
    """Full-image pinhole renderer over a static tree (serving/eval path).

    Same public surface as the JAX TileRenderer (`render_persp`,
    `render_persp_async`, `_check_caps`). Fast mode is an init-time choice
    (the instance index is threshold-dependent): construct with
    sigma_thresh/stop_thresh ~1e-2.

    `device` is explicit: "cuda" renders through the CUDA kernel and raises
    when there is no GPU; "cpu" runs the plain PyTorch compositing.
    `use_bf16` is accepted for signature parity with the JAX renderer, where
    it rounds the TPU kernel's matmul operands to bf16; here every stage
    computes in f32 regardless. The TPU-only knobs (nbuf, interpret,
    ablate) are not carried over.

    `mesh` (parallel/mesh.py::make_mesh; a device may repeat) shards the
    frame over its devices by tile range (`device` is then ignored): the
    tile axis padded to a device multiple gives each device a contiguous
    range of ceil(tiles / devices) tiles (the padding is never computed);
    each device runs phase 1 on its range and composites it against its own
    replicas of the index arrays (one per distinct device), on its own
    stream on a GPU, every range launched before any is gathered. The
    composited tiles and the frame's n_max / nc_max / w1_over (maxima over
    the devices, so the sticky cap growth sees the one-device values) are
    gathered on the first device. Tiles are independent, so the frame is
    bitwise the one-device frame.

    With one CUDA device and no mesh, frames replay captured graphs
    (`_enqueue`, utils/graphs.py's Policy keeping one): the second attempt
    in a row under one (height, width, fx, w1cap, ccap) captures them,
    later attempts under that key replay them, and an attempt under
    another key releases them.
    """

    def __init__(
        self,
        tree,
        step_size=1e-4,
        background_brightness=1.0,
        sigma_thresh=0.0,
        stop_thresh=0.0,
        grid_c=64,
        fine_c2=None,
        runrows=RUNROWS,
        use_bf16=True,
        rcap=256,
        w1cap=None,
        ccap=None,
        quantum=128,
        output="f32",
        tile=TILE,
        mesh=None,
        index=None,
        ndc=None,
        device="cuda",
    ):
        if mesh is not None:
            device = mesh.devices[0]
        self.mesh = mesh
        self.device = resolve_device(device, "TileRenderer")
        # LLFF forward-facing serving: {"focal", "width", "height"} of the
        # capture (octree/renderer.py::make_ndc_config); None for pinhole.
        self.ndc = ndc
        if output not in ("f32", "u8"):
            raise ValueError(f"output must be 'f32' or 'u8', got {output!r}")
        self.tree = tree
        self.opts = RenderOptions(
            step_size=step_size,
            background_brightness=background_brightness,
            sigma_thresh=sigma_thresh,
            stop_thresh=stop_thresh,
        )
        self.runrows = runrows
        self.use_bf16 = use_bf16
        if index is not None:
            if int(index["blk_quantum"]) != quantum or int(index["grid_c"]) != grid_c:
                raise ValueError(
                    "injected tile index was built with blk_quantum="
                    f"{index['blk_quantum']}/grid_c={index['grid_c']} but the "
                    f"renderer was constructed with quantum={quantum}/"
                    f"grid_c={grid_c}"
                )
        dev = self.device
        # Set-up: the index's build on the device (unless one is injected)
        # and an injected one's move there, counting its rows (3 * npad) and
        # the device soa's bytes.
        with tracing.span("tile.index") as s:
            if index is None:
                index = build_tile_index(
                    tree, sigma_thresh, grid_c, fine_c2, runrows, quantum=quantum, device=dev
                )
            self.index = dict(index)
            del index  # an injected host soa goes once it is on the device
            for k in ("soa", "blk_bbox", "margin"):
                self.index[k] = torch.as_tensor(self.index[k], dtype=_F32).to(dev).contiguous()
            for k in ("csr", "base"):
                self.index[k] = torch.as_tensor(self.index[k], dtype=_I32).to(dev).contiguous()
            if s:
                soa = self.index["soa"]
                s.count(rows=soa.shape[0] * soa.shape[2], bytes=soa.nbytes)
        self.grid_c = grid_c
        self.fine_c2 = int(self.index["fine_c2"])
        self.rcap = rcap
        self.w1cap = w1cap
        self.ccap = ccap or rcap * max(2, runrows // quantum)
        self.quantum = quantum
        self.fmt = tree.data_format.format
        self.basis_dim = tree.data_format.basis_dim
        self.n_channels = (int(self.index["sigma_row"]) - 6) // self.basis_dim
        self.offset = torch.as_tensor(tree.offset, dtype=_F32).to(dev)
        self.invradius = torch.as_tensor(tree.invradius, dtype=_F32).to(dev)
        self.extra_data = (
            None
            if tree.extra_data is None
            else torch.as_tensor(tree.extra_data, dtype=_F32).to(dev)
        )
        # (device, replicas, stream) per device the frame is split over. With
        # no mesh: one slot, the renderer's own arrays on the current stream.
        self._slots = []
        replicas = {}  # what phase 1 and the kernel read, per distinct device
        for d in [self.device] if mesh is None else mesh.devices:
            d = resolve_device(d, "TileRenderer")
            if d not in replicas:
                replicas[d] = self._arrays_on(d)
            stream = torch.cuda.Stream(d) if mesh is not None and d.type == "cuda" else None
            self._slots.append((d, replicas[d], stream))
        if mesh is not None:
            for d in replicas:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)  # the replicas are read on other streams
        self.output = output
        self.frames = 0  # render_persp calls: the request id of their spans
        self._consts = {}  # device -> the frame's constant tensors there
        # Frames are captured and replayed on one CUDA slot; the CPU and a
        # mesh (several slots and streams) run eagerly.
        self._policy = graphs.Policy(keep=1) if mesh is None and dev.type == "cuda" else None
        self.tile = tile
        self.rays = tile * tile
        od_cap = (
            -float(np.log(self.opts.stop_thresh)) if self.opts.stop_thresh > 0 else 1e30
        )
        self._kernel_kw = dict(
            fmt=self.fmt,
            basis_dim=self.basis_dim,
            n_channels=self.n_channels,
            sigma_row=int(self.index["sigma_row"]),
            runrows=self.runrows,
            quantum=self.quantum,
            step_eps=self.opts.step_size,
            stop_thresh=self.opts.stop_thresh,
            od_cap=od_cap,
        )

    _REPLICATED = ("soa", "csr", "base", "blk_bbox", "margin", "offset", "invradius",
                   "extra_data")

    def _arrays_on(self, device, keys=_REPLICATED):
        """The arrays phase 1 and the kernel read (the index's, the tree's
        transform and extra_data) on `device`: the renderer's own where
        they live there, a mesh slot's replica where one does, else
        copies."""
        device = torch.device(device)
        for d, replica, _ in self._slots:
            if d == device:
                return {k: replica[k] for k in keys}
        own = dict(self.index, offset=self.offset, invradius=self.invradius,
                   extra_data=self.extra_data)
        return {k: None if own[k] is None else own[k].to(device) for k in keys}

    # -- tile inputs: ray generation, tree-space transform, phase 1 ---------

    def _constants(self, device, fx):
        """The constant tensors of a frame's device work on `device`, made
        once per renderer, device and focal length, so that a frame copies
        nothing from the host and can be captured. Divisions by a scalar go
        through a device tensor: dividing by a host scalar would become a
        multiply by its reciprocal on the GPU, and rays would round
        differently."""
        c = self._consts.get(device)
        if c is None:
            Q = self.tile // 2

            def const(v, dtype):
                return torch.tensor(v, dtype=dtype, device=device)

            c = self._consts[device] = {
                "corners": torch.as_tensor(_tile_corner_idx(self.tile), device=device).long(),
                # [16] quad-group corner ray indices
                "gc_idx": torch.as_tensor(
                    (np.arange(4)[:, None] * Q * Q + _GROUP_CORNER_OFF(Q)[None, :]).reshape(-1),
                    device=device,
                ).long(),
                "eps": const(1e-2, _F32),
                "eps2": const(2e-2, _F32),
                "bits": const([1, 2, 4, 8], _I32),
                "seg_ii": torch.as_tensor(_SEG_II, device=device),
                "seg_jj": torch.as_tensor(_SEG_JJ, device=device),
                "axnorm": const([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]], _F32),
                "fx": {},
            }
            if self.ndc is not None:
                c["fx2w"] = const(2.0 * self.ndc["focal"] / self.ndc["width"], _F32)
                c["fy2h"] = const(2.0 * self.ndc["focal"] / self.ndc["height"], _F32)
                c["two"] = const(2.0, _F32)
        if float(fx) not in c["fx"]:
            c["fx"][float(fx)] = torch.tensor(float(fx), dtype=_F32, device=device)
        return c

    def _to_ndc(self, origin, d_world, consts):
        """data/rays.py::convert_to_ndc (near 1) of rays from one origin
        [3] along d_world [..., 3], on the device: (o_ndc, d_ndc). Mirrors
        the JAX renderer's rounding: XLA fuses the near-plane shift into an
        FMA; the divisions are true f32 divisions (by `consts`' device
        scalars)."""
        fx2w, fy2h, two = consts["fx2w"], consts["fy2h"], consts["two"]
        ow = origin.expand(d_world.shape)
        tshift = -(1.0 + ow[..., 2]) / d_world[..., 2]
        ow = _fma(tshift[..., None], d_world, ow)
        oz = ow[..., 2]
        o_ndc = torch.stack(
            [-fx2w * ow[..., 0] / oz, -fy2h * ow[..., 1] / oz, 1.0 + two / oz], dim=-1
        )
        d_ndc = torch.stack(
            [
                -fx2w * (d_world[..., 0] / d_world[..., 2] - ow[..., 0] / oz),
                -fy2h * (d_world[..., 1] / d_world[..., 2] - ow[..., 1] / oz),
                -two / oz,
            ],
            dim=-1,
        )
        return o_ndc, d_ndc

    def make_tile_inputs_fn(self, height, width, fx, rcap, w1cap, ccap=None, tiles=None,
                            device=None):
        """Returns fn (c2w, csr, base, extra_data, blk_bbox) ->
        (p2_args, n_total [T], n_pieces_pre [T], w1_over [T]): ray
        generation in quad-major tile order, tree-space transforms, colour
        basis and the phase-1 frustum walk, all on `device` (default: the
        renderer's), whose copies of csr, base, extra_data and blk_bbox the
        caller passes. p2_args is the kernel's argument tuple without the
        soa. `tiles` = (t0, t1) restricts it to that range of the frame's
        tiles (T = t1 - t0); each tile's inputs do not depend on the
        range. Traced as `tile.inputs`."""
        del rcap  # the flat-lattice phase 1 never truncates runs
        inputs = self._inputs_fn(height, width, fx, w1cap, ccap, tiles, device)

        def tile_inputs(c2w, csr, base, extra_data, blk_bbox):
            with tracing.span("tile.inputs") as s:
                p2_args, n_total, n_pieces_pre, w1_over, nck = inputs(
                    c2w, csr, base, extra_data, blk_bbox
                )
                if s:  # the chunks handed to the kernel and their live rows
                    s.count(pieces=nck.sum(), rows=_live_rows(*p2_args[1:4], self.quantum).sum())
                return p2_args, n_total, n_pieces_pre, w1_over

        return tile_inputs

    def _inputs_fn(self, height, width, fx, w1cap, ccap=None, tiles=None, device=None):
        """`make_tile_inputs_fn`'s fn untraced, which also returns nck [T],
        the pieces handed to the kernel per tile. Its c2w is a pose, taken
        as is when it is an f32 tensor on `device` (a captured frame's pose
        buffer) and made one otherwise."""
        ccap = ccap or self.ccap
        TILE = self.tile
        RAYS_T = self.rays
        hp = -(-height // TILE) * TILE
        wp = -(-width // TILE) * TILE
        tile_lo, tile_hi = tiles or (0, (hp // TILE) * (wp // TILE))
        n_tiles = tile_hi - tile_lo
        dev = self.device if device is None else torch.device(device)
        own = self._arrays_on(dev, ("offset", "invradius", "margin"))
        offset, invradius, margin = own["offset"], own["invradius"], own["margin"]
        consts = self._constants(dev, fx)
        corners, gc_idx, fx_t = consts["corners"], consts["gc_idx"], consts["fx"][float(fx)]
        Q = TILE // 2

        def inputs(c2w, csr, base, extra_data, blk_bbox):
            if not (isinstance(c2w, torch.Tensor) and c2w.device == dev and c2w.dtype == _F32):
                c2w = torch.tensor(np.asarray(c2w, np.float32), device=dev)
            tiles_x = wp // TILE
            t_idx = torch.arange(tile_lo, tile_hi, dtype=_I32, device=dev)[:, None]
            r_idx = torch.arange(RAYS_T, dtype=_I32, device=dev)[None, :]
            qi = r_idx // (Q * Q)
            rr = r_idx % (Q * Q)
            y = (t_idx // tiles_x) * TILE + (qi // 2) * Q + rr // Q
            x = (t_idx % tiles_x) * TILE + (qi % 2) * Q + rr % Q
            xf = x.to(_F32).clamp(max=width - 1.0)
            yf = y.to(_F32).clamp(max=height - 1.0)
            cam_dirs = torch.stack(
                [
                    (xf - width * 0.5) / fx_t,
                    -(yf - height * 0.5) / fx_t,
                    -torch.ones_like(xf),
                ],
                dim=-1,
            )  # [T, RAYS, 3]
            rot = c2w[:3, :3]
            # f32 rotation as XLA's dot computes it: an FMA chain over j.
            d_world = _fma(
                rot[:, 2],
                cam_dirs[..., 2:3],
                _fma(rot[:, 1], cam_dirs[..., 1:2], rot[:, 0] * cam_dirs[..., 0:1]),
            )
            if self.ndc is not None:
                # convert_to_ndc (near 1) on the device: shift each ray to
                # the near plane, then project; origins become per ray.
                o_space, d_world = self._to_ndc(c2w[:3, 3], d_world, consts)
                o = _fma(o_space, invradius, offset)
            else:
                o = (c2w[:3, 3] * invradius + offset).expand(d_world.shape)
            viewdirs = d_world / _norm3(d_world)[..., None]
            d = viewdirs * invradius
            delta_scale = 1.0 / _norm3(d)
            dn = d * delta_scale[..., None]
            # Floor |dn| at 1e-6 (sign-preserving), not lower: the kernel's
            # slab test runs as box*invd - o*invd, which cancels badly in
            # f32 for huge invd (exactly axis-aligned rays: every NDC ray of
            # a fronto-parallel camera; the JAX package measured +-60
            # t-units of error at a 1e-9 floor). A ray with |dn| < 1e-6
            # drifts < 2e-6 across the unit box, far inside a cell.
            safe_dn = torch.where(
                dn.abs() < 1e-6, torch.where(dn < 0, -1e-6, 1e-6), dn
            )
            invd = 1.0 / safe_dn
            t0 = (0.0 - o) * invd
            t1 = (1.0 - o) * invd
            tmin = torch.minimum(t0, t1).amax(-1).clamp(min=0.0) + 1e-5
            tmax = torch.maximum(t0, t1).amin(-1) - 1e-5
            basis = _ray_basis(
                self.fmt, self.basis_dim, viewdirs.reshape(-1, 3), extra_data
            ).reshape(n_tiles, RAYS_T, -1)

            ray_ok = tmax > tmin
            any_hit = ray_ok.any(1)
            span_lo = torch.where(ray_ok, tmin, float("inf")).amin(1)
            span_hi = torch.where(ray_ok, tmax, float("-inf")).amax(1)

            if self.ndc is not None:
                gplanes, goff = _segment_aabb_planes(
                    o, dn, tmin, tmax, ray_ok, Q, consts["axnorm"]
                )
            else:
                # Quad-group frustum planes through the shared apex,
                # oriented inward via the quad's mean direction.
                gdirs = dn[:, gc_idx].reshape(n_tiles, 4, 4, 3)
                A, B, Cq, D = (gdirs[:, :, k] for k in range(4))
                nrm = torch.stack(
                    [_cross(A, B), _cross(B, D), _cross(D, Cq), _cross(Cq, A)], dim=2
                )  # [T, 4 groups, 4 planes, 3]
                dmean_g = gdirs.mean(dim=2)
                sgn_n = torch.sign((nrm * dmean_g[:, :, None, :]).sum(-1, keepdim=True))
                nrm = nrm * torch.where(sgn_n == 0, 1.0, sgn_n)
                nrm = nrm / (_norm3(nrm)[..., None] + 1e-12)
                gplanes = nrm.reshape(n_tiles, 16, 3)
                goff = _dot3(gplanes, o[:, 0][:, None, :])  # n . apex

            (
                chunk_c0, chunk_lo, chunk_hi, chunk_mask, n_kept_p,
                n_total, w1_over, n_pieces_pre,
            ) = _phase1(
                csr, base, margin, blk_bbox,
                o[:, corners], dn[:, corners],
                gplanes, goff, span_lo, span_hi, any_hit,
                grid_c=self.grid_c, fine_c2=self.fine_c2, w1cap=w1cap,
                quantum=self.quantum, ccap=ccap, consts=consts,
            )
            nck = n_kept_p.clamp(max=ccap).to(_I32)
            z = torch.zeros_like(nck)
            meta = torch.stack([nck, z, z, z], dim=-1)[:, None, :]
            mean_d = dn.mean(dim=1)
            mdir = torch.cat(
                [mean_d, torch.zeros(n_tiles, 1, dtype=_F32, device=dev)], dim=-1
            )[:, None, :]
            aux = torch.stack([delta_scale, tmin, tmax, torch.zeros_like(tmin)], dim=-1)
            pad1 = torch.zeros(n_tiles, RAYS_T, 1, dtype=_F32, device=dev)
            p2_args = (
                meta.contiguous(),
                chunk_c0[:, None, :].contiguous(),
                chunk_lo[:, None, :].contiguous(),
                chunk_hi[:, None, :].contiguous(),
                chunk_mask[:, None, :].contiguous(),
                torch.cat([o, pad1], dim=-1),
                torch.cat([invd, pad1], dim=-1),
                aux.contiguous(),
                mdir.contiguous(),
                basis.contiguous(),
            )
            return p2_args, n_total, n_pieces_pre, w1_over, nck

        return inputs

    # -- whole frame ----------------------------------------------------------

    def render_persp_async(self, c2w, height, width, fx):
        """Enqueue one frame on the device (tile inputs, the compositing
        kernel, image assembly) without waiting for it. Returns device
        tensors (img, n_max, nc_max, w1_max), or one packed uint8 payload
        (image + those three int32s) for output="u8". The ccap/w1cap checks
        run at fetch time (`_fetch`, `_check_caps`). A replayed frame's
        results are copies of the graph's buffers, so results still
        outstanding are distinct frames."""
        out, replayed = self._enqueue(c2w, height, width, fx)
        if not replayed:
            return out
        return out.clone() if self.output == "u8" else tuple(t.clone() for t in out)

    def _enqueue(self, c2w, height, width, fx):
        """One attempt at a frame on the device, traced as `tile.render`.

        Eager on the CPU and over a mesh. On one CUDA slot, keyed on
        (height, width, fx, w1cap, ccap) by the renderer's Policy
        (utils/graphs.py, keeping one graph): a replay of the frame graph
        captured under the key, counted as `replays`. Without one, a graph
        under another key is released; then an attempt under the key of the
        eager attempt before it captures and replays (counted as
        `captures`), and any other attempt runs eagerly. So only traffic
        whose key comes back pays for a capture: not a renderer that serves
        one frame, a viewer whose size or focal changes every frame, or the
        re-render after a cap regrowth. Returns (the results as
        `render_persp_async` gives them, whether they are the graph's
        static outputs)."""
        if self.w1cap is None:
            self.w1cap = int(
                min(
                    self.grid_c,
                    np.ceil(np.sqrt(3) * self.tile / fx * self.grid_c) + 3,
                )
            )
        with tracing.span("tile.render") as s:
            key = (height, width, float(fx), self.w1cap, self.ccap)
            graph = self._policy and self._policy.attempt(key, lambda: _FrameGraph(self, key), s)
            if graph is None:
                return self._eager(c2w, height, width, fx), False
            return graph.replay(c2w), True

    def _eager(self, c2w, height, width, fx):
        """The eager chain of one attempt: each slot's tile inputs and
        compositing, then the assembly."""
        parts = self._render_ranges(c2w, height, width, fx)
        with tracing.span("tile.assemble"):
            return self._assemble(parts, height, width)

    def _assemble(self, parts, height, width):
        """`_render_ranges`'s parts -> the u8 payload (image, then n_max,
        nc_max, w1_max as int32s), or (image [height, width, nc] f32, n_max,
        nc_max, w1_max as 0-d int32) for output="f32"."""
        TILE = self.tile
        hp = -(-height // TILE) * TILE
        wp = -(-width // TILE) * TILE
        nc = self.n_channels
        out, maxima = self._gather(parts)
        rgb = out[:, :, :nc]
        light = out[:, :, nc]
        img = rgb + light[..., None] * self.opts.background_brightness
        img = _untile(img, hp, wp, TILE)[:height, :width]
        if self.output == "u8":
            img8 = torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
            tail = maxima.view(torch.uint8)
            return torch.cat([img8.reshape(-1), tail])
        return (img, *maxima)

    def tile_ranges(self, height, width):
        """[(device, replicas, stream, (t0, t1))]: each slot's contiguous
        tile range, ceil(tiles / devices) tiles each (the tile axis padded
        to a device multiple; the whole frame with no mesh); a device past
        the last tile gets none."""
        n_tiles = (-(-height // self.tile)) * (-(-width // self.tile))
        k = -(-n_tiles // len(self._slots))
        return [(d, rep, stream, (i * k, min((i + 1) * k, n_tiles)))
                for i, (d, rep, stream) in enumerate(self._slots) if i * k < n_tiles]

    def _render_ranges(self, c2w, height, width, fx):
        """Phase 1 and the compositing of each slot's tile range on its
        device (over a mesh on its own stream on a GPU, every range launched
        before any is gathered); returns [(composited tiles, (n_total,
        n_chunks, w1_over) per tile, stream)], one per slot, for `_gather`."""
        main = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        parts = []
        for dev, rep, stream, tiles in self.tile_ranges(height, width):
            ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
            if stream is not None:
                stream.wait_stream(main)
            with ctx:
                tile_inputs = self.make_tile_inputs_fn(
                    height, width, fx, self.rcap, self.w1cap, self.ccap, tiles=tiles, device=dev
                )
                p2_args, n_total, n_chunks, w1_over = tile_inputs(
                    c2w, rep["csr"], rep["base"], rep["extra_data"], rep["blk_bbox"]
                )
                out = composite_tiles(*p2_args, rep["soa"], **self._kernel_kw)
            parts.append((out, (n_total, n_chunks, w1_over), stream))
        return parts

    def _gather(self, parts):
        """The composited tiles [tiles, RAYS, 8] of `_render_ranges`'s parts
        and the frame's int32 [n_max, nc_max, w1_over] (maxima over the
        tiles, each part's on its own stream) on the first device."""
        main = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        outs, maxima = [], []
        for out, counts, stream in parts:
            ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
            with ctx:
                mx = torch.stack([t.max().to(_I32) for t in counts])
            if stream is not None:
                main.wait_stream(stream)
                out.record_stream(main)
                mx.record_stream(main)
            outs.append(out.to(self.device, non_blocking=True))
            maxima.append(mx.to(self.device, non_blocking=True))
        if len(outs) == 1:
            return outs[0], maxima[0]
        return torch.cat(outs), torch.stack(maxima).amax(0)

    def _fetch(self, out, height, width):
        """Device payload -> (img, n_max, nc_max, w1_over) on the host."""
        with tracing.span("tile.fetch"):
            if self.output == "u8":
                payload = out.cpu().numpy()
                img = payload[:-12].reshape(height, width, self.n_channels)
                n_max, nc_max, w1_over = (int(x) for x in payload[-12:].view(np.int32))
            else:
                img, n_max, nc_max, w1_over = out
                img = img.cpu().numpy()
                n_max, nc_max, w1_over = int(n_max), int(nc_max), int(w1_over)
        return img, n_max, nc_max, w1_over

    def _check_caps(self, n_max, nc_max, w1_over):
        """Grow ccap/w1cap on saturation. Returns True if a re-render is
        needed (the frame dropped geometry). n_max (valid runs per tile) is
        informational only: the flat-lattice phase 1 has no run cap."""
        del n_max
        regrow = False
        if w1_over > 0:
            # Undersized lateral-1 window (camera far outside the volume):
            # regrow with 25% headroom so an orbit settles in one step.
            self.w1cap = int(
                min(
                    self.grid_c,
                    self.w1cap + w1_over + max(2, self.w1cap // 4),
                )
            )
            regrow = True
        if nc_max > self.ccap:
            if self.ccap >= 16384:
                warnings.warn(
                    f"tile chunk capacity clipped at {self.ccap} (< {nc_max}): "
                    "frame rendered with truncated geometry"
                )
            else:
                self.ccap = int(min(16384, 2 * self.ccap))
                regrow = True
        return regrow

    def render_persp(self, c2w, height, width, fx):
        """Render an image [H, W, nc] (numpy; float32, or uint8 when the
        renderer was constructed with output="u8"). Traced as one
        `tile.frame` span (request id: this renderer's frame number) over a
        `tile.render` and a `tile.fetch` per attempt: a cap regrowth shows as
        a second pair. On one CUDA slot an attempt may replay a captured
        frame graph (`_enqueue`); `_fetch` copies its static outputs into
        arrays of the caller's."""
        self.frames += 1
        with tracing.span("tile.frame", request=self.frames):
            while True:
                out, _ = self._enqueue(c2w, height, width, fx)
                img, n_max, nc_max, w1_over = self._fetch(out, height, width)
                if not self._check_caps(n_max, nc_max, w1_over):
                    return img
                # Sticky growth: the larger caps persist for later frames.
