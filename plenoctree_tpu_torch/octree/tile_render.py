"""Tile-frustum PlenOctree renderer — the serving path, in PyTorch + CUDA.

Port of plenoctree_tpu/octree/tile_render.py (see its docstring for the
algorithm). The three stages keep their JAX structure:

  * Build (host numpy, per scene): `build_tile_index` — every leaf above
    the sigma threshold is split into clipped replicas, one per coarse
    C^3 cell it overlaps, sorted in three axis-major orders, and laid out
    as a blocked soa [n_blk, fields, quantum]. Returns numpy; the renderer
    moves the arrays it needs to its device.
  * Phase 1 (PyTorch on the device, all tiles at once): the per-tile
    frustum walk through the grid giving tight contiguous row ranges,
    window-merged runs and quantum-aligned piece descriptors with 4-bit
    quad-group masks. `jax.vmap` becomes a leading tile dimension; the
    stable `lax.sort` compactions become `torch.sort(stable=True)`; the
    one-hot f32 matmul that expands runs into pieces becomes a
    searchsorted + gather. The piece lists are identical to the JAX ones.
  * Phase 2 (the CUDA kernel, kernels/tile_composite.py): composite every
    tile's pieces.

Unported here (raise NotImplementedError): the NDC branch (LLFF
forward-facing scenes) and multi-device sharding (`mesh`). ROADMAP.md lists
both.
"""

import warnings

import numpy as np
import torch

from plenoctree_tpu_torch.kernels.tile_composite import _fma, composite_tiles
from plenoctree_tpu_torch.octree.renderer import RenderOptions, _norm3, _ray_basis, resolve_device

TILE = 16  # pixels per tile side (256 rays)
RUNROWS = 128  # default instance rows per compute chunk
# Same layout version as the JAX package: one index serves both.
INDEX_FORMAT_VERSION = 6
# Axis copies are padded to a COPY_PAD multiple so one index serves any
# runrows <= COPY_PAD.
COPY_PAD = 1024

_F32 = torch.float32
_I32 = torch.int32


# ---------------------------------------------------------------------------
# Build: clipped instance replication, 3 axis-major sort orders (host numpy)
# ---------------------------------------------------------------------------


def build_tile_index(
    tree, sigma_thresh=0.0, grid_c=64, fine_c2=None, runrows=RUNROWS,
    keep_all=False, quantum=128,
):
    """Host-side per-scene preprocessing (numpy; bit-identical to the JAX
    package's build_tile_index, which returns jax arrays for some keys).

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
    leaves = tree._leaf_nodes()
    corner = tree._cell_corner(leaves).astype(np.float64)
    size = tree._cell_size(leaves).astype(np.float64)
    data = tree.data[leaves[:, 0], leaves[:, 1], leaves[:, 2], leaves[:, 3]].astype(
        np.float32
    )
    sigma = data[:, -1]
    if keep_all:
        keep = np.ones(sigma.shape, bool)
    else:
        keep = (sigma > 0.0) & (sigma > sigma_thresh)
    corner, size, data = corner[keep], size[keep], data[keep]

    C = grid_c
    c2 = fine_c2 or 4 * C
    lo_cell = np.clip((corner * C).astype(np.int64), 0, C - 1)
    hi_cell = np.clip(
        np.ceil((corner + size[:, None]) * C).astype(np.int64) - 1, 0, C - 1
    )
    span = hi_cell - lo_cell + 1

    max_span = int(span.max()) if span.size else 1
    # Only leaves wider than one coarse cell have replicas past (0, 0, 0):
    # scanning just those keeps the build linear in the leaf count where a
    # keep_all index holds a few large empty leaves (max_span up to C/2).
    # Same instances, in the same order, as scanning every leaf.
    wide = np.nonzero(span.max(axis=1) > 1)[0]
    span_w = span[wide]
    inst_leaf, inst_vox = [], []
    for dx in range(max_span):
        for dy in range(max_span):
            for dz in range(max_span):
                if dx == dy == dz == 0:
                    idx = np.arange(span.shape[0])
                else:
                    idx = wide[(dx < span_w[:, 0]) & (dy < span_w[:, 1]) & (dz < span_w[:, 2])]
                if idx.size == 0:
                    continue
                inst_leaf.append(idx)
                inst_vox.append(lo_cell[idx] + np.array([dx, dy, dz])[None, :])
    if inst_leaf:
        inst_leaf = np.concatenate(inst_leaf)
        inst_vox = np.concatenate(inst_vox, axis=0)
    else:
        inst_leaf = np.zeros(0, np.int64)
        inst_vox = np.zeros((0, 3), np.int64)
    n = inst_leaf.shape[0]

    box_lo = np.maximum(corner[inst_leaf], inst_vox / C)
    box_hi = np.minimum(
        (corner + size[:, None])[inst_leaf], (inst_vox + 1) / C
    )
    d_cols = data.shape[1]
    rows = np.zeros((n, 6 + d_cols), np.float32)
    rows[:, 0:3] = box_lo
    rows[:, 3:6] = box_hi
    rows[:, 6:] = data[inst_leaf]

    del runrows  # layout is chunking-independent (see COPY_PAD)
    npad = max(-(-n // COPY_PAD) * COPY_PAD, COPY_PAD)
    if 3 * npad >= 2**24:
        # Kept from the JAX package so both accept the same trees: its
        # phase 1 moves row ids through f32 one-hot matmuls.
        raise ValueError(
            f"tile index too large: 3*npad = {3*npad} >= 2^24 rows; phase-1 "
            "one-hot matmul compaction would lose integer exactness."
        )
    fpad = -(-(6 + d_cols) // 8) * 8
    soa = np.zeros((fpad, 3 * npad), np.float32)
    csr = np.zeros((3, C * C * c2 + 1), np.int64)
    base = np.array([0, npad, 2 * npad], np.int64)
    margin = np.zeros(3, np.float32)
    n_kept = int(keep.sum())
    col_leaf = np.full(3 * npad, n_kept, np.int32)
    ctr = 0.5 * (box_lo + box_hi)
    ext = box_hi - box_lo
    nblk = npad // quantum
    blk_bbox = np.zeros((3 * nblk, 8), np.float32)
    blk_bbox[:, 0:3] = np.inf
    blk_bbox[:, 3:6] = -np.inf
    for axis in range(3):
        p = (axis, (axis + 1) % 3, (axis + 2) % 3)
        v2 = np.clip((ctr[:, p[2]] * c2).astype(np.int64), 0, c2 - 1)
        key = (inst_vox[:, p[0]] * C + inst_vox[:, p[1]]) * c2 + v2
        order = np.argsort(key, kind="stable")
        soa[: 6 + d_cols, axis * npad : axis * npad + n] = rows[order].T
        col_leaf[axis * npad : axis * npad + n] = inst_leaf[order]
        count = np.bincount(key, minlength=C * C * c2)
        csr[axis, 1:] = np.cumsum(count)
        margin[axis] = 0.5 * float(ext[:, p[2]].max()) if n else 0.0
        lo_s = np.full((npad, 3), np.inf, np.float32)
        hi_s = np.full((npad, 3), -np.inf, np.float32)
        lo_s[:n] = rows[order][:, 0:3]
        hi_s[:n] = rows[order][:, 3:6]
        blk_bbox[axis * nblk : (axis + 1) * nblk, 0:3] = lo_s.reshape(
            nblk, quantum, 3
        ).min(axis=1)
        blk_bbox[axis * nblk : (axis + 1) * nblk, 3:6] = hi_s.reshape(
            nblk, quantum, 3
        ).max(axis=1)
    soa3 = np.ascontiguousarray(
        soa.reshape(fpad, 3 * npad // quantum, quantum).transpose(1, 0, 2)
    )
    return {
        "col_leaf": col_leaf,
        "n_kept": n_kept,
        "keep_mask": keep,
        "blk_bbox": blk_bbox,
        "blk_quantum": quantum,
        "soa": soa3,
        "csr": csr.astype(np.int32),
        "base": base.astype(np.int32),
        "margin": margin,
        "grid_c": C,
        "fine_c2": c2,
        "n_instances": n,
        "sigma_row": 6 + d_cols - 1,
    }


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


def _floor_to_i32(x, lo, hi):
    """floor(x) as int32 clipped to [lo, hi] (clipped in float first, so
    out-of-range values never reach an undefined float->int conversion)."""
    return torch.floor(x).clamp(lo - 1, hi + 1).to(_I32).clamp(lo, hi)


# ---------------------------------------------------------------------------
# Phase 1: per-tile frustum walk -> compacted contiguous row ranges
# ---------------------------------------------------------------------------


def _phase1(
    csr, base, margin, blk_bbox, o4, d4, gplanes, goff, span_lo, span_hi,
    any_hit, grid_c, fine_c2, w1cap, quantum, ccap,
):
    """All tiles' candidate row ranges, front-to-back slab order.

    Batched port of the JAX `_phase1` (which is vmapped over tiles): every
    per-tile tensor here has a leading tile dimension T. o4/d4 [T, 4, 3]
    are the tile's corner rays (tree space, unit dn); gplanes [T, 16, 3] /
    goff [T, 16] the quad-group half-spaces; span_lo/span_hi/any_hit [T].
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
    eps = torch.tensor(1e-2, dtype=_F32, device=dev)
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
    ii = torch.as_tensor(_SEG_II, device=dev)
    jj = torch.as_tensor(_SEG_JJ, device=dev)
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
    eps2 = torch.tensor(2e-2, dtype=_F32, device=dev)
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
    bits = torch.tensor([1, 2, 4, 8], dtype=_I32, device=dev)
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
        if ndc is not None:
            raise NotImplementedError(
                "NDC (LLFF forward-facing) tile serving is not ported yet; "
                "see ROADMAP.md"
            )
        if mesh is not None:
            raise NotImplementedError(
                "multi-device tile serving (mesh / --shard_devices) is not "
                "ported yet; see ROADMAP.md"
            )
        self.device = resolve_device(device, "TileRenderer")
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
        else:
            index = build_tile_index(
                tree, sigma_thresh, grid_c, fine_c2, runrows, quantum=quantum
            )
        dev = self.device
        self.index = dict(index)
        for k in ("soa", "blk_bbox", "margin"):
            self.index[k] = torch.as_tensor(index[k], dtype=_F32).to(dev).contiguous()
        for k in ("csr", "base"):
            self.index[k] = torch.as_tensor(index[k], dtype=_I32).to(dev).contiguous()
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
        self.output = output
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

    # -- tile inputs: ray generation, tree-space transform, phase 1 ---------

    def make_tile_inputs_fn(self, height, width, fx, rcap, w1cap, ccap=None):
        """Returns fn (c2w, csr, base, extra_data, blk_bbox) ->
        (p2_args, n_total [T], n_pieces_pre [T], w1_over [T]): ray
        generation in quad-major tile order, tree-space transforms, colour
        basis and the phase-1 frustum walk, all on the renderer's device.
        p2_args is the kernel's argument tuple without the soa."""
        ccap = ccap or self.ccap
        TILE = self.tile
        RAYS_T = self.rays
        hp = -(-height // TILE) * TILE
        wp = -(-width // TILE) * TILE
        n_tiles = (hp // TILE) * (wp // TILE)
        dev = self.device
        corners = torch.as_tensor(_tile_corner_idx(TILE), device=dev).long()
        Q = TILE // 2
        gc_idx = torch.as_tensor(
            (np.arange(4)[:, None] * Q * Q + _GROUP_CORNER_OFF(Q)[None, :]).reshape(-1),
            device=dev,
        ).long()  # [16] quad-group corner ray indices
        del rcap  # the flat-lattice phase 1 never truncates runs
        # A device scalar: dividing by a host scalar would become a multiply
        # by its reciprocal on the GPU, and rays would round differently.
        fx_t = torch.tensor(float(fx), dtype=_F32, device=dev)

        def tile_inputs(c2w, csr, base, extra_data, blk_bbox):
            c2w = torch.tensor(np.asarray(c2w, np.float32), device=dev)
            tiles_x = wp // TILE
            t_idx = torch.arange(n_tiles, dtype=_I32, device=dev)[:, None]
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
            viewdirs = d_world / _norm3(d_world)[..., None]
            o = (c2w[:3, 3] * self.invradius + self.offset).expand(d_world.shape)
            d = viewdirs * self.invradius
            delta_scale = 1.0 / _norm3(d)
            dn = d * delta_scale[..., None]
            # Floor |dn| at 1e-6 (sign-preserving): the kernel's slab test
            # runs as box*invd - o*invd, which cancels badly for huge invd.
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

            # Quad-group frustum planes through the shared apex, oriented
            # inward via the quad's mean direction.
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
                csr, base, self.index["margin"], blk_bbox,
                o[:, corners], dn[:, corners],
                gplanes, goff, span_lo, span_hi, any_hit,
                grid_c=self.grid_c, fine_c2=self.fine_c2, w1cap=w1cap,
                quantum=self.quantum, ccap=ccap,
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
            return p2_args, n_total, n_pieces_pre, w1_over

        return tile_inputs

    # -- whole frame ----------------------------------------------------------

    def render_persp_async(self, c2w, height, width, fx):
        """Enqueue one frame on the device (tile inputs, the compositing
        kernel, image assembly) without waiting for it. Returns device
        tensors (img, n_max, nc_max, w1_max), or one packed uint8 payload
        (image + those three int32s) for output="u8". The ccap/w1cap checks
        run at fetch time (`_fetch`, `_check_caps`)."""
        if self.w1cap is None:
            self.w1cap = int(
                min(
                    self.grid_c,
                    np.ceil(np.sqrt(3) * self.tile / fx * self.grid_c) + 3,
                )
            )
        TILE = self.tile
        hp = -(-height // TILE) * TILE
        wp = -(-width // TILE) * TILE
        nc = self.n_channels
        idx = self.index
        tile_inputs = self.make_tile_inputs_fn(
            height, width, fx, self.rcap, self.w1cap, self.ccap
        )
        p2_args, n_total, n_chunks, w1_over = tile_inputs(
            c2w, idx["csr"], idx["base"], self.extra_data, idx["blk_bbox"]
        )
        out = composite_tiles(*p2_args, idx["soa"], **self._kernel_kw)
        rgb = out[:, :, :nc]
        light = out[:, :, nc]
        img = rgb + light[..., None] * self.opts.background_brightness
        img = _untile(img, hp, wp, TILE)[:height, :width]
        n_max = n_total.max()
        nc_max = n_chunks.max()
        w1_max = w1_over.max().to(_I32)
        if self.output == "u8":
            img8 = torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
            tail = torch.stack([n_max, nc_max, w1_max]).to(_I32).view(torch.uint8)
            return torch.cat([img8.reshape(-1), tail])
        return img, n_max, nc_max, w1_max

    def _fetch(self, out, height, width):
        """Device payload -> (img, n_max, nc_max, w1_over) on the host."""
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
        renderer was constructed with output="u8")."""
        while True:
            out = self.render_persp_async(c2w, height, width, fx)
            img, n_max, nc_max, w1_over = self._fetch(out, height, width)
            if not self._check_caps(n_max, nc_max, w1_over):
                return img
            # Sticky growth: the larger caps persist for later frames.
