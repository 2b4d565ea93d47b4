"""Two-phase deferred octree rendering: march, then shade.

Port of plenoctree_tpu/octree/march.py, for evaluation (`DeferredRenderer`,
behind `VolumeRenderer.render_persp`) and optimization (`shade`, see
octree/optimize.py). renderer.render_rays stays the parity oracle.

  Phase 1 — march (no gradient): each step gathers one i32 accel-grid word
  and one f32 from a sigma-only table (~50x narrower than the leaf data).
  Cells with sigma above the threshold are pushed into K per-ray
  contributor slots (cell id + world-scale delta_t). svox semantics:
  sigma < thresh cells are skipped entirely (neither colour nor
  attenuation), light below stop_thresh stops the ray.

  Phase 2 — shade (differentiable): ONE gather of full data rows for the
  contributor slots, exact transmittance compositing over the slots, the
  per-ray SH/SG basis dot, sigmoid. Gradients w.r.t. leaf data flow
  through this gather (autograd: a scatter-add) and through sigma ->
  weights, as in svox's backward, which also touches only marched cells.

`march_while` is a Python loop of at most `cap` steps of torch ops. The
JAX while_loop leaves as soon as every ray is dead; here that test runs
every `CHECK_EVERY` steps (one host sync each), and the steps in between
change nothing for dead rays, so the result is the same. The slot write is
an indexed write at each ray's `count`, not the JAX package's one-hot
select over all K slots (same values, one element per ray instead of the
whole [R, K] slot arrays each step).

The pass schedule, the factor-4 bucket ladder, the padding and the
retirement rule of `DeferredRenderer.render_chunk` are the JAX package's:
rays whose light lies in (stop_thresh, 1e-4] keep marching only while they
share a bucket with live rays, so the image depends on that ladder at the
1e-4 level, and the port keeps it.
"""

import warnings

import numpy as np
import torch

from plenoctree_tpu_torch.octree.renderer import (
    _exit_delta,
    _gather,
    _decode_rgb,
    _locate,
    _prep_rays,
    _ray_position,
    split_arrays,
)

K_STRIP = 8  # shading strip width (slots per strip)
CHECK_EVERY = 8  # march steps between two all-dead checks
K_MAX = 2048  # contributor slots at which regrowth stops, with a warning

_F32 = torch.float32
_I32 = torch.int32


def init_carry(rp, n_rays, K):
    """March carry: (t, light, count, cells [R,K], dts [R,K])."""
    tmin = rp[4]
    dev = tmin.device
    return {
        "t": tmin.clone(),
        "light": torch.ones_like(tmin),
        "count": torch.zeros((n_rays,), dtype=_I32, device=dev),
        "cells": torch.zeros((n_rays, K), dtype=_I32, device=dev),
        "dts": torch.zeros((n_rays, K), dtype=_F32, device=dev),
    }


def _alive(rp, carry, floor, K):
    return (carry["t"] <= rp[5]) & (carry["light"] > floor) & (carry["count"] < K)


@torch.no_grad()
def march_while(tables, rp, carry, meta, opts, cap):
    """Advance every ray until it is done (left the volume, saturated or
    slots full) or `cap` segments elapsed; updates `carry` in place and
    returns it."""
    sigma_tab = tables["sigma"]
    o, dn, safe_dn, delta_scale, _, tmax, _ = rp
    t, light, count = carry["t"], carry["light"], carry["count"]
    cells, dts = carry["cells"], carry["dts"]
    K = cells.shape[1]
    zero = torch.zeros((), dtype=_F32, device=t.device)
    i = 0
    while i < cap and bool(_alive(rp, carry, opts.stop_thresh, K).any()):
        for _ in range(min(CHECK_EVERY, cap - i)):
            active = _alive(rp, carry, opts.stop_thresh, K)
            pos = torch.where(active[..., None], _ray_position(t, dn, o), zero)
            cell, corner, size = _locate(tables, meta, pos)
            sigma = torch.maximum(_gather(sigma_tab, cell), zero)
            delta_t = _exit_delta(pos, corner, size, safe_dn, opts.step_size)

            keep = (sigma > 0.0) & (sigma >= opts.sigma_thresh)
            att = torch.where(keep, torch.exp(-delta_t * delta_scale * sigma), 1.0)
            push = active & keep
            # Write slot `count` of the rays that push; the others write
            # back what the slot holds (count may equal K: clamped).
            slot = count.clamp(max=K - 1)[:, None].long()
            cells.scatter_(1, slot, torch.where(push[:, None], cell[:, None], cells.gather(1, slot)))
            dts.scatter_(
                1, slot, torch.where(push[:, None], (delta_t * delta_scale)[:, None], dts.gather(1, slot))
            )
            t.copy_(torch.where(active, t + delta_t, t))
            light.copy_(torch.where(active, light * att, light))
            count.add_(push.to(_I32))
        i += min(CHECK_EVERY, cap - i)
    return carry


def alive_mask(rp, carry, opts, K):
    return _alive(rp, carry, max(opts.stop_thresh, 1e-4), K)


def overflow_mask(rp, carry, opts, K):
    """Rays that filled all K contributor slots while still inside the
    volume and unsaturated: their composite would show background through
    unmarched geometry. Callers regrow K on this."""
    return (
        (carry["t"] <= rp[5])
        & (carry["light"] > max(opts.stop_thresh, 1e-4))
        & (carry["count"] >= K)
    )


def estimate_contrib_slots(tree, sigma_thresh=0.0, floor=64, cap=K_MAX):
    """Size the contributor-slot count K from tree statistics up front
    (host numpy; the JAX package's estimate, so both packages start from
    the same K).

    A ray stops filling slots when it leaves the volume OR saturates
    (alive_mask: light <= max(stop_thresh, 1e-4)), so the bound is the
    number of occupied cells along a line until the cumulative optical
    depth reaches -log(1e-4). Estimated per axis-aligned column at the leaf
    grid, both directions, max over the three axes, x sqrt(3) for
    diagonals, rounded up to a power of two; regrowth stays the backstop.
    """
    leaves = tree._leaf_nodes()
    if leaves.shape[0] == 0:
        return floor
    sigma = tree.data[
        leaves[:, 0], leaves[:, 1], leaves[:, 2], leaves[:, 3], -1
    ].astype(np.float64)
    keep = sigma > max(float(sigma_thresh), 0.0)
    if not keep.any():
        return floor
    reso = int(tree.N) ** (int(tree.max_depth) + 1)
    corner = tree._cell_corner(leaves[keep])
    size = tree._cell_size(leaves[keep]).astype(np.float64)
    sigma = np.maximum(sigma[keep], 0.0)
    ctr = np.clip(
        ((corner + 0.5 * size[:, None]) * reso).astype(np.int64), 0, reso - 1
    )
    scale = float(np.max(1.0 / np.asarray(tree.invradius, np.float64)))
    od_cap = -np.log(1e-4)  # alive_mask's hard light floor
    m = 0
    for axis in range(3):
        a, b = (axis + 1) % 3, (axis + 2) % 3
        col = ctr[:, a] * reso + ctr[:, b]
        order = np.lexsort((ctr[:, axis], col))
        col_s = col[order]
        contrib = (sigma * size * scale)[order]
        starts_mask = np.r_[True, col_s[1:] != col_s[:-1]]
        seg_id = np.cumsum(starts_mask) - 1
        for c in (contrib, contrib[::-1]):
            sid = seg_id if c is contrib else seg_id[::-1]
            cum = np.cumsum(c)
            excl = cum - c
            smask = np.r_[True, sid[1:] != sid[:-1]]
            base = excl[np.nonzero(smask)[0]][np.cumsum(smask) - 1]
            within = excl - base < od_cap
            counts = np.bincount(sid, weights=within)
            m = max(m, int(counts.max()))
    est = int(np.ceil(np.sqrt(3.0) * m))
    k = max(floor, K_STRIP)
    while k < min(est, cap):
        k *= 2
    return min(k, cap)


def _composite(rows, dts, valid, basis, fmt, basis_dim, light=None):
    """Shared body of `shade` and `shade_strip`: (weighted rgb sum [R, C],
    transmittance after the last slot [R])."""
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    sigma = torch.maximum(rows[..., -1], zero) * valid
    att = torch.exp(-dts * sigma)
    cp = torch.cumprod(att, dim=1)
    t_excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
    if light is not None:
        t_excl = light[:, None] * t_excl
    w = t_excl * (1.0 - att)
    n_channels = (rows.shape[-1] - 1) // basis_dim
    coeffs = rows[..., :-1].reshape(rows.shape[:2] + (n_channels, basis_dim))
    rgb = _decode_rgb(fmt, coeffs, basis)
    return (w[..., None] * rgb).sum(dim=1), cp[:, -1]


def shade(data, cells, dts, count, basis, fmt, basis_dim, bg):
    """Full-K differentiable shading of contributor slots (autograd flows
    to `data` through the row gather). Returns rgb [R, C]."""
    K = cells.shape[1]
    valid = torch.arange(K, dtype=_I32, device=cells.device)[None, :] < count[:, None]
    cells = torch.where(valid, cells, 0)
    rows = _gather(data, cells)  # [R, K, D] — the one big-table gather
    acc, light = _composite(rows, dts, valid, basis, fmt, basis_dim)
    return acc + light[:, None] * bg


def shade_strip(data, cells_s, dts_s, valid_s, basis, light, acc, fmt, basis_dim):
    """One K_STRIP-slot shading step with carried (light, acc)."""
    cells_s = torch.where(valid_s, cells_s, 0)
    rows = _gather(data, cells_s)
    part, cp_last = _composite(rows, dts_s, valid_s, basis, fmt, basis_dim, light)
    return light * cp_last, acc + part


class DeferredRenderer:
    """Pass/compaction loop around march_while + strip shading (the eval
    path). The differentiable path is `shade` called directly
    (octree/optimize.py)."""

    def __init__(self, arrays, fmt, basis_dim, opts, K=64, min_bucket=2048):
        self.tables, self.meta = split_arrays(arrays)
        self.fmt = fmt
        self.basis_dim = basis_dim
        self.opts = opts
        if K % K_STRIP:
            raise ValueError(f"K must be a multiple of {K_STRIP}, got {K}")
        self.K = K
        self.min_bucket = min_bucket
        self.device = self.tables["data"].device

    def _prep(self, origins, dirs):
        dev = self.device
        return _prep_rays(
            self.tables,
            torch.as_tensor(origins, dtype=_F32).to(dev),
            torch.as_tensor(dirs, dtype=_F32).to(dev),
            self.fmt,
            self.basis_dim,
        )

    @torch.no_grad()
    def render_chunk(self, origins, dirs, pass_schedule=(48, 192)):
        """Render one chunk of rays [R, 3] -> colours [R, C] (numpy).

        Each pass is one march_while capped at the schedule value (the last
        value repeats until the segment budget runs out). Between passes:
        one host alive-sync and factor-4 ray compaction. A slot overflow
        doubles K (sticky, up to K_MAX, then a warning) and redoes the
        chunk.
        """
        n = origins.shape[0]
        rp = self._prep(origins, dirs)
        basis = rp[6]
        carry = init_carry(rp, n, self.K)
        dev = self.device
        # Buffers holding finished rays' slots in original order.
        done = {
            "cells": torch.zeros((n, self.K), dtype=_I32, device=dev),
            "dts": torch.zeros((n, self.K), dtype=_F32, device=dev),
            "count": torch.zeros((n,), dtype=_I32, device=dev),
        }
        mapping = np.arange(n)
        cur_rp = rp
        schedule = list(pass_schedule)
        seg_budget = self.opts.max_segments
        pass_i = 0
        bucket = n
        while seg_budget > 0:
            segs = schedule[min(pass_i, len(schedule) - 1)]
            segs = min(segs, max(seg_budget, 1))
            seg_budget -= segs
            pass_i += 1
            carry = march_while(self.tables, cur_rp, carry, self.meta, self.opts, cap=segs)
            flags = torch.cat([
                alive_mask(cur_rp, carry, self.opts, self.K),
                overflow_mask(cur_rp, carry, self.opts, self.K).any()[None],
            ]).cpu().numpy()
            alive, over = flags[:-1], bool(flags[-1])
            if over:
                # Slot overflow: some ray filled all K contributor slots
                # while still inside unsaturated volume — compositing now
                # would show background through unmarched geometry.
                # Sticky-regrow K and redo the chunk exactly.
                if self.K >= K_MAX:
                    warnings.warn(
                        f"march contributor slots clipped at K={self.K}; "
                        "rendering with truncated geometry"
                    )
                else:
                    self.K *= 2
                    return self.render_chunk(origins, dirs, pass_schedule)
            n_alive = int(alive.sum())
            if n_alive == 0:
                break
            new_bucket = bucket
            while n_alive * 4 <= new_bucket and new_bucket // 4 >= self.min_bucket:
                new_bucket //= 4
            if new_bucket < bucket:
                bucket = new_bucket  # the ladder guarantees bucket >= n_alive
                keep = np.nonzero(alive)[0]
                retire = np.nonzero(~alive)[0]
                retire_d = torch.as_tensor(retire).to(dev)
                rows = torch.as_tensor(mapping[retire]).to(dev)
                for k in ("cells", "dts", "count"):
                    done[k][rows] = carry[k][retire_d]
                pad = bucket - keep.size
                sel = np.concatenate([keep, np.repeat(keep[:1], pad)])
                sel_d = torch.as_tensor(sel).to(dev)
                carry = {k: v[sel_d] for k, v in carry.items()}
                cur_rp = tuple(x[sel_d] for x in cur_rp)
                mapping = mapping[sel]
        # Stash whatever is left (duplicated padding rows hold equal values).
        rows = torch.as_tensor(mapping).to(dev)
        for k in ("cells", "dts", "count"):
            done[k][rows] = carry[k]
        return self._shade_done(done, basis)

    def _shade_done(self, done, basis):
        count = done["count"]
        n = count.shape[0]
        max_count = int(count.max()) if n else 0
        data = self.tables["data"]
        light = torch.ones((n,), dtype=_F32, device=self.device)
        n_channels = (data.shape[-1] - 1) // self.basis_dim
        acc = torch.zeros((n, n_channels), dtype=_F32, device=self.device)
        iota = torch.arange(K_STRIP, dtype=_I32, device=self.device)[None, :]
        for s0 in range(0, max(max_count, 1), K_STRIP):
            valid = (iota + s0) < count[:, None]
            light, acc = shade_strip(
                data,
                done["cells"][:, s0 : s0 + K_STRIP],
                done["dts"][:, s0 : s0 + K_STRIP],
                valid,
                basis,
                light,
                acc,
                self.fmt,
                self.basis_dim,
            )
        out = acc + light[:, None] * self.opts.background_brightness
        return out.cpu().numpy()
