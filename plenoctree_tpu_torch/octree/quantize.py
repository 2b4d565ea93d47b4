"""Median-cut palette quantization for octree compression (host numpy).

Port of plenoctree_tpu/octree/quantize.py, numpy only (the port has no
native library): `quantize_median_cut` is the JAX package's numpy k-d
median cut (all boxes split at once per level, each along its own longest
axis at its median; one lexsort per level), and `compress_tree_npz` writes
the same npz keys (quant_colors, quant_map, sigma, data_retained).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def quantize_median_cut(colors, weights=None, bits=16):
    """Quantize [M, C] colors to a <=2^bits palette.

    Args:
      colors: [M, C] float colors (C typically 3).
      weights: optional [M] nonnegative weights (weighted means).
      bits: number of split levels (palette size <= 2^bits).

    Returns:
      palette: [P, C] float32 palette colors.
      color_id_map: [M] uint32 palette index per input color.
    """
    colors = np.asarray(colors, np.float32)
    m = colors.shape[0]
    if m == 0:
        return np.zeros((0, colors.shape[1]), np.float32), np.zeros((0,), np.uint32)
    if weights is None or len(weights) == 0:
        weights = np.ones(m, np.float32)
    weights = np.asarray(weights, np.float32)

    box = np.zeros(m, np.int64)  # box id per point
    # Don't split further than the number of points allows.
    levels = min(bits, max(int(np.ceil(np.log2(max(m, 2)))), 1))
    for _ in range(levels):
        # Longest axis per box: segment min/max over points.
        n_boxes = int(box.max()) + 1
        mins = np.full((n_boxes, colors.shape[1]), np.inf, np.float32)
        maxs = np.full((n_boxes, colors.shape[1]), -np.inf, np.float32)
        np.minimum.at(mins, box, colors)
        np.maximum.at(maxs, box, colors)
        axis = np.argmax(maxs - mins, axis=1)  # [n_boxes]
        key = colors[np.arange(m), axis[box]]
        order = np.lexsort((key, box))
        # Rank of each point within its box; the upper half of each box
        # (rank >= ceil(n / 2)) becomes box * 2 + 1.
        sorted_box = box[order]
        box_start = np.r_[0, np.nonzero(np.diff(sorted_box))[0] + 1]
        counts = np.diff(np.r_[box_start, m])
        rank = np.arange(m) - np.repeat(box_start, counts)
        upper = rank >= np.repeat((counts + 1) // 2, counts)
        new_box = np.empty(m, np.int64)
        new_box[order] = sorted_box * 2 + upper
        box = new_box

    # Dense palette ids + weighted mean colors.
    uniq, dense = np.unique(box, return_inverse=True)
    p = uniq.size
    wsum = np.zeros(p, np.float64)
    csum = np.zeros((p, colors.shape[1]), np.float64)
    np.add.at(wsum, dense, weights)
    np.add.at(csum, dense, colors * weights[:, None])
    palette = (csum / np.maximum(wsum, 1e-12)[:, None]).astype(np.float32)
    return palette, dense.astype(np.uint32)


def compress_tree_npz(
    input_path,
    output_path,
    bits=16,
    sigma_thresh=2.0,
    retain=0,
    weighted=False,
    noquant=False,
):
    """Compress a tree.npz for web serving; False when the input is already
    compressed (and quantization is on).

    As the JAX package's (octree/compression.py:39-141 of the reference):
    drop the bookkeeping arrays, zero voxels below sigma_thresh, a median-cut
    palette per basis function (uint16 map + fp16 palette) except the first
    `retain` (kept fp16), deflate. The median cuts run on one thread per
    basis function, up to the host's cores.
    """
    z = dict(np.load(input_path, allow_pickle=False))
    if not noquant and "quant_colors" in z:
        return False
    for key in ("parent_depth", "geom_resize_fact", "n_free", "n_internal", "depth_limit"):
        z.pop(key, None)

    if not noquant:
        data = np.asarray(z["data"], np.float32)
        n = data.shape[1]
        sigma = data[..., -1].reshape(-1).copy()
        snz = sigma > sigma_thresh
        sigma[~snz] = 0.0

        rgb = data[..., :-1]
        basis_dim = rgb.shape[-1] // 3
        rgb = rgb.reshape(-1, 3, basis_dim)[snz]
        weights = 1.0 - np.exp(-0.01 * sigma[snz]) if weighted else None

        # One median cut per basis function, on a thread each (numpy
        # releases the GIL in its sorts, gathers and ufuncs; the results do
        # not depend on the threads).
        quantized = list(range(retain, basis_dim))
        with ThreadPoolExecutor(max(1, min(len(quantized), os.cpu_count() or 1))) as pool:
            cuts = dict(zip(quantized, pool.map(
                lambda i: quantize_median_cut(np.ascontiguousarray(rgb[:, :, i]), weights, bits),
                quantized,
            )))
        quant_colors, quant_maps, retained = [], [], []
        for i in range(basis_dim):
            if i < retain:
                full = np.zeros((snz.shape[0], 3), np.float16)
                full[snz] = rgb[:, :, i].astype(np.float16)
                retained.append(full.reshape(-1, n, n, n, 3))
                continue
            palette, ids = cuts[i]
            full = np.zeros((snz.shape[0],), np.uint16)
            full[snz] = ids.astype(np.uint16)
            quant_colors.append(palette.astype(np.float16))
            quant_maps.append(full.reshape(-1, n, n, n))
        # Palettes can differ in size; pad to the largest for one array.
        pmax = max(c.shape[0] for c in quant_colors)
        quant_colors = [np.pad(c, ((0, pmax - c.shape[0]), (0, 0))) for c in quant_colors]
        z["quant_colors"] = np.stack(quant_colors, axis=0)
        z["quant_map"] = np.stack(quant_maps, axis=0)
        z["sigma"] = sigma.reshape(-1, n, n, n)
        if retain:
            z["data_retained"] = np.stack(retained, axis=0)
        del z["data"]
    np.savez_compressed(output_path, **z)
    return True
