"""ctypes bindings of the port's native host library (csrc/plenoctree_native.cc).

The port's counterpart of plenoctree_tpu/native: the same three entry
points with the same signatures and return values, each returning None
where the library is unavailable so that the caller takes its numpy path
(octree/n3tree.py, octree/quantize.py), as the JAX package does.

The library is built at first use with g++ and the JAX package's flags
(`-O3 -std=c++17 -shared -fPIC`: other flags or another compiler may change
`std::nth_element`'s partition, and with it the median cut's palette) into
`build/native/libplenoctree_native-<hash>.so`, written atomically, so test
workers that build it at once each load a whole file. `PLENOCTREE_NO_NATIVE=1`
forces the numpy paths. Where the build or the load fails, `build_error`
keeps the reason (the JAX package drops it). `calls` counts the native calls
per entry point, as the kernels' wrappers count their launches.
"""

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from plenoctree_tpu_torch.kernels._build import build_shared_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "plenoctree_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None
_TRIED = False
build_error = None  # why get_lib() returned None, once it has been tried
build_log = None  # g++'s output where this process built the library
calls = {"build_octree": 0, "query_points": 0, "median_cut": 0}


def _count(entry):
    with _LOCK:
        calls[entry] += 1


def get_lib():
    """The loaded native library, or None if it is unavailable (see
    `build_error`)."""
    global _LIB, _TRIED, build_error, build_log
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("PLENOCTREE_NO_NATIVE"):
            build_error = "PLENOCTREE_NO_NATIVE is set"
            return None
        try:
            out, build_log = build_shared_library(
                "g++", CXX_FLAGS, "plenoctree_native", [SOURCE], BUILD_DIR)
            lib = ctypes.CDLL(str(out))
        except Exception as e:  # no g++, a failed build or load: the numpy paths
            build_error = f"{type(e).__name__}: {e}"
            return None
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.pn_build_octree.restype = i64
        lib.pn_build_octree.argtypes = [ptr, i64, i32, ptr, ptr, i64]
        lib.pn_median_cut.restype = i64
        lib.pn_median_cut.argtypes = [ptr, ptr, i64, i32, i32, ptr, ptr, i64]
        lib.pn_query_points.restype = None
        lib.pn_query_points.argtypes = [ptr, i64, ptr, i64, i32, ptr, ptr]
        _LIB = lib
        return _LIB


def build_octree_native(coords, depth):
    """Bottom-up octree build from occupied voxel coords at reso 2^(depth+1).

    Returns (child [n, 2, 2, 2] int32 rel-offsets, parent_depth [n, 2]) or
    None if the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, dtype=np.int32)
    n = coords.shape[0]
    capacity = max(16, min(2 * n + 16, 8 * n + 16))
    _count("build_octree")
    while True:
        child = np.zeros((capacity, 8), np.int32)
        parent_depth = np.zeros((capacity, 2), np.int32)
        rc = lib.pn_build_octree(
            coords.ctypes.data, n, depth, child.ctypes.data, parent_depth.ctypes.data, capacity,
        )
        if rc == -1:
            capacity *= 2
            continue
        if rc < 0:
            return None
        n_nodes = int(rc)
        return child[:n_nodes].reshape(n_nodes, 2, 2, 2), parent_depth[:n_nodes]


def median_cut_native(colors, weights=None, bits=16):
    """Native median cut; returns (palette, ids) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    colors = np.ascontiguousarray(colors, dtype=np.float32)
    m, c = colors.shape
    if m == 0:
        return np.zeros((0, c), np.float32), np.zeros((0,), np.uint32)
    levels = min(bits, max(int(np.ceil(np.log2(max(m, 2)))), 1))
    max_palette = 1 << levels
    ids = np.zeros(m, np.uint32)
    palette = np.zeros((max_palette, c), np.float32)
    wptr = 0
    warr = None
    if weights is not None and len(weights):
        warr = np.ascontiguousarray(weights, dtype=np.float32)
        wptr = warr.ctypes.data
    _count("median_cut")
    p = lib.pn_median_cut(
        colors.ctypes.data, wptr, m, c, levels, ids.ctypes.data, palette.ctypes.data, max_palette,
    )
    if p < 0:
        return None
    return palette[: int(p)].copy(), ids


def query_points_native(child_rel, points_tree, max_depth):
    """Native descent; returns (flat_cell int64 [p], depth int32 [p]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    child = np.ascontiguousarray(child_rel.reshape(child_rel.shape[0], 8), np.int32)
    pts = np.ascontiguousarray(points_tree, np.float32)
    p = pts.shape[0]
    out_cell = np.zeros(p, np.int64)
    out_depth = np.zeros(p, np.int32)
    _count("query_points")
    lib.pn_query_points(
        child.ctypes.data, child.shape[0], pts.ctypes.data, p, max_depth,
        out_cell.ctypes.data, out_depth.ctypes.data,
    )
    return out_cell, out_depth


def summary():
    """One line for a CLI's output: the library's state and the calls."""
    counts = " ".join(f"{k}={v}" for k, v in calls.items())
    if _LIB is not None:
        return f"g++ library, {counts}"
    return f"numpy paths ({build_error or 'library not tried'}), {counts}"
