"""Python wrappers of the hand-written CUDA kernels in `csrc/`.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version for CPU tensors, and counts its launches in its
module's counters. A replayed CUDA graph launches what it captured, and
utils/graphs.py moves the counters for it (`launch_counts`,
`add_launch_counts`) of the wrappers that captured work calls
(_COUNTERS).
"""

import importlib

_COUNTERS = {
    "fused_mlp": ("fwd_launches", "bwd_launches", "posenc_launches", "sh_launches"),
    "tile_composite": ("launches", "bwd_launches", "reg_basis_launches"),
}


def launch_counts():
    """The launch counters of _COUNTERS: {(module, counter): launches}."""
    return {(m, n): getattr(importlib.import_module(f"{__name__}.{m}"), n)
            for m, names in _COUNTERS.items() for n in names}


def add_launch_counts(delta):
    """Advance the launch counters by `delta` ({(module, counter): launches}):
    by a replayed CUDA graph's captured launches, or back by a capture's,
    which launches nothing."""
    for (m, n), d in delta.items():
        module = importlib.import_module(f"{__name__}.{m}")
        setattr(module, n, getattr(module, n) + d)
