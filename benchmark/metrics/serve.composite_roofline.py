"""Kernel #3's share of its roofline over the traced frames, in %: its least
time (benchmark/roofline.py::tile_fwd_work on the scene and poses) over its
device time."""

KERNELS = ("tile_composite_kernel",)


def read(v):
    t = v.summary.kernel_s(*KERNELS)
    if t <= 0 or "composite" not in v.least:
        return None
    return 100.0 * v.least["composite"] / t
