"""Kernel #4's share of its roofline over the traced optimizer steps, in %:
its least time (benchmark/roofline.py::tile_bwd_work on the scene and
poses) over its device time."""

KERNELS = ("tile_composite_bwd_kernel",)


def read(v):
    t = v.summary.kernel_s(*KERNELS)
    if t <= 0 or "bwd" not in v.least:
        return None
    return 100.0 * v.least["bwd"] / t
