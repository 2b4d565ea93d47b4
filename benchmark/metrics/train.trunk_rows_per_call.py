"""Rows handed to the trunk per call (kernels #1/#2 on the fused path): the
`rows` counts of the `nerf.trunk` spans over their number."""

from benchmark import spans


def read(v):
    return spans.count_per_unit("nerf.trunk", "nerf.trunk", "rows")
