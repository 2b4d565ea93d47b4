"""Host ms a train step spends in the Adam update: the `nerf.update` spans'
duration over the `nerf.step` spans."""

from benchmark import spans


def read(v):
    return spans.host_ms_per_unit("nerf.step", "nerf.update")
