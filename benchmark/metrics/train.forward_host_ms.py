"""Host ms a train step spends in the forward (sampling, both levels, the
sparsity points, the loss terms): the `nerf.forward` spans' duration over
the `nerf.step` spans."""

from benchmark import spans


def read(v):
    return spans.host_ms_per_unit("nerf.step", "nerf.forward")
