"""Captured-graph replays per train step: the `replays` counts of the
`nerf.step` spans over their number (1.0 once every step of the window
replays the step captured under its key; an eager step, or the one that
captures, counts none)."""

from benchmark import spans


def read(v):
    return spans.count_per_unit("nerf.step", "nerf.step", "replays")
