"""Host ms a served frame spends in the tile inputs (ray generation and
phase 1): the `tile.inputs` spans' duration over the `tile.frame` spans."""

from benchmark import spans


def read(v):
    return spans.host_ms_per_unit("tile.frame", "tile.inputs")
