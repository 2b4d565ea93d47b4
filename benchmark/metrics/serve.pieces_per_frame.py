"""Pieces (row chunks) handed to compositing kernel #3 per served frame:
the `pieces` counts of the `tile.inputs` spans over the `tile.frame` spans
(a cap regrowth's second render counts too)."""

from benchmark import spans


def read(v):
    return spans.count_per_unit("tile.frame", "tile.inputs", "pieces")
