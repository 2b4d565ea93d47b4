"""Pieces (row chunks) handed to kernels #3 and #4 per optimizer step: the
`pieces` counts of the `tile.inputs` spans over the `tile_opt.step` spans."""

from benchmark import spans


def read(v):
    return spans.count_per_unit("tile_opt.step", "tile.inputs", "pieces")
