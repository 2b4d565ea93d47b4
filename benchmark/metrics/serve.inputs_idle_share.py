"""Share of the traced window, in %, idle in gaps that began inside the tile
inputs (`tile.inputs`: ray generation and phase 1)."""

from benchmark import spans


def read(v):
    return spans.idle_share(v, "tile.frame", "tile.inputs")
