"""Share of the traced window, in %, idle in gaps that began inside the
frame's fetch (`tile.fetch`: the wait for the device and the u8 copy to
the host)."""

from benchmark import spans


def read(v):
    return spans.idle_share(v, "tile.frame", "tile.fetch")
