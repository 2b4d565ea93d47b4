"""Live rows per piece that compositing kernel #3 stages: over the
`tile.frame` spans, the `rows` counts of their `tile.inputs` spans (the
rows of each kept piece's 128-row soa block that lie inside its run) over
their `pieces` counts. None where the program counts no rows."""

from benchmark import spans


def read(v):
    rows = spans.count_per_unit("tile.frame", "tile.inputs", "rows")
    pieces = spans.count_per_unit("tile.frame", "tile.inputs", "pieces")
    if rows is None or not pieces:
        return None
    return rows / pieces
