"""Host-side image saving and the train CLI's wall-clock log.

Port of plenoctree_tpu/utils/io.py: `save_img` (the PNG goes through the
port's own writer, utils/png.py, so no PIL is needed; the clip to [0, 1],
the x255 and the uint8 cast (truncation) are the JAX package's; a 2-D
image is written as greyscale, as PIL writes it) and the timings.txt log
(`TimingsLog`, `parse_timings`, `timings_total_hours`; the file format is
the JAX package's, so either package's parser reads either's log). The
host-0 helpers are multi-host only.
"""

import os
from datetime import datetime

import numpy as np

from plenoctree_tpu_torch.utils.png import write_png


def save_img(img, pth):
    """Save an image [H, W] or [H, W, 3|4] (clipped to [0, 1]) as PNG."""
    arr = (np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)
    write_png(os.path.expanduser(pth), arr)


class TimingsLog:
    """Appends `<step> <iso timestamp>` lines, parseable by parse_timings."""

    def __init__(self, path):
        self._f = open(path, "a")

    def write(self, step):
        self._f.write(f"{step} {datetime.now().isoformat()}\n")
        self._f.flush()

    def close(self):
        self._f.close()


def parse_timings(path):
    """A timings.txt as a list of (step, datetime)."""
    entries = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) != 2:
                continue
            entries.append((int(parts[0]), datetime.fromisoformat(parts[1])))
    return entries


def timings_total_hours(path):
    """Hours of training in a timings.txt: the gaps between consecutive
    entries, restarting where the step goes back (a resumed run)."""
    entries = parse_timings(path)
    total = 0.0
    for (s0, t0), (s1, t1) in zip(entries, entries[1:]):
        if s1 >= s0:
            total += (t1 - t0).total_seconds()
    return total / 3600.0
