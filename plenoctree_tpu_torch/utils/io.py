"""Host-side image saving.

Port of plenoctree_tpu/utils/io.py::save_img. The PNG goes through the
port's own writer (utils/png.py), so no PIL is needed; the clip to [0, 1],
the x255 and the uint8 cast (truncation) are the JAX package's. A 2-D
image is written as greyscale, as PIL writes it. `TimingsLog` waits for
the train CLI's timings.txt (ROADMAP.md A7); the host-0 helpers are
multi-host only.
"""

import os

import numpy as np

from plenoctree_tpu_torch.utils.png import write_png


def save_img(img, pth):
    """Save an image [H, W] or [H, W, 3|4] (clipped to [0, 1]) as PNG."""
    arr = (np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)
    write_png(os.path.expanduser(pth), arr)
