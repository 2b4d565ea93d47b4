"""Write the JPEG fixtures in tests/torch_fixtures/jpeg/.

Run from the repository root on a machine with PIL:

    python tests/torch_fixtures/make_jpeg_fixtures.py

Each <name>.jpg comes from PIL's writer or from the numpy baseline encoder
beside this file (jpeg_writer.py: the 4:4:0 and 4:1:1 files PIL cannot
write), and <name>.npy beside it holds `np.array(Image.open(<name>.jpg))`:
PIL's decode is the oracle. tests/test_torch_jpeg.py holds the port's
decoder to each .npy bitwise (and PIL to it, so a fixture stays true), and
chip_smoke.py (phase 38) does so on the GPU host, where there is no PIL.
"""

import io
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "jpeg")
sys.path.insert(0, HERE)

from jpeg_writer import encode_jpeg  # noqa: E402


def texture(h, w, c, seed, noise=12.0):
    """Smooth colour waves plus seeded noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(x / (4.0 + k) + k) * np.cos(y / (3.0 + k) - k)
                    for k in range(c)], -1)
    img = np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def pil(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def exif_rotated():
    exif = Image.Exif()
    exif[0x0112] = 6  # orientation: rotate 90 CW to display
    return pil(texture(20, 30, 3, 12), quality=90, exif=exif)


# name -> JPEG bytes
FIXTURES = {
    "baseline_444_q90": lambda: pil(texture(23, 37, 3, 1), quality=90, subsampling=0),
    "baseline_422_q75": lambda: pil(texture(33, 48, 3, 2), quality=75, subsampling=1),
    "baseline_420_q50": lambda: pil(texture(43, 67, 3, 3), quality=50, subsampling=2),
    "baseline_420_q1": lambda: pil(texture(30, 50, 3, 4), quality=1),
    "optimized_420_q100": lambda: pil(texture(21, 33, 3, 5), quality=100, optimize=True),
    "progressive_420_q85": lambda: pil(texture(48, 64, 3, 6), quality=85, progressive=True),
    "progressive_optimized_444_q95": lambda: pil(texture(29, 41, 3, 7), quality=95,
                                                 subsampling=0, progressive=True,
                                                 optimize=True),
    "restart_420_q80": lambda: pil(texture(40, 56, 3, 8), quality=80, restart_marker_blocks=2),
    "grey_q70": lambda: pil(texture(67, 129, 1, 9), quality=70),
    "grey_progressive_q60": lambda: pil(texture(31, 45, 1, 10), quality=60, progressive=True),
    "writer_440_q90_dri3": lambda: encode_jpeg(texture(30, 40, 3, 11), quality=90,
                                               sampling=[(1, 2), (1, 1), (1, 1)],
                                               restart_interval=3),
    "writer_411_q90": lambda: encode_jpeg(texture(20, 70, 3, 13), quality=90,
                                          sampling=[(4, 1), (1, 1), (1, 1)]),
    "exif_orientation_6": exif_rotated,
    "odd_7x5_420": lambda: pil(texture(5, 7, 3, 14), quality=90),
    "tiny_1x1_420": lambda: pil(texture(1, 1, 3, 15), quality=90),
}


def main():
    os.makedirs(OUT, exist_ok=True)
    total = 0
    for name, make in FIXTURES.items():
        data = make()
        jpg = os.path.join(OUT, name + ".jpg")
        with open(jpg, "wb") as f:
            f.write(data)
        want = np.array(Image.open(jpg))
        np.save(os.path.join(OUT, name + ".npy"), want)
        size = len(data) + os.path.getsize(os.path.join(OUT, name + ".npy"))
        total += size
        print(f"{name}: {want.shape} {len(data)} bytes")
    print(f"{len(FIXTURES)} fixtures, {total} bytes")


if __name__ == "__main__":
    main()
