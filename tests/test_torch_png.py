"""The port's PNG codec (every row filter, Adam7, 16-bit) and image
resize against PIL and cv2, and its
blender-layout scene writer against the JAX package's (tests/
test_torch_imports.py loads such a scene with PIL, imageio and cv2
blocked)."""

import json
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from plenoctree_tpu_torch.data.datasets import _resize_area
from plenoctree_tpu_torch.utils.png import read_png, write_png

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _image(h, w, c, seed):
    """Smooth gradients with a noisy patch, so every filter has work."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * (3 + k) + y * (5 - k) + 40 * k) % 256 for k in range(c)], -1)
    img = img.astype(np.uint8)
    img[h // 3 : h // 2, w // 4 : w // 2] = rng.integers(0, 256, (h // 2 - h // 3, w // 2 - w // 4, c))
    return img


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def _filtered(img, filters):
    """Scanlines of img [H, W, B] (B bytes a pixel), row y filtered with
    filters[y] (0-4) from the original bytes as an encoder does."""
    h, w, c = img.shape
    x = np.zeros((h + 1, (w + 1) * c), np.int32)  # a zero row above, a zero pixel left
    x[1:, c:] = img.reshape(h, w * c)
    a, b, cc = x[1:, :-c], x[:-1, c:], x[:-1, :-c]
    pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    pred = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, paeth])
    rows = (x[1:, c:] - pred[np.asarray(filters), np.arange(h)]) & 0xFF
    return np.concatenate([np.asarray(filters, np.uint8)[:, None], rows.astype(np.uint8)],
                          1).tobytes()


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _png_bytes(img, filters, depth=8, ctype=None, interlace=0):
    """A PNG of img [H, W, C] (uint8, or uint16 for depth 16) whose row y
    uses filters[y % len(filters)] (0-4); interlace=1 writes the seven
    Adam7 passes, each with its own rows."""
    h, w, c = img.shape
    data = img.astype(">u2").view(np.uint8).reshape(h, w, 2 * c) if depth == 16 else img
    filters = np.asarray(filters)
    if interlace == 1:
        raw = b"".join(_filtered(data[y0::dy, x0::dx], np.resize(filters, len(range(y0, h, dy))))
                       for x0, y0, dx, dy in ADAM7 if x0 < w and y0 < h)
    else:
        raw = _filtered(data, np.resize(filters, h))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c] if ctype is None else ctype
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", list(MODES))
def test_read_png_matches_pil_on_pil_files(mode, tmp_path):
    img = _image(37, 53, MODES[mode], seed=1)
    path = tmp_path / "img.png"
    Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(path)
    want = np.array(Image.open(path))
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == (37, 53, MODES[mode])
    np.testing.assert_array_equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("filt", ["none", "sub", "up", "avg", "paeth", "mixed"])
@pytest.mark.parametrize("c", [3, 4])
def test_read_png_matches_pil_for_each_filter(filt, c, tmp_path):
    img = _image(29, 41, c, seed=2)
    names = ["none", "sub", "up", "avg", "paeth"]
    filters = (np.random.default_rng(3).integers(0, 5, 29) if filt == "mixed"
               else np.full(29, names.index(filt)))
    path = tmp_path / "img.png"
    path.write_bytes(_png_bytes(img, filters))
    np.testing.assert_array_equal(np.array(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("c", [3, 4])
def test_write_png_reads_back_in_pil(c, tmp_path):
    img = _image(23, 31, c, seed=4)
    path = tmp_path / "img.png"
    write_png(path, img)
    np.testing.assert_array_equal(np.array(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path), img)
    with pytest.raises(ValueError):
        write_png(path, img[..., :2])


@pytest.mark.parametrize("kind", ["16-bit", "palette", "interlaced", "1-bit", "4-bit"])
def test_read_png_refuses_other_formats(kind, tmp_path):
    """What PIL gives in another form raises: 16-bit greyscale (uint16
    'I;16'), palettes (indices), bit depths under 8; and an interlace
    method other than Adam7."""
    img = _image(8, 8, 3, seed=5)
    path = tmp_path / "img.png"
    if kind == "16-bit":
        Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(path)
    elif kind == "palette":
        Image.fromarray(img).convert("P").save(path)
    elif kind == "1-bit":
        Image.fromarray(img[..., 0] > 128).save(path)
    elif kind == "4-bit":  # two greyscale samples a byte
        packed = ((img[:, 0::2, 0] >> 4) << 4) | (img[:, 1::2, 0] >> 4)
        raw = np.concatenate([np.zeros((8, 1), np.uint8), packed], 1).tobytes()
        path.write_bytes(b"\x89PNG\r\n\x1a\n"
                         + _chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, 4, 0, 0, 0, 0))
                         + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    else:
        path.write_bytes(_png_bytes(img, np.zeros(8, int), interlace=2))
    with pytest.raises(ValueError, match="img.png"):
        read_png(path)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("size", [(1, 1), (3, 5), (8, 8), (29, 41)])
def test_read_png_adam7_matches_pil(c, size, tmp_path):
    """Adam7-interlaced PNGs (empty passes at small sizes, every filter in
    turn) read as PIL reads them."""
    img = _image(*size, c, seed=7) if min(size) > 2 else (
        np.random.default_rng(7).integers(0, 256, (*size, c), dtype=np.uint8))
    path = tmp_path / "img.png"
    path.write_bytes(_png_bytes(img, [0, 1, 2, 3, 4], interlace=1))
    want = np.array(Image.open(path))
    np.testing.assert_array_equal(want.reshape(img.shape), img)
    got = read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "LA"])
@pytest.mark.parametrize("interlace", [0, 1])
def test_read_png_16bit_matches_pil(mode, interlace, tmp_path):
    """16-bit RGB and RGBA read as PIL reads them, 8-bit, each sample's
    high byte; 16-bit grey+alpha as PIL's RGBA (grey repeated)."""
    c = {"RGB": 3, "RGBA": 4, "LA": 2}[mode]
    img = np.random.default_rng(8).integers(0, 65536, (13, 11, c), dtype=np.uint16)
    path = tmp_path / "img.png"
    path.write_bytes(_png_bytes(img, [4, 1, 0, 2, 3], depth=16, interlace=interlace))
    want = np.array(Image.open(path))
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    hi = (img >> 8).astype(np.uint8)
    np.testing.assert_array_equal(got, hi[..., [0, 0, 0, 1]] if mode == "LA" else hi)


@pytest.mark.parametrize("shape", [(18, 24, 4), (40, 10, 3)])
def test_halve_matches_cv2_inter_area(shape):
    """--factor 2 on the Blender loader: cv2's INTER_AREA bitwise (its
    2x2 SIMD sums for 4 channels, its block sum for 3)."""
    img = np.random.default_rng(6).random(shape, dtype=np.float32)
    want = cv2.resize(img, (shape[1] // 2, shape[0] // 2), interpolation=cv2.INTER_AREA)
    got = _resize_area(img, shape[1] // 2, shape[0] // 2)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_write_blender_dataset_matches_jax_package(tmp_path):
    """The port's blender-layout writer (utils/png.py) against the JAX
    package's (PIL): the same transforms files and the same pixels."""
    from plenoctree_tpu.data.synthetic import write_blender_dataset as jax_write
    from plenoctree_tpu_torch.data.synthetic import write_blender_dataset

    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    write_blender_dataset(str(ours), n_train=2, n_test=1, resolution=16)
    jax_write(str(theirs), n_train=2, n_test=1, resolution=16)
    for split in ("train", "test", "val"):
        name = f"transforms_{split}.json"
        meta = json.loads((ours / name).read_text())
        assert meta == json.loads((theirs / name).read_text())
        for frame in meta["frames"]:
            rel = frame["file_path"] + ".png"
            np.testing.assert_array_equal(read_png(ours / rel), np.array(Image.open(theirs / rel)))
