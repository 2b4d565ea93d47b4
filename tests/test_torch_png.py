"""The port's PNG codec and image resize against PIL and cv2, and its
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

from plenoctree_tpu_torch.data.datasets import _box_mean
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


def _png_bytes(img, filters, depth=8, ctype=None, interlace=0):
    """An 8-bit PNG of img [H, W, C] whose row y uses filters[y] (0-4),
    filtered from the original bytes as an encoder does."""
    h, w, c = img.shape
    x = np.zeros((h + 1, (w + 1) * c), np.int32)  # a zero row above, a zero pixel left
    x[1:, c:] = img.reshape(h, w * c)
    a, b, cc = x[1:, :-c], x[:-1, c:], x[:-1, :-c]
    pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    pred = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, paeth])
    rows = (x[1:, c:] - pred[np.asarray(filters), np.arange(h)]) & 0xFF
    raw = np.concatenate([np.asarray(filters, np.uint8)[:, None], rows.astype(np.uint8)], 1)
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c] if ctype is None else ctype
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
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


@pytest.mark.parametrize("kind", ["16-bit", "palette", "interlaced"])
def test_read_png_refuses_other_formats(kind, tmp_path):
    img = _image(8, 8, 3, seed=5)
    path = tmp_path / "img.png"
    if kind == "16-bit":
        Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(path)
    elif kind == "palette":
        Image.fromarray(img).convert("P").save(path)
    else:
        path.write_bytes(_png_bytes(img, np.zeros(8, int), interlace=1))
    with pytest.raises(ValueError):
        read_png(path)


@pytest.mark.parametrize("shape", [(18, 24, 4), (40, 10, 3)])
def test_halve_matches_cv2_inter_area(shape):
    img = np.random.default_rng(6).random(shape, dtype=np.float32)
    want = cv2.resize(img, (shape[1] // 2, shape[0] // 2), interpolation=cv2.INTER_AREA)
    got = _box_mean(img, 2)
    assert got.shape == want.shape and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 1e-6


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
