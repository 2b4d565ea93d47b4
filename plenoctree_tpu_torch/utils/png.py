"""PNG reading and writing with the standard library and numpy alone.

The machine that runs the port on the GPU has no PIL, imageio or cv2, so
the blender loader and the eval CLI read and write images through this
module. `read_png` takes the 8-bit, non-interlaced greyscale, grey+alpha,
RGB and RGBA files that Blender and PIL write, with any of the five row
filters; it refuses other bit depths, palettes and interlacing. `write_png`
writes 8-bit greyscale, RGB or RGBA with no row filter.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> channels (8-bit samples)


def _chunks(data):
    """(type, payload) of every chunk after the signature, CRCs checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if len(payload) != length or zlib.crc32(tag + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"corrupt PNG chunk {tag!r}")
        yield tag, payload
        if tag == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter(raw, filt, h, w, c):
    """Undo the row filters. Sub, Avg and Paeth predict a byte from the
    pixel to its left (a), above (b) and above-left (c), so a pixel depends
    only on pixels of a lower anti-diagonal i + j: the image is decoded one
    anti-diagonal at a time (h + w - 1 vectorised steps), each pixel with
    its own row's filter."""
    out = np.zeros((h + 1, w + 1, c), np.int32)  # a zero row above, a zero column left
    rows = np.arange(h)
    for d in range(h + w - 1):
        i = rows[max(0, d - w + 1) : min(h, d + 1)]
        j = d - i
        a, b, cc = out[i + 1, j], out[i, j + 1], out[i, j]
        pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        pred = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        out[i + 1, j + 1] = (raw[i, j] + pred[filt[i], np.arange(i.size)]) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def is_png(path):
    """Whether the file starts with the PNG signature."""
    with open(path, "rb") as f:
        return f.read(len(_SIGNATURE)) == _SIGNATURE


def read_png(path):
    """An 8-bit PNG as a uint8 array [H, W, C] (C = 1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for tag, payload in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG; only 8-bit samples are supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} (palette) is not supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: image data has {raw.size} bytes, want {h * (1 + w * c)}")
    raw = raw.reshape(h, 1 + w * c)
    filt = raw[:, 0].astype(np.int64)
    if filt.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(filt.max())}")
    pixels = raw[:, 1:].reshape(h, w, c).astype(np.int32)
    if not filt.any():
        return pixels.astype(np.uint8)
    return _unfilter(pixels, filt, h, w, c)


def write_png(path, u8):
    """Write a uint8 array [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA) as an 8-bit PNG with no row filter."""
    a = np.asarray(u8)
    if a.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 pixels, got {a.dtype}")
    ctype = {3: 2, 4: 6}.get(a.shape[-1]) if a.ndim == 3 else (0 if a.ndim == 2 else None)
    if ctype is None:
        raise ValueError(f"write_png takes [H, W], [H, W, 3] or [H, W, 4], got {a.shape}")
    h, w = a.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(np.ascontiguousarray(raw).tobytes())))
        f.write(chunk(b"IEND", b""))
