"""PNG reading and writing with the standard library and numpy alone.

The machine that runs the port on the GPU has no PIL, imageio or cv2, so
the loaders and the eval CLI read and write images through this module.
`read_png` gives what `np.array(Image.open(f))` gives for the files it
takes: 8-bit greyscale, grey+alpha, RGB and RGBA; 16-bit RGB and RGBA as
8-bit, each sample's high byte (PIL's "RGB" / "RGBA" modes), and 16-bit
grey+alpha as 8-bit RGBA (grey repeated, as PIL converts it); with any of
the five row filters, interlaced (Adam7) or not. It refuses what PIL
gives in another form: 16-bit greyscale (PIL's "I;16", uint16), palettes
(PIL's "P": indices) and bit depths under 8. `write_png` writes 8-bit
greyscale, RGB or RGBA with no row filter.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> channels


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


# Adam7: (first column, first row, column step, row step) of each pass.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _decode_image(path, raw, pos, h, w, nbytes):
    """The filtered scanlines of an h x w (sub)image at raw[pos:] -> (uint8
    [h, w, nbytes], the position after it); a filter byte starts each row,
    and the filters see a pixel as its nbytes bytes."""
    size = h * (1 + w * nbytes)
    if pos + size > raw.size:
        raise ValueError(f"{path}: image data has {raw.size} bytes, want {pos + size} or more")
    rows = raw[pos:pos + size].reshape(h, 1 + w * nbytes)
    filt = rows[:, 0].astype(np.int64)
    if filt.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(filt.max())}")
    pixels = rows[:, 1:].reshape(h, w, nbytes).astype(np.int32)
    if not filt.any():
        return pixels.astype(np.uint8), pos + size
    return _unfilter(pixels, filt, h, w, nbytes), pos + size


def read_png(path):
    """A PNG as a uint8 array [H, W, C] (C = 1, 2, 3 or 4), as PIL reads it."""
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
    if ctype == 3:
        raise ValueError(f"{path}: PNG colour type 3 (palette) is not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth == 16 and ctype == 0:
        raise ValueError(f"{path}: 16-bit greyscale PNG is not supported (PIL reads it as "
                         "uint16 'I;16')")
    if depth not in (8, 16):
        raise ValueError(f"{path}: {depth}-bit PNG; only 8- and 16-bit samples are supported")
    if interlace > 1:
        raise ValueError(f"{path}: unknown PNG interlace method {interlace}")
    c = _CHANNELS[ctype]
    nbytes = c * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if not interlace:
        pixels, end = _decode_image(path, raw, 0, h, w, nbytes)
    else:
        pixels, end = np.zeros((h, w, nbytes), np.uint8), 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
            if pw and ph:
                sub, end = _decode_image(path, raw, end, ph, pw, nbytes)
                pixels[y0::dy, x0::dx] = sub
    if end != raw.size:
        raise ValueError(f"{path}: image data has {raw.size} bytes, want {end}")
    if depth == 16:
        pixels = pixels[..., 0::2]  # each sample's high byte
        if ctype == 4:  # grey + alpha -> RGBA
            pixels = pixels[..., [0, 0, 0, 1]]
    return np.ascontiguousarray(pixels)


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
