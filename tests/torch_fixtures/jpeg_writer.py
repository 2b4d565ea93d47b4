"""A baseline JPEG encoder in numpy: fixture code for the port's JPEG reader.

Not part of either package. The CPU tests import it to write files that
PIL's writer cannot (4:4:0 and 4:1:1 sampling, crafted coefficients, 12-bit
and relabelled frame headers), and `chip_smoke.py` loads it by path to
write its full-resolution LLFF capture on a host with no JPEG encoder.

`encode_jpeg` writes a JFIF file with the Annex K quantisation tables
(scaled as libjpeg scales them for a quality), the Annex K Huffman tables,
any sampling factors, and an optional restart interval. The Huffman stage
is vectorised: a code and a length per symbol, each symbol's bit offset
from a cumulative sum, and the bits packed into 64-bit words.
"""

import numpy as np

# Natural (row-major) index of each zigzag position.
ZIGZAG = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8,
                                                   (n % 8) if (n // 8 + n % 8) % 2 == 0
                                                   else (n // 8))), np.int64)

# Annex K.1 tables, in zigzag order as a DQT segment stores them.
QT_LUMA = np.frombuffer(bytes.fromhex(
    "100b0c0e0c0a100e0d0e1211101318281a181616183123251d283a333d3c3933383740485c4e404457453738"
    "506d51575f626768673e4d71797064785c656763"), np.uint8).astype(np.int64)
QT_CHROMA = np.frombuffer(bytes.fromhex("1112121815182f1a1a2f634238426363" + "63" * 48),
                          np.uint8).astype(np.int64)

# Annex K.3 Huffman tables: (code counts by length 1..16, symbols).
DC_LUMA = (bytes.fromhex("00010501010101010100000000000000"), bytes(range(12)))
DC_CHROMA = (bytes.fromhex("00030101010101010101010000000000"), bytes(range(12)))
AC_LUMA = (bytes.fromhex("0002010303020403050504040000017d"), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a"
    "25262728292a3435363738393a434445464748494a535455565758595a636465666768696a73747576777879"
    "7a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = (bytes.fromhex("00020102040403040705040400010277"), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f1"
    "1718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a7374757677"
    "78797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def quality_table(base, quality):
    """libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _codes(table):
    """Canonical Huffman codes: (code [256], length [256]) by symbol."""
    bits, vals = table
    code = np.zeros(256, np.uint64)
    size = np.zeros(256, np.uint64)
    c, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code[vals[k]], size[vals[k]] = c, length
            c, k = c + 1, k + 1
        c <<= 1
    return code, size


def _dct_matrix():
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    d[0] /= np.sqrt(2)
    return d


def _category(x):
    """The JPEG magnitude category (bit length of |x|) of int64 values."""
    return np.frexp(np.abs(x).astype(np.float64))[1].astype(np.int64)


def _to_ycc(rgb):
    r, g, b = (rgb[..., i].astype(np.float32) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128
    return [np.clip(np.rint(p), 0, 255).astype(np.float32) for p in (y, cb, cr)]


def _pad(plane, h, w):
    """Edge-replicate a plane to at least [h, w], then cut it to [h, w]."""
    ph, pw = max(h - plane.shape[0], 0), max(w - plane.shape[1], 0)
    return np.pad(plane, ((0, ph), (0, pw)), mode="edge")[:h, :w]


def _downsample(plane, fy, fx):
    h, w = -(-plane.shape[0] // fy), -(-plane.shape[1] // fx)
    p = _pad(plane, h * fy, w * fx)
    return p.reshape(h, fy, w, fx).mean(axis=(1, 3))


def _segment(marker, payload):
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _pack(values, lengths):
    """Concatenate big-endian bit fields into bytes (the last byte padded
    with 1-bits). values/lengths: uint64 arrays, lengths <= 32."""
    total = int(lengths.sum())
    if total == 0:
        return b""
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.uint64)
    word = (starts >> np.uint64(6)).astype(np.int64)
    end = (starts & np.uint64(63)) + lengths
    words = np.zeros(total // 64 + 2, np.uint64)
    fits = end <= 64
    part0 = np.where(fits, values << (np.uint64(64) - np.minimum(end, np.uint64(64))),
                     values >> (np.maximum(end, np.uint64(64)) - np.uint64(64)))
    first = np.flatnonzero(np.diff(word, prepend=-1))
    words[word[first]] = np.bitwise_or.reduceat(part0, first)
    over = ~fits
    words[word[over] + 1] |= values[over] << (np.uint64(128) - end[over])
    out = np.frombuffer(words.astype(">u8").tobytes(), np.uint8)[: -(-total // 8)].copy()
    if total % 8:
        out[-1] |= (1 << (8 - total % 8)) - 1
    return out


def _stuff(b):
    ff = np.flatnonzero(b == 0xFF)
    return np.insert(b, ff + 1, 0)


def encode_jpeg(image, quality=92, sampling=None, restart_interval=0, coefficients=None,
                qtables=None, component_ids=None, jfif=True, adobe_transform=None,
                sof=0xC0, precision=8):
    """A baseline JPEG of `image` (uint8 [H, W] or [H, W, 3]) as bytes.

    sampling: (h, v) per component (default 2x2,1x1,1x1 for colour: 4:2:0).
    restart_interval: MCUs per restart interval (0: no DRI).
    coefficients: quantised DCT coefficients to write instead of the
      image's, one int array [blocks_high, blocks_wide, 64] (natural order)
      per component at its MCU-padded block size; `image` then gives only
      the size and the component count.
    qtables: one table (zigzag order, values <= 65535) per component;
      tables over 255 are written as 16-bit DQT entries.
    component_ids, jfif, adobe_transform, sof, precision: header fields
      as written (for files that test how a reader chooses a colour
      transform, or refuses a process).
    """
    image = np.asarray(image)
    height, width = image.shape[:2]
    ncomp = 1 if image.ndim == 2 else image.shape[2]
    if sampling is None:
        sampling = [(1, 1)] if ncomp == 1 else [(2, 2), (1, 1), (1, 1)]
    if len(sampling) != ncomp:
        raise ValueError(f"{len(sampling)} sampling factors for {ncomp} components")
    if qtables is None:
        qtables = [quality_table(QT_LUMA if c == 0 else QT_CHROMA, quality) for c in range(ncomp)]
    qtables = [np.asarray(q, np.int64) for q in qtables]
    if component_ids is None:
        component_ids = list(range(1, ncomp + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    if ncomp == 1:  # a lone component is coded non-interleaved, one block per MCU
        mcux, mcuy = -(-width // 8), -(-height // 8)
        sampling = [(1, 1)]
        hmax = vmax = 1
    else:
        mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))

    blocks = []  # per component [mcuy * v, mcux * h, 64] quantised, natural order
    if coefficients is not None:
        blocks = [np.asarray(c, np.int64) for c in coefficients]
    else:
        planes = [image.astype(np.float32)] if ncomp == 1 else _to_ycc(image)
        dct = _dct_matrix()
        dct2 = np.kron(dct, dct).T  # [64, 64]: a row-major block times it is its 2-D DCT
        for c, (h, v) in enumerate(sampling):
            plane = _downsample(planes[c], vmax // v, hmax // h) if (h, v) != (hmax, vmax) \
                else planes[c]
            bh, bw = mcuy * v, mcux * h
            p = _pad(plane, bh * 8, bw * 8) - np.float32(128)
            p = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
            q = np.zeros(64, np.int64)
            q[ZIGZAG] = qtables[c]
            coef = (p.astype(np.float64) @ dct2) / q
            blocks.append(np.rint(coef).astype(np.int64).reshape(bh, bw, 64))

    # Blocks in coding order: MCU by MCU, component by component, v then h.
    order, comp_of = [], []
    for c, (h, v) in enumerate(sampling):
        b = blocks[c].reshape(mcuy, v, mcux, h, 64).transpose(0, 2, 1, 3, 4)
        order.append(b.reshape(mcuy * mcux, v * h, 64))
        comp_of.append(np.full(v * h, c))
    per_mcu = sum(o.shape[1] for o in order)
    coefs = np.concatenate(order, axis=1).reshape(-1, 64)[:, ZIGZAG]
    comp = np.tile(np.concatenate(comp_of), mcuy * mcux)
    mcu = np.repeat(np.arange(mcuy * mcux), per_mcu)
    interval = mcu // restart_interval if restart_interval else np.zeros_like(mcu)
    n_blocks = coefs.shape[0]

    # DC differences, the predictor reset at each restart interval.
    dc = coefs[:, 0]
    diff = np.empty_like(dc)
    for c in range(ncomp):
        idx = np.flatnonzero(comp == c)
        d = dc[idx]
        prev = np.concatenate([[0], d[:-1]])
        first = np.concatenate([[True], interval[idx][1:] != interval[idx][:-1]])
        diff[idx] = d - np.where(first, 0, prev)

    tables = [(_codes(DC_LUMA), _codes(AC_LUMA)), (_codes(DC_CHROMA), _codes(AC_CHROMA))]
    tsel = np.minimum(comp, 1)  # luma tables for component 0, chroma for the rest
    dc_code = np.stack([t[0][0] for t in tables])
    dc_size = np.stack([t[0][1] for t in tables])
    ac_code = np.stack([t[1][0] for t in tables])
    ac_size = np.stack([t[1][1] for t in tables])

    def fields(x, s):
        return np.where(x >= 0, x, x + (1 << s) - 1).astype(np.uint64)

    # AC run lengths: every non-zero coefficient, its run of zeros before
    # it (ZRL symbols for each 16), and an EOB where a block ends in zeros.
    nzb, nzk = np.nonzero(coefs[:, 1:])
    nzk = nzk + 1
    newblock = np.concatenate([[True], nzb[1:] != nzb[:-1]])
    prevk = np.where(newblock, 0, np.concatenate([[0], nzk[:-1]]))
    run = nzk - prevk - 1
    zrl, run = run // 16, run % 16
    eob = np.ones(n_blocks, bool)
    last = np.flatnonzero(np.concatenate([nzb[1:] != nzb[:-1], [True]])) if nzb.size else []
    eob[nzb[last]] = nzk[last] != 63
    per_nz = zrl + 1
    count = 1 + np.bincount(nzb, weights=per_nz, minlength=n_blocks).astype(np.int64) + eob
    block_start = np.concatenate([[0], np.cumsum(count)[:-1]])
    ex = np.concatenate([[0], np.cumsum(per_nz)[:-1]])
    first_ex = np.zeros(n_blocks, np.int64)
    first_ex[nzb[::-1]] = ex[::-1]  # the first non-zero of each block wins
    nz_start = block_start[nzb] + 1 + ex - first_ex[nzb]
    n_events = int(count.sum())
    val = np.zeros(n_events, np.uint64)
    length = np.zeros(n_events, np.uint64)

    s = _category(diff)
    val[block_start] = (dc_code[tsel, s] << s.astype(np.uint64)) | fields(diff, s)
    length[block_start] = dc_size[tsel, s] + s.astype(np.uint64)
    zrl_pos = np.repeat(nz_start, zrl) + (np.arange(int(zrl.sum()))
                                           - np.repeat(np.cumsum(zrl) - zrl, zrl))
    zrl_t = np.repeat(tsel[nzb], zrl)
    val[zrl_pos] = ac_code[zrl_t, 0xF0]
    length[zrl_pos] = ac_size[zrl_t, 0xF0]
    x = coefs[nzb, nzk]
    s = _category(x)
    sym = (run << 4) | s
    pos = nz_start + zrl
    val[pos] = (ac_code[tsel[nzb], sym] << s.astype(np.uint64)) | fields(x, s)
    length[pos] = ac_size[tsel[nzb], sym] + s.astype(np.uint64)
    eob_b = np.flatnonzero(eob)
    val[block_start[eob_b] + count[eob_b] - 1] = ac_code[tsel[eob_b], 0x00]
    length[block_start[eob_b] + count[eob_b] - 1] = ac_size[tsel[eob_b], 0x00]
    if (length == 0).any():
        raise ValueError("a symbol has no code in the Annex K tables")

    # One packed, stuffed segment per restart interval, RSTn between them.
    event_interval = np.repeat(interval, count)
    cuts = np.flatnonzero(np.diff(event_interval)) + 1
    pieces = []
    for i, (a, b) in enumerate(zip(np.concatenate([[0], cuts]),
                                   np.concatenate([cuts, [n_events]]))):
        if i:
            pieces.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
        pieces.append(_stuff(_pack(val[a:b], length[a:b])).tobytes())
    scan_data = b"".join(pieces)

    out = [b"\xff\xd8"]
    if jfif:
        out.append(_segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    if adobe_transform is not None:
        out.append(_segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe_transform])))
    for c in range(min(ncomp, 2)):
        q = qtables[c]
        if q.max() > 255:
            out.append(_segment(0xDB, bytes([0x10 | c]) + q.astype(">u2").tobytes()))
        else:
            out.append(_segment(0xDB, bytes([c]) + q.astype(np.uint8).tobytes()))
    frame = bytes([precision]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    frame += bytes([ncomp])
    for c, (h, v) in enumerate(sampling):
        frame += bytes([component_ids[c], (h << 4) | v, min(c, 1)])
    out.append(_segment(sof, frame))
    for cls, tabs in ((0x00, (DC_LUMA, DC_CHROMA)), (0x10, (AC_LUMA, AC_CHROMA))):
        for t in range(min(ncomp, 2)):
            out.append(_segment(0xC4, bytes([cls | t]) + tabs[t][0] + tabs[t][1]))
    if restart_interval:
        out.append(_segment(0xDD, restart_interval.to_bytes(2, "big")))
    scan = bytes([ncomp])
    for c in range(ncomp):
        t = min(c, 1)
        scan += bytes([component_ids[c], (t << 4) | t])
    out.append(_segment(0xDA, scan + b"\x00\x3f\x00"))
    out.append(scan_data)
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path, image, **kw):
    """encode_jpeg(image, **kw) written to `path`; returns the byte count."""
    data = encode_jpeg(image, **kw)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def encode_lossless_jpeg(image):
    """A lossless (SOF3) JPEG of a uint8 [H, W] image: predictor 1 (the
    sample to the left; above for the first column), no point transform,
    the Annex K luminance DC table for the differences."""
    img = np.asarray(image).astype(np.int64)
    h, w = img.shape
    pred = np.empty_like(img)
    pred[0, 0] = 128
    pred[0, 1:] = img[0, :-1]
    pred[1:, 0] = img[:-1, 0]
    pred[1:, 1:] = img[1:, :-1]
    diff = (img - pred).reshape(-1)
    s = _category(diff)
    code, size = _codes(DC_LUMA)
    val = (code[s] << s.astype(np.uint64)) | np.where(diff >= 0, diff,
                                                       diff + (1 << s) - 1).astype(np.uint64)
    data = _stuff(_pack(val, size[s] + s.astype(np.uint64))).tobytes()
    frame = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([1, 1, 0x11, 0])
    return (b"\xff\xd8" + _segment(0xC3, frame)
            + _segment(0xC4, bytes([0]) + DC_LUMA[0] + DC_LUMA[1])
            + _segment(0xDA, bytes([1, 1, 0x00, 1, 0, 0])) + data + b"\xff\xd9")
