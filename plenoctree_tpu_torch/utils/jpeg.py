"""JPEG reading with numpy and a small C++ scan decoder: the pixels PIL gives.

The machine that runs the port on the GPU has no PIL, imageio or cv2, and
the JAX loaders read frames through PIL, so the port decodes JPEG itself
and gives what `np.array(Image.open(f))` gives there (Pillow with
libjpeg-turbo at its defaults), bit for bit:
- the integer IDCT of libjpeg's jidctint.c (`JDCT_ISLOW`), with its
  DESCALE rounding after each pass and its range-limit table;
- fancy upsampling (jdsample.c): the h2v1, h1v2 and h2v2 triangle filters
  with their alternating rounding biases and duplicated edge rows and
  columns; pixel replication for the other integral ratios, and for h2v1 /
  h2v2 when a component is at most 2 samples wide;
- the fixed-point YCbCr -> RGB tables of jdcolor.c, the colour transform
  chosen from the file as jdapimin.c chooses it (JFIF, Adobe APP14's
  transform flag, component ids 'R', 'G', 'B');
- greyscale as [H, W]; EXIF orientation is not applied (PIL's
  `Image.open` does not apply it).

It reads Huffman-coded 8-bit files with 1 or 3 components: baseline,
extended sequential and progressive (spectral selection, successive
approximation, EOB runs), any integral sampling factors up to 4, restart
intervals, 8- and 16-bit quantisation tables, custom and optimised Huffman
tables. Arithmetic coding, 12-bit samples, the lossless and hierarchical
processes, 4-component (CMYK/YCCK) files and corrupt or truncated streams
raise a ValueError naming the file.

Entropy decoding is sequential, so it runs in C++ (`csrc/jpeg_scan.cc`,
built with g++ at first use into `build/native/` and bound with ctypes, as
`native.py` builds its library); the pure-Python decoder beside it is its
oracle and the path where the library does not build or
`PLENOCTREE_NO_NATIVE=1` is set. Both fill the same int16 coefficient
arrays, one [blocks, 64] (natural order) per component. Everything after
them (dequantisation, the IDCT, upsampling, colour) is numpy over all the
blocks of a component at once. `build_error` keeps why the library did
not load, `calls` counts scans per path, and `summary()` gives one line
for a loader's output.
"""

import ctypes
import os
import threading
import time
from pathlib import Path

import numpy as np

from plenoctree_tpu_torch.kernels._build import build_shared_library

SIGNATURE = b"\xff\xd8\xff"
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "jpeg_scan.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

# jpeg_natural_order: the natural index of each zigzag position, with 16
# extra entries of 63 that absorb a run past the end of a corrupt block.
NATURAL = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8,
                                                    (n % 8) if (n // 8 + n % 8) % 2 == 0
                                                    else (n // 8))) + [63] * 16, np.int32)

# Scan kinds, as both decoders number them.
SEQUENTIAL, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE = range(5)

_LOCK = threading.Lock()  # guards the counters
_BUILD_LOCK = threading.Lock()
_LIB = None
_TRIED = False
build_error = None  # why get_lib() returned None, once it has been tried
calls = {"native": 0, "python": 0}  # scans decoded per path
timing = {"entropy_s": 0.0, "rest_s": 0.0, "files": 0, "bytes": 0, "pixels": 0}

_ERRORS = {
    1: "entropy-coded data ends before the scan does (truncated or corrupt)",
    2: "a Huffman code that is not in its table",
    3: "a restart marker missing or out of order",
    4: "a DC difference category over 15",
}


class _Corrupt(Exception):
    pass


def _count(path):
    with _LOCK:
        calls[path] += 1


def get_lib():
    """The loaded scan decoder, or None if it is unavailable (see
    `build_error`)."""
    global _LIB, _TRIED, build_error
    if _TRIED:  # set only once the build or the load has ended, either way
        return _LIB
    with _BUILD_LOCK:  # threads decoding a split's frames wait for one build
        if _TRIED:
            return _LIB
        if os.environ.get("PLENOCTREE_NO_NATIVE"):
            build_error = "PLENOCTREE_NO_NATIVE is set"
        else:
            try:
                out, _ = build_shared_library("g++", CXX_FLAGS, "jpeg_scan", [SOURCE], BUILD_DIR)
                lib = ctypes.CDLL(str(out))
                ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
                lib.pn_jpeg_scan.restype = i64
                lib.pn_jpeg_scan.argtypes = [ptr, i64, i64, i32, ptr, ptr, ptr, i64, i32, ptr,
                                             i32, i32, i32, i32, i32]
                _LIB = lib
            except Exception as e:  # no g++, a failed build or load: the Python decoder
                build_error = f"{type(e).__name__}: {e}"
        _TRIED = True
        return _LIB


def summary():
    """One line for a loader's output: the path taken and the scans."""
    counts = f"scans native={calls['native']} python={calls['python']}"
    if _LIB is not None:
        return f"g++ scan decoder, {counts}"
    return f"Python scan decoder ({build_error or 'library not tried'}), {counts}"


def is_jpeg(path):
    """Whether the file starts with a JPEG SOI and a marker."""
    with open(path, "rb") as f:
        return f.read(len(SIGNATURE)) == SIGNATURE


# --------------------------------------------------------------------------
# Huffman tables and the pure-Python scan decoder.


def _derive(bits, vals):
    """libjpeg's jpeg_make_d_derived_tbl: (maxcode, valoffset, values)."""
    maxcode = [-1] * 18
    valoffset = [0] * 17
    code, k = 0, 0
    for length in range(1, 17):
        n = bits[length - 1]
        if n:
            valoffset[length] = k - code
            code += n
            k += n
            maxcode[length] = code - 1
        code <<= 1
    maxcode[17] = 0xFFFFF  # ends a search that ran past 16 bits
    return maxcode, valoffset, list(vals)


class _Bits:
    """MSB-first bits of entropy-coded data, 0xFF00 unstuffed; reading past
    a marker raises."""

    def __init__(self, data, pos):
        self.data, self.pos, self.acc, self.n = data, pos, 0, 0

    def bit(self):
        if self.n == 0:
            d = self.data
            if self.pos >= len(d):
                raise _Corrupt(1)
            b = d[self.pos]
            if b == 0xFF:
                if self.pos + 1 >= len(d) or d[self.pos + 1] != 0:
                    raise _Corrupt(1)
                self.pos += 2
            else:
                self.pos += 1
            self.acc, self.n = b, 8
        self.n -= 1
        return (self.acc >> self.n) & 1

    def bits(self, k):
        v = 0
        for _ in range(k):
            v = (v << 1) | self.bit()
        return v

    def decode(self, table):
        maxcode, valoffset, vals = table
        code, length = self.bit(), 1
        while code > maxcode[length]:
            code = (code << 1) | self.bit()
            length += 1
        if length > 16:
            raise _Corrupt(2)
        return vals[code + valoffset[length]]

    def restart(self, expect):
        """Drop the partial byte, skip to the next marker, which must be
        RST<expect>."""
        self.n = 0
        d, p = self.data, self.pos
        while p + 1 < len(d) and not (d[p] == 0xFF and d[p + 1] not in (0x00, 0xFF)):
            p += 1
        if p + 1 >= len(d) or d[p + 1] != 0xD0 + expect:
            raise _Corrupt(3)
        self.pos = p + 2


def _extend(r, s):
    return r - (1 << s) + 1 if r < (1 << (s - 1)) else r


def _i16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _scan_python(data, pos, coefs, slot_comp, mcu_blocks, restart, kind, tables, ss, se, al):
    """Decode one scan into `coefs` (one int16 [blocks, 64] per scan
    component) and return the byte position where its data stopped.
    slot_comp[i] is the scan component of MCU slot i, mcu_blocks[m, i] the
    block it fills; tables[c] = (dc table, ac table) of scan component c."""
    br = _Bits(data, pos)
    nat = NATURAL
    last_dc = [0] * len(coefs)
    eobrun = 0
    next_rst = 0
    p1, m1 = 1 << al, -1 << al
    n_mcu, bpm = mcu_blocks.shape
    for m in range(n_mcu):
        if restart and m and m % restart == 0:
            br.restart(next_rst)
            next_rst = (next_rst + 1) % 8
            last_dc = [0] * len(coefs)
            eobrun = 0
        for i in range(bpm):
            c = slot_comp[i]
            blk = coefs[c][mcu_blocks[m, i]]
            dc_tab, ac_tab = tables[c]
            if kind in (SEQUENTIAL, DC_FIRST):
                s = br.decode(dc_tab)
                if s > 15:
                    raise _Corrupt(4)
                if s:
                    s = _extend(br.bits(s), s)
                last_dc[c] += s
                blk[0] = _i16(last_dc[c] << al)
                if kind == SEQUENTIAL:
                    k = 1
                    while k < 64:
                        rs = br.decode(ac_tab)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[nat[k]] = _i16(_extend(br.bits(s), s))
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
            elif kind == DC_REFINE:
                if br.bit():
                    blk[0] = _i16(int(blk[0]) | p1)
            elif kind == AC_FIRST:
                if eobrun > 0:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = br.decode(ac_tab)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        blk[nat[k]] = _i16(_extend(br.bits(s), s) << al)
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + (br.bits(r) if r else 0) - 1
                        break
                    k += 1
            else:  # AC_REFINE: jdphuff.c decode_mcu_AC_refine
                k = ss
                if eobrun == 0:
                    while k <= se:
                        rs = br.decode(ac_tab)
                        r, s = rs >> 4, rs & 15
                        if s:
                            s = p1 if br.bit() else m1
                        elif r != 15:
                            eobrun = (1 << r) + (br.bits(r) if r else 0)
                            break
                        while k <= se:
                            z = nat[k]
                            if blk[z] != 0:
                                if br.bit() and (int(blk[z]) & p1) == 0:
                                    blk[z] = _i16(int(blk[z]) + (p1 if blk[z] >= 0 else m1))
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            blk[nat[k]] = s
                        k += 1
                if eobrun > 0:
                    while k <= se:
                        z = nat[k]
                        if blk[z] != 0 and br.bit() and (int(blk[z]) & p1) == 0:
                            blk[z] = _i16(int(blk[z]) + (p1 if blk[z] >= 0 else m1))
                        k += 1
                    eobrun -= 1
    return br.pos


def _scan_native(lib, data, pos, coefs, slot_comp, mcu_blocks, restart, kind, tables,
                 ss, se, al):
    """The same scan through csrc/jpeg_scan.cc."""
    buf = np.frombuffer(data, np.uint8)
    ptrs = (ctypes.c_void_p * len(coefs))(*[c.ctypes.data for c in coefs])
    tab = np.zeros((len(coefs), 2, 17 + 256), np.int32)  # counts, then symbols
    for c, pair in enumerate(tables):
        for j, t in enumerate(pair):
            if t is not None:
                bits, vals = t
                tab[c, j, 1:17] = bits
                tab[c, j, 17:17 + len(vals)] = list(vals)
                tab[c, j, 0] = 1
    slots = np.ascontiguousarray(slot_comp, np.int32)
    blocks = np.ascontiguousarray(mcu_blocks, np.int32)
    rc = lib.pn_jpeg_scan(buf.ctypes.data, buf.size, pos, len(coefs), ptrs, tab.ctypes.data,
                          slots.ctypes.data, blocks.shape[0], blocks.shape[1],
                          blocks.ctypes.data, restart, kind, ss, se, al)
    if rc < 0:
        raise _Corrupt(int(-rc))
    return int(rc)


# --------------------------------------------------------------------------
# Markers.


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qtable = None  # latched at the component's first scan (jdinput.c)


def _geometry(comps, width, height):
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    for c in comps:
        c.dw = -(-width * c.h // hmax)  # downsampled size
        c.dh = -(-height * c.v // vmax)
        c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)  # blocks a lone-component scan covers
        c.aw, c.ah = mcux * c.h, mcuy * c.v  # blocks allocated (whole MCUs)
        c.coef = np.zeros((c.ah * c.aw, 64), np.int16)
    return hmax, vmax, mcux, mcuy


def _scan_layout(scomps, mcux, mcuy):
    """(slot_comp [bpm], mcu_blocks [n_mcu, bpm]) of a scan, as libjpeg
    walks it: a lone component block by block over ceil(size / 8) blocks;
    several, MCU by MCU, each component's v x h blocks."""
    if len(scomps) == 1:
        c = scomps[0]
        by, bx = np.mgrid[0:c.bh, 0:c.bw]
        return np.zeros(1, np.int32), (by * c.aw + bx).reshape(-1, 1).astype(np.int32)
    slot, cols = [], []
    my, mx = np.mgrid[0:mcuy, 0:mcux]
    for i, c in enumerate(scomps):
        for v in range(c.v):
            for h in range(c.h):
                slot.append(i)
                cols.append(((my * c.v + v) * c.aw + mx * c.h + h).reshape(-1))
    return np.array(slot, np.int32), np.stack(cols, axis=1).astype(np.int32)


def _u16(data, p):
    return (data[p] << 8) | data[p + 1]


_REFUSED = {
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical (SOF7)",
    0xC8: "the reserved JPG extension (SOF8)",
    0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)",
    0xCB: "arithmetic coding (SOF11)", 0xCD: "arithmetic coding (SOF13)",
    0xCE: "arithmetic coding (SOF14)", 0xCF: "arithmetic coding (SOF15)",
}


def decode_coefficients(data, path="<bytes>", native=None):
    """Parse a JPEG and entropy-decode every scan.

    Returns (width, height, components, colour transform) where each
    component has .coef (int16 [blocks, 64], natural order), .qtable
    (natural order), .h, .v and its sizes; the colour transform is "ycc"
    (YCbCr -> RGB), "rgb" (none) or "grey". `native` True/False forces a
    path; None takes the C++ decoder where it loads."""
    lib = get_lib() if native is not False else None
    if native and lib is None:
        raise RuntimeError(f"the C++ scan decoder is unavailable: {build_error}")

    def fail(reason):
        raise ValueError(f"{path}: {reason}")

    if not data.startswith(SIGNATURE):
        fail("not a JPEG file")
    qt = [None] * 4
    dc_tabs, ac_tabs = [None] * 4, [None] * 4
    restart = 0
    frame = None
    progressive = False
    jfif = adobe = False
    adobe_transform = 0
    pos, n = 2, len(data)
    scans = 0
    while True:
        # jdmarker.c next_marker: skip anything up to 0xFF, then fill bytes;
        # a stuffed 0xFF00 left after a scan is skipped too
        m = 0
        while m == 0:
            while pos < n and data[pos] != 0xFF:
                pos += 1
            while pos < n and data[pos] == 0xFF:
                pos += 1
            if pos >= n:
                fail("the file ends before its EOI marker (truncated)")
            m = data[pos]
            pos += 1
        if m == 0xD9:  # EOI
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:  # parameterless
            continue
        if pos + 2 > n:
            fail("the file ends inside a marker segment (truncated)")
        length = _u16(data, pos)
        if length < 2 or pos + length > n:
            fail(f"marker 0xFF{m:02X} has a bad length {length} (truncated or corrupt)")
        seg = data[pos + 2:pos + length]
        pos += length
        if m in _REFUSED:
            fail(f"{_REFUSED[m]} is not supported: the port reads Huffman-coded "
                 "baseline, extended sequential and progressive JPEG")
        if m in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                fail("more than one frame header (corrupt)")
            if len(seg) < 6:
                fail("short frame header (corrupt)")
            precision, height, width, nc = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
            if precision != 8:
                fail(f"{precision}-bit samples are not supported (8-bit only)")
            if nc == 4:
                fail("4-component (CMYK/YCCK) JPEG is not supported")
            if nc not in (1, 3):
                fail(f"{nc} components are not supported (1 or 3)")
            if height == 0 or width == 0:
                fail(f"frame size {width}x{height} (a DNL marker) is not supported")
            if len(seg) < 6 + 3 * nc:
                fail("short frame header (corrupt)")
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    fail(f"component {cid}: sampling {h}x{v} or table {tq} out of range")
                comps.append(_Component(cid, h, v, tq))
            hmax, vmax, mcux, mcuy = _geometry(comps, width, height)
            for c in comps:
                if hmax % c.h or vmax % c.v:
                    fail(f"sampling factors {[(c.h, c.v) for c in comps]} are not integral "
                         "ratios")
            progressive = m == 0xC2
            frame = (width, height, comps)
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                if i + 17 > len(seg):
                    fail("short DHT segment (corrupt)")
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = list(seg[i + 1:i + 17])
                count = sum(bits)
                if tc > 1 or th > 3 or count > 256 or i + 17 + count > len(seg):
                    fail("bad DHT segment (corrupt)")
                (ac_tabs if tc else dc_tabs)[th] = (bits, bytes(seg[i + 17:i + 17 + count]))
                i += 17 + count
        elif m == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                if tq > 3 or pq > 1 or i + 1 + size > len(seg):
                    fail("bad DQT segment (corrupt)")
                raw = np.frombuffer(bytes(seg[i + 1:i + 1 + size]), ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[NATURAL[:64]] = raw
                qt[tq] = table
                i += 1 + size
        elif m == 0xDD:
            if len(seg) < 2:
                fail("short DRI segment (corrupt)")
            restart = _u16(seg, 0)
        elif m == 0xE0:
            jfif = jfif or (len(seg) >= 14 and seg[:5] == b"JFIF\x00")
        elif m == 0xEE:
            if len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe, adobe_transform = True, seg[11]
        elif m == 0xDA:
            if frame is None:
                fail("a scan before the frame header (corrupt)")
            width, height, comps = frame
            ns = seg[0] if seg else 0
            if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
                fail("bad scan header (corrupt)")
            scomps, tables = [], []
            for i in range(ns):
                cid, tt = seg[1 + 2 * i], seg[2 + 2 * i]
                match = [c for c in comps if c.id == cid]
                if not match:
                    fail(f"a scan names component {cid}, which the frame lacks (corrupt)")
                scomps.append(match[0])
                tables.append((tt >> 4, tt & 15))
            if ns > 1 and sum(c.h * c.v for c in scomps) > 10:
                fail("more than 10 blocks in an MCU (corrupt)")
            ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            ah, al = ahal >> 4, ahal & 15
            if progressive:
                bad = (se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
                bad = bad or (ah != 0 and al != ah - 1) or al > 13
                if bad:
                    fail(f"bad progression Ss={ss} Se={se} Ah={ah} Al={al} (corrupt)")
                kind = (DC_REFINE if ah else DC_FIRST) if ss == 0 else (
                    AC_REFINE if ah else AC_FIRST)
            else:
                kind, ss, se, ah, al = SEQUENTIAL, 0, 63, 0, 0
            need_dc = kind in (SEQUENTIAL, DC_FIRST)
            need_ac = kind in (SEQUENTIAL, AC_FIRST, AC_REFINE)
            huff = []
            for (td, ta), c in zip(tables, scomps):
                if c.qtable is None:
                    if qt[c.tq] is None:
                        fail(f"component {c.id} uses quantisation table {c.tq}, never "
                             "defined (corrupt)")
                    c.qtable = qt[c.tq].copy()
                dct = dc_tabs[td] if need_dc and td < 4 else None
                act = ac_tabs[ta] if need_ac and ta < 4 else None
                if (need_dc and dct is None) or (need_ac and act is None):
                    fail("a scan uses a Huffman table never defined (corrupt)")
                huff.append((dct, act))
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            slot_comp, mcu_blocks = _scan_layout(scomps, mcux, mcuy)
            coefs = [c.coef for c in scomps]
            try:
                if lib is not None:
                    pos = _scan_native(lib, data, pos, coefs, slot_comp, mcu_blocks, restart,
                                       kind, huff, ss, se, al)
                    _count("native")
                else:
                    derived = [tuple(None if t is None else _derive(*t) for t in pair)
                               for pair in huff]
                    pos = _scan_python(data, pos, coefs, slot_comp, mcu_blocks, restart,
                                       kind, derived, ss, se, al)
                    _count("python")
            except _Corrupt as e:
                fail(f"corrupt scan {scans}: {_ERRORS[e.args[0]]}")
            scans += 1
    if frame is None or scans == 0:
        fail("no frame header or no scan before EOI")
    width, height, comps = frame
    if len(comps) == 1:
        transform = "grey"
    elif jfif:
        transform = "ycc"
    elif adobe:
        transform = "rgb" if adobe_transform == 0 else "ycc"
    elif [c.id for c in comps] == [82, 71, 66]:
        transform = "rgb"
    else:
        transform = "ycc"
    return width, height, comps, transform


# --------------------------------------------------------------------------
# Reconstruction: one implementation, numpy over all blocks.

# jidctint.c's constants, CONST_BITS = 13, and PASS1_BITS = 2.
_F = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373, c1175=9633,
          c1501=12299, c1847=15137, c1961=16069, c2053=16819, c2562=20995, c3072=25172)
_CONST_BITS, _PASS1_BITS = 13, 2

# The post-IDCT range-limit table (jdmaster.c prepare_range_limit_table),
# indexed by the descaled value & RANGE_MASK (1023): x + 128 clamped to
# [0, 255] for x in [-512, 511], wrapping outside.
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                              np.arange(0, 128)]).astype(np.uint8)


def _idct_1d(x, shift):
    """One jpeg_idct_islow pass over 8 arrays (frequencies 0..7); returns
    the 8 outputs DESCALEd by `shift`."""
    f = _F
    z1 = (x[2] + x[6]) * f["c0541"]
    tmp2 = z1 - x[6] * f["c1847"]
    tmp3 = z1 + x[2] * f["c0765"]
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["c1175"]
    t0 = t0 * f["c0298"]
    t1 = t1 * f["c2053"]
    t2 = t2 * f["c3072"]
    t3 = t3 * f["c1501"]
    z1 = z1 * -f["c0899"]
    z2 = z2 * -f["c2562"]
    z3 = z3 * -f["c1961"] + z5
    z4 = z4 * -f["c0390"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    r = 1 << (shift - 1)
    return [(t10 + t3 + r) >> shift, (t11 + t2 + r) >> shift, (t12 + t1 + r) >> shift,
            (t13 + t0 + r) >> shift, (t13 - t0 + r) >> shift, (t12 - t1 + r) >> shift,
            (t11 - t2 + r) >> shift, (t10 - t3 + r) >> shift]


# A pass's largest intermediate is 178,219 times its largest input (and
# the rounding term 2^17), so inputs up to this bound are exact in int32;
# larger ones (crafted files) take int64, as jidctint.c's JLONG.
_INT32_INPUT_MAX = 12000


def _exact_dtype(x):
    return np.int32 if int(np.abs(x).max(initial=0)) <= _INT32_INPUT_MAX else np.int64


def idct_islow(coef, qtable, chunk=32768):
    """jpeg_idct_islow of every block: int16 [n, 64] coefficients (natural
    order) and a natural-order table -> uint8 [n, 8, 8] samples."""
    n = coef.shape[0]
    out = np.empty((n, 8, 8), np.uint8)
    q = qtable.astype(np.int64).reshape(8, 8)
    for a in range(0, n, chunk):
        blk = coef[a:a + chunk].reshape(-1, 8, 8) * q  # int64
        cols = np.ascontiguousarray(blk.transpose(1, 0, 2), _exact_dtype(blk))  # [row freq, n, col]
        ws = np.stack(_idct_1d(list(cols), _CONST_BITS - _PASS1_BITS))  # pass 1: columns
        rows = np.ascontiguousarray(ws.transpose(2, 1, 0), _exact_dtype(ws))  # [col freq, n, row]
        res = _idct_1d(list(rows), _CONST_BITS + _PASS1_BITS + 3)  # pass 2: rows
        out[a:a + chunk] = _IDCT_LIMIT[np.stack(res, axis=-1) & 1023]
    return out


def _component_plane(c):
    """A component's samples, [dh, dw] int32 (the IDCT output cropped)."""
    blocks = idct_islow(c.coef, c.qtable).reshape(c.ah, c.aw, 8, 8)
    plane = blocks.transpose(0, 2, 1, 3).reshape(c.ah * 8, c.aw * 8)
    return plane[:c.dh, :c.dw].astype(np.int32)


def _fancy_pairs(x, axis, before, after, shift):
    """Output sample pairs along `axis`: (3x + x[i-1] + before) >> shift and
    (3x + x[i+1] + after) >> shift, the edge samples duplicated."""
    x = np.moveaxis(x, axis, -1)
    prev = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    nxt = np.concatenate([x[..., 1:], x[..., -1:]], axis=-1)
    out = np.empty(x.shape[:-1] + (2 * x.shape[-1],), np.int32)
    out[..., 0::2] = (3 * x + prev + before) >> shift
    out[..., 1::2] = (3 * x + nxt + after) >> shift
    return np.moveaxis(out, -1, axis)


def _upsample(plane, c, hmax, vmax):
    """jdsample.c's method for this component's ratio."""
    rh, rv = hmax // c.h, vmax // c.v
    if (rh, rv) == (1, 1):
        return plane
    if (rh, rv) == (2, 1) and c.dw > 2:  # h2v1_fancy_upsample
        return _fancy_pairs(plane, 1, 1, 2, 2)
    if (rh, rv) == (1, 2):  # h1v2_fancy_upsample
        return _fancy_pairs(plane, 0, 1, 2, 2)
    if (rh, rv) == (2, 2) and c.dw > 2:  # h2v2_fancy_upsample
        up = np.concatenate([plane[:1], plane[:-1]], axis=0)
        down = np.concatenate([plane[1:], plane[-1:]], axis=0)
        colsum = np.empty((2 * plane.shape[0], plane.shape[1]), np.int32)
        colsum[0::2] = 3 * plane + up
        colsum[1::2] = 3 * plane + down
        return _fancy_pairs(colsum, 1, 8, 7, 4)
    return np.repeat(np.repeat(plane, rv, axis=0), rh, axis=1)  # int_upsample, h2v1/h2v2


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()
# ycc_rgb_convert per (Y, Cr), (Y, Cb) pair and its green term per (Cb, Cr)
# pair, each channel clamped by the simple range-limit table (jdmaster.c):
# one gather per pixel and channel.
_Y = np.arange(256, dtype=np.int64)[:, None]
_R_LUT = np.clip(_Y + _CR_R[None, :], 0, 255).astype(np.uint8).reshape(-1)
_B_LUT = np.clip(_Y + _CB_B[None, :], 0, 255).astype(np.uint8).reshape(-1)
_G_TERM = ((_CB_G[:, None] + _CR_G[None, :]) >> 16).astype(np.int32).reshape(-1)
_RANGE = np.clip(np.arange(-512, 512), 0, 255).astype(np.uint8)  # x + 512 -> clamp(x)


def reconstruct(width, height, comps, transform):
    """Samples -> uint8 [H, W] (grey) or [H, W, 3] (RGB)."""
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = [_upsample(_component_plane(c), c, hmax, vmax)[:height, :width] for c in comps]
    if transform == "grey":
        return planes[0].astype(np.uint8)
    if transform == "rgb":
        return np.stack(planes, axis=-1).astype(np.uint8)
    y, cb, cr = planes
    y256 = y << 8
    out = np.empty((height, width, 3), np.uint8)
    out[..., 0] = _R_LUT[y256 | cr]
    out[..., 1] = _RANGE[y + 512 + _G_TERM[(cb << 8) | cr]]
    out[..., 2] = _B_LUT[y256 | cb]
    return out


def decode_jpeg(data, path="<bytes>", native=None):
    """JPEG bytes -> uint8 [H, W] or [H, W, 3], as PIL decodes them."""
    t0 = time.perf_counter()
    width, height, comps, transform = decode_coefficients(data, path, native)
    t1 = time.perf_counter()
    out = reconstruct(width, height, comps, transform)
    t2 = time.perf_counter()
    with _LOCK:
        timing["entropy_s"] += t1 - t0
        timing["rest_s"] += t2 - t1
        timing["files"] += 1
        timing["bytes"] += len(data)
        timing["pixels"] += width * height
    return out


def read_jpeg(path, native=None):
    """A JPEG file as uint8 [H, W] (greyscale) or [H, W, 3] (RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, str(path), native)
