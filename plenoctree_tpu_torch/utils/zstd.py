"""A Zstandard decoder (RFC 8878) in Python and numpy.

The JAX package saves checkpoints through orbax, whose tensorstore OCDBT
store and zarr chunks are zstd-compressed (utils/ocdbt.py). The GPU host has
no zstd module (Python 3.12's standard library has none, and no zstandard,
tensorstore or numcodecs is installed there), so the port decodes it itself,
as it decodes PNG (utils/png.py) and msgpack (utils/msgpack_lite.py).

`decompress(data)` decodes every frame of `data` (zstd frames and skippable
frames, concatenated) and returns the bytes:
  - single-segment and windowed frames, with or without Frame_Content_Size;
  - raw, RLE and compressed blocks;
  - raw, RLE, Huffman-compressed and treeless literals, in 1 or 4 streams;
  - FSE sequence tables in predefined, RLE, compressed and repeat modes,
    and the three repeat offsets;
  - the content checksum (the low 32 bits of XXH64), verified when the frame
    carries one.
A frame that names a dictionary raises (orbax writes none), as does any
malformed input.

Huffman streams are decoded with tables over every bit position at once:
numpy computes the symbol and code length that a decoder standing at each
position would read, and the walk along the stream jumps 32 symbols per
Python step (the 32-step successor is built by repeated squaring); the
positions in between are gathered by numpy. Sequences run one per Python
step (float arrays give few of them); literal and match copies are slice
copies.
"""

import numpy as np

_FRAME_MAGIC = 0xFD2FB528
_SKIPPABLE_MASK = 0xFFFFFFF0
_SKIPPABLE_MAGIC = 0x184D2A50
_BLOCK_MAX = 128 * 1024

# Literal length codes (base, extra bits), RFC 8878 3.1.1.3.2.1.1.
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512,
                              1024, 2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
# Match length codes.
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

# The predefined distributions (RFC 8878 3.1.1.3.2.2).
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3,
                2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
_MAX_LOG = {"ll": 9, "ml": 9, "of": 8}
_MAX_SYMBOL = {"ll": 35, "ml": 52, "of": 31}

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


class ZstdError(ValueError):
    """Malformed or unsupported zstd data."""


# ---------------------------------------------------------------------------
# XXH64 (the frame checksum)


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc, lane):
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data, seed=0):
    """XXH64 of `data` (bytes-like) as an int."""
    data = bytes(data)
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", count=stripes * 4).tolist()
        m, p1, p2 = _M64, _P1, _P2
        for k in range(0, 4 * stripes, 4):  # _round on each lane, inlined
            x = (v1 + lanes[k] * p2) & m
            v1 = (((x << 31) | (x >> 33)) * p1) & m
            x = (v2 + lanes[k + 1] * p2) & m
            v2 = (((x << 31) | (x >> 33)) * p1) & m
            x = (v3 + lanes[k + 2] * p2) & m
            v3 = (((x << 31) | (x >> 33)) * p1) & m
            x = (v4 + lanes[k + 3] * p2) & m
            v4 = (((x << 31) | (x >> 33)) * p1) & m
        i = stripes * 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = (((h ^ _round(0, v)) * _P1) + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


# ---------------------------------------------------------------------------
# Bit streams


class _BackwardBits:
    """A zstd backward bit stream: read from the last byte's marker bit
    towards the first byte; the first bit read is the most significant.
    Reads past the start give zeros and leave `pos` negative."""

    def __init__(self, data):
        data = bytes(data)
        if not data or data[-1] == 0:
            raise ZstdError("bit stream without its end marker")
        self.buf = b"\x00" * 8 + data + b"\x00" * 8
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n):
        if n == 0:
            return 0
        self.pos -= n
        q = self.pos + 64  # in the padded buffer
        if q < 0:
            raise ZstdError("read far past the start of a bit stream")
        b = q >> 3
        v = int.from_bytes(self.buf[b:b + 9], "little") >> (q & 7)
        return v & ((1 << n) - 1)


def _read_fse_table(data, pos, max_log, max_symbol):
    """An FSE table description at data[pos:] (forward bits): returns
    (normalized counts, accuracy log, position after it)."""
    bits = int.from_bytes(data[pos:pos + 128], "little")  # a description takes < 80 bytes
    nbits_total = 8 * len(data[pos:pos + 128])
    off = 0

    def take(n):
        nonlocal off
        v = (bits >> off) & ((1 << n) - 1)
        off += n
        return v

    log = take(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} > {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    counts = []
    prev_zero = False
    while remaining > 1 and len(counts) <= max_symbol:
        if prev_zero:
            rep = take(2)
            while rep == 3:
                counts += [0] * 3
                rep = take(2)
            counts += [0] * rep
            if len(counts) > max_symbol:
                raise ZstdError("FSE table: zero run past the last symbol")
        mx = (2 * threshold - 1) - remaining
        low = (bits >> off) & (threshold - 1)
        if low < mx:
            count = low
            off += nb - 1
        else:
            count = (bits >> off) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            off += nb
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        prev_zero = count == 0
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    if remaining != 1 or off > nbits_total:
        raise ZstdError("corrupt FSE table description")
    return counts, log, pos + (off + 7) // 8


def _build_fse(counts, log):
    """Decoding table: lists (symbol, nbBits, baseline) per state."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    p = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise ZstdError("corrupt FSE distribution")
    nbits = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] += 1
        nbits[u] = log - (x.bit_length() - 1)
        base[u] = (x << nbits[u]) - size
    return sym, nbits, base, log


def _rle_fse(symbol):
    return [symbol], [0], [0], 0


_DEFAULT_TABLES = {
    "ll": _build_fse(*_LL_DEFAULT),
    "ml": _build_fse(*_ML_DEFAULT),
    "of": _build_fse(*_OF_DEFAULT),
}


# ---------------------------------------------------------------------------
# Huffman literals


def _huffman_weights(data, pos):
    """The Huffman tree description at data[pos:]: (weights of symbols
    0..n-1 with the implied last one, position after it)."""
    hb = data[pos]
    pos += 1
    if hb < 128:  # FSE-compressed weights
        end = pos + hb
        if end > len(data):
            raise ZstdError("truncated Huffman weights")
        counts, log, p = _read_fse_table(data, pos, 6, 255)
        sym, nbits, base, log = _build_fse(counts, log)
        bits = _BackwardBits(data[p:end])
        s1, s2 = bits.read(log), bits.read(log)
        weights = []
        while True:
            weights.append(sym[s1])
            s1 = base[s1] + bits.read(nbits[s1])
            if bits.pos < 0:
                weights.append(sym[s2])
                break
            weights.append(sym[s2])
            s2 = base[s2] + bits.read(nbits[s2])
            if bits.pos < 0:
                weights.append(sym[s1])
                break
            if len(weights) > 255:
                raise ZstdError("too many Huffman weights")
        pos = end
    else:  # 4-bit weights
        n = hb - 127
        nbytes = (n + 1) // 2
        raw = data[pos:pos + nbytes]
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        weights = weights[:n]
        pos += nbytes
    total = sum(1 << (w - 1) for w in weights if w > 0)
    if total == 0:
        raise ZstdError("empty Huffman weights")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if left & (left - 1):
        raise ZstdError("Huffman weights do not complete a tree")
    weights.append(left.bit_length())
    if max_bits > 11:
        raise ZstdError(f"Huffman code length {max_bits} > 11")
    return weights, pos


def _huffman_table(weights):
    """(symbol per code window, code length per window, max code length)."""
    max_bits = sum(1 << (w - 1) for w in weights if w > 0).bit_length() - 1
    syms = np.zeros(1 << max_bits, np.uint8)
    lens = np.zeros(1 << max_bits, np.int64)
    p = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                syms[p:p + n] = s
                lens[p:p + n] = max_bits + 1 - w
                p += n
    return syms, lens, max_bits


_JUMP_LOG = 5  # the walk takes 2**_JUMP_LOG symbols per Python step


def _huffman_stream(data, n_out, table):
    """Decode n_out literals from one Huffman stream (numpy uint8)."""
    syms, lens, max_bits = table
    if n_out == 0:
        if data and (len(data) != 1 or data[0] != 1):
            raise ZstdError("Huffman stream left over")
        return np.zeros(0, np.uint8)
    data = bytes(data)
    if not data or data[-1] == 0:
        raise ZstdError("Huffman stream without its end marker")
    start = 8 * (len(data) - 1) + data[-1].bit_length() - 1
    # The max_bits-bit window a decoder at position p reads: bits
    # [p - max_bits, p), zero below the stream's start; the stream is laid
    # out behind 2 zero bytes (16 bits >= max_bits) and read as u32 words.
    padded = np.frombuffer(b"\x00\x00" + data + b"\x00\x00\x00", np.uint8).astype(np.uint32)
    words = (padded[:-3] | (padded[1:-2] << 8) | (padded[2:-1] << 16) | (padded[3:] << 24))
    q = np.arange(start + 1, dtype=np.int64) + (16 - max_bits)
    win = (words[q >> 3] >> (q & 7).astype(np.uint32)) & ((1 << max_bits) - 1)
    nxt = np.arange(start + 1, dtype=np.int64) - lens[win]
    sink = start + 1  # positions that would read past the start lead here
    nxt = np.append(np.where(nxt < 0, sink, nxt), sink)
    jump = nxt
    for _ in range(_JUMP_LOG):
        jump = jump[jump]
    step = 1 << _JUMP_LOG
    n_anchor = -(-n_out // step)
    item = jump.item
    anchors = [start]
    p = start
    for _ in range(n_anchor - 1):
        p = item(p)
        anchors.append(p)
    pos = np.empty((n_anchor, step), np.int64)
    pos[:, 0] = anchors
    for k in range(1, step):
        pos[:, k] = nxt[pos[:, k - 1]]
    pos = pos.reshape(-1)[:n_out]
    if pos[-1] == sink or nxt[pos[-1]] != 0:
        raise ZstdError("Huffman stream not consumed exactly")
    return syms[win[pos]]


class _State:
    """What a frame's blocks hand on to the next: the Huffman table, the
    sequence tables and the repeat offsets."""

    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(data, pos, state):
    """The literals section at data[pos:]: (literals bytes, position after)."""
    b0 = data[pos]
    ltype = b0 & 3
    sf = (b0 >> 2) & 3
    if ltype in (0, 1):  # raw, RLE
        if sf in (0, 2):
            size, hlen = b0 >> 3, 1
        elif sf == 1:
            size, hlen = (b0 >> 4) + (data[pos + 1] << 4), 2
        else:
            size, hlen = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), 3
        pos += hlen
        if ltype == 0:
            if pos + size > len(data):
                raise ZstdError("truncated raw literals")
            return bytes(data[pos:pos + size]), pos + size
        return bytes(data[pos:pos + 1]) * size, pos + 1
    hlen = {0: 3, 1: 3, 2: 4, 3: 5}[sf]
    c = int.from_bytes(data[pos:pos + hlen], "little")
    bits = {3: 10, 4: 14, 5: 18}[hlen]
    regen = (c >> 4) & ((1 << bits) - 1)
    comp = (c >> (4 + bits)) & ((1 << bits) - 1)
    streams = 1 if sf == 0 else 4
    pos += hlen
    end = pos + comp
    if end > len(data):
        raise ZstdError("truncated compressed literals")
    if ltype == 2:
        weights, p = _huffman_weights(data, pos)
        state.huffman = _huffman_table(weights)
    else:
        if state.huffman is None:
            raise ZstdError("treeless literals without a previous Huffman table")
        p = pos
    if streams == 1:
        out = _huffman_stream(data[p:end], regen, state.huffman)
    else:
        s1, s2, s3 = (int.from_bytes(data[p + 2 * i:p + 2 * i + 2], "little") for i in range(3))
        p += 6
        bounds = [p, p + s1, p + s1 + s2, p + s1 + s2 + s3, end]
        if bounds[3] > end:
            raise ZstdError("bad Huffman jump table")
        each = (regen + 3) // 4
        sizes = [each, each, each, regen - 3 * each]
        if sizes[3] < 0:
            raise ZstdError("bad literal stream sizes")
        out = np.concatenate([
            _huffman_stream(data[bounds[i]:bounds[i + 1]], sizes[i], state.huffman)
            for i in range(4)
        ])
    return out.tobytes(), end


def _seq_table(data, pos, mode, kind, state):
    if mode == 0:
        table = _DEFAULT_TABLES[kind]
    elif mode == 1:
        sym = data[pos]
        if sym > _MAX_SYMBOL[kind]:
            raise ZstdError(f"RLE {kind} symbol {sym} out of range")
        table = _rle_fse(sym)
        pos += 1
    elif mode == 2:
        counts, log, pos = _read_fse_table(data, pos, _MAX_LOG[kind], _MAX_SYMBOL[kind])
        table = _build_fse(counts, log)
    else:
        table = state.tables[kind]
        if table is None:
            raise ZstdError(f"repeat {kind} table without a previous one")
    state.tables[kind] = table
    return pos


def _block(data, out, state):
    """Decode one compressed block (its bytes) onto bytearray `out`."""
    lits, pos = _literals(data, 0, state)
    if pos >= len(data):
        if pos > len(data):
            raise ZstdError("literals past the block")
        out += lits
        return
    b0 = data[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != len(data):
            raise ZstdError("bytes after an empty sequences section")
        out += lits
        return
    modes = data[pos]
    if modes & 3:
        raise ZstdError("reserved sequence mode bits set")
    pos += 1
    pos = _seq_table(data, pos, modes >> 6, "ll", state)
    pos = _seq_table(data, pos, (modes >> 4) & 3, "of", state)
    pos = _seq_table(data, pos, (modes >> 2) & 3, "ml", state)
    ll_sym, ll_nb, ll_base, ll_log = state.tables["ll"]
    of_sym, of_nb, of_base, of_log = state.tables["of"]
    ml_sym, ml_nb, ml_base, ml_log = state.tables["ml"]
    bits = _BackwardBits(data[pos:])
    read = bits.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    r0, r1, r2 = state.reps
    lp = 0
    nlits = len(lits)
    for i in range(nseq):
        of_code, ml_code, ll_code = of_sym[of_s], ml_sym[ml_s], ll_sym[ll_s]
        if of_code > 31:
            raise ZstdError("offset code out of range")
        ov = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if ov > 3:
            offset = ov - 3
            r0, r1, r2 = offset, r0, r1
        else:
            idx = ov - 1 + (ll == 0)
            if idx == 0:
                offset = r0
            elif idx == 1:
                offset = r1
                r0, r1 = r1, r0
            elif idx == 2:
                offset = r2
                r0, r1, r2 = r2, r0, r1
            else:
                offset = r0 - 1
                r0, r1, r2 = offset, r0, r1
        if i + 1 < nseq:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lp + ll > nlits:
            raise ZstdError("sequence past the literals")
        out += lits[lp:lp + ll]
        lp += ll
        n = len(out)
        if offset <= 0 or offset > n:
            raise ZstdError(f"match offset {offset} outside the {n} bytes decoded")
        if offset >= ml:
            out += out[n - offset:n - offset + ml]
        else:
            pattern = bytes(out[n - offset:])
            out += (pattern * (ml // offset + 1))[:ml]
    if bits.pos != 0:
        raise ZstdError("sequence bit stream not consumed exactly")
    state.reps = [r0, r1, r2]
    out += lits[lp:]


def _frame(data, pos, out):
    """Decode the zstd frame whose header starts at data[pos] (after the
    magic) onto `out`; returns the position after the frame."""
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved frame header bit set")
    if not single:
        pos += 1  # window descriptor: the whole output is kept, so unused
    did_size = (0, 1, 2, 4)[did_flag]
    if did_size and int.from_bytes(data[pos:pos + did_size], "little") != 0:
        raise ZstdError("zstd dictionaries are not supported")
    pos += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(data[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            content_size += 256
        pos += fcs_size
    start = len(out)
    state = _State()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, btype, size = h & 1, (h >> 1) & 3, h >> 3
        if btype == 0:
            if pos + size > len(data):
                raise ZstdError("truncated raw block")
            out += data[pos:pos + size]
            pos += size
        elif btype == 1:
            out += data[pos:pos + 1] * size
            pos += 1
        elif btype == 2:
            if size > _BLOCK_MAX or pos + size > len(data):
                raise ZstdError("bad compressed block size")
            _block(memoryview(data)[pos:pos + size].tobytes(), out, state)
            pos += size
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if content_size is not None and len(out) - start != content_size:
        raise ZstdError(f"frame content {len(out) - start} bytes, header says {content_size}")
    if checksum:
        want = int.from_bytes(data[pos:pos + 4], "little")
        got = xxh64(memoryview(out)[start:]) & 0xFFFFFFFF
        if got != want:
            raise ZstdError(f"content checksum mismatch: {got:08x} != {want:08x}")
        pos += 4
    return pos


def decompress(data):
    """Decode every frame of `data` (bytes-like) and return the bytes."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    if not data:
        raise ZstdError("no zstd frame")
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        if magic == _FRAME_MAGIC:
            pos = _frame(data, pos, out)
        elif magic & _SKIPPABLE_MASK == _SKIPPABLE_MAGIC:
            pos += 4 + int.from_bytes(data[pos:pos + 4], "little")
            if pos > len(data):
                raise ZstdError("truncated skippable frame")
        else:
            raise ZstdError(f"not a zstd frame (magic {magic:08x})")
    return bytes(out)
