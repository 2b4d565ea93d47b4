"""The subset of msgpack that flax's legacy checkpoints use, in pure Python.

flax.serialization writes a state dict with `msgpack.packb(tree,
default=_msgpack_ext_pack, strict_types=True)`: maps with str keys, str,
int, float, bool, nil, and numpy arrays as ext type 1 whose payload is
itself msgpack of (shape array, dtype name str, raw C-order bytes bin);
numpy scalars are ext type 3 with the same payload. Arrays above 2**30
bytes are split into '__msgpack_chunked_array__' maps. This module packs
and unpacks exactly that, so the port reads and writes the JAX package's
`checkpoint_<step>` files on a machine without msgpack or flax.
"""

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_MAX_CHUNK_BYTES = 2**30


def _pack_obj(obj, out):
    # numpy first: np.float64 is a float subclass, and flax packs numpy
    # scalars as ext type 3, not as msgpack floats.
    if isinstance(obj, np.ndarray):
        if obj.nbytes > _MAX_CHUNK_BYTES:
            _pack_obj(_chunk(obj), out)
        else:
            _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 2**8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 2**16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        if n < 2**8:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n < 2**16:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x90 | n]))
        elif n < 2**16:
            out.append(b"\xdc" + struct.pack(">H", n))
        else:
            out.append(b"\xdd" + struct.pack(">I", n))
        for v in obj:
            _pack_obj(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x80 | n]))
        elif n < 2**16:
            out.append(b"\xde" + struct.pack(">H", n))
        else:
            out.append(b"\xdf" + struct.pack(">I", n))
        for k, v in obj.items():
            _pack_obj(k, out)
            _pack_obj(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_int(v, out):
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif 0 <= v < 2**8:
        out.append(b"\xcc" + struct.pack(">B", v))
    elif 0 <= v < 2**16:
        out.append(b"\xcd" + struct.pack(">H", v))
    elif 0 <= v < 2**32:
        out.append(b"\xce" + struct.pack(">I", v))
    elif 0 <= v < 2**64:
        out.append(b"\xcf" + struct.pack(">Q", v))
    elif -(2**7) <= v:
        out.append(b"\xd0" + struct.pack(">b", v))
    elif -(2**15) <= v:
        out.append(b"\xd1" + struct.pack(">h", v))
    elif -(2**31) <= v:
        out.append(b"\xd2" + struct.pack(">i", v))
    elif -(2**63) <= v:
        out.append(b"\xd3" + struct.pack(">q", v))
    else:
        raise OverflowError(v)


def _pack_ext(code, data, out):
    n = len(data)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        out.append(bytes([fix[n], code]))
    elif n < 2**8:
        out.append(b"\xc7" + struct.pack(">Bb", n, code))
    elif n < 2**16:
        out.append(b"\xc8" + struct.pack(">Hb", n, code))
    else:
        out.append(b"\xc9" + struct.pack(">Ib", n, code))
    out.append(data)


def _ndarray_payload(arr):
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb([list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()])


def _chunk(arr):
    flat = arr.reshape(-1)
    step = max(1, _MAX_CHUNK_BYTES // arr.dtype.itemsize)
    chunks = [flat[i : i + step] for i in range(0, flat.size, step)]
    return {
        "__msgpack_chunked_array__": True,
        "shape": {str(i): d for i, d in enumerate(arr.shape)},
        "chunks": {str(i): c for i, c in enumerate(chunks)},
    }


def packb(obj):
    """msgpack bytes of a tree of dict/list/str/int/float/bool/None/bytes and
    numpy arrays (flax's layout for arrays)."""
    out = []
    _pack_obj(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[t])
            return bytes(self.take(n))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if t == 0xCA:
            return self.unpack(">f")
        if t == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in ints:
            return self.unpack(ints[t])
        if t in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            n = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}[t]
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if t in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t])
            return str(self.take(n), "utf-8")
        if t in (0xDC, 0xDD):
            n = self.unpack(">H" if t == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if t in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _dtype(name):
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported by this reader")
    return np.dtype(name)


def _ext(code, data):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, buf = unpackb(data, _unchunk=False)
    arr = np.frombuffer(buf, dtype=_dtype(dtype_name)).reshape(shape).copy()
    return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk_tree(d):
    if isinstance(d, dict):
        if "__msgpack_chunked_array__" in d:
            shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
            chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_tree(v) for k, v in d.items()}
    return d


def unpackb(data, _unchunk=True):
    """Inverse of packb (and of flax.serialization.msgpack_serialize)."""
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk_tree(obj) if _unchunk else obj
