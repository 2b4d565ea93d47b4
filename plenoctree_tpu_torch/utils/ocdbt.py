"""Read an orbax PyTree checkpoint directory into nested dicts of numpy.

The JAX package saves through `flax.training.checkpoints.save_checkpoint`,
which under flax >= 0.7 (`flax_use_orbax_checkpointing`) hands the state to
orbax. Orbax writes a directory `checkpoint_<step>/`:

  _METADATA            JSON: each leaf's key path and value type
  manifest.ocdbt       the root of a tensorstore OCDBT key-value store
  d/<hash>, ocdbt.process_0/...   its B-tree nodes and data files

and stores each array as a zarr v2 array in that key-value store
(`<a.b.c>/.zarray` and its chunks `<a.b.c>/0.0`, zstd-compressed). This
module reads that layout with numpy and the standard library only (the GPU
host has no tensorstore, orbax, zarr or numcodecs), through the port's own
zstd decoder (utils/zstd.py). The OCDBT format is tensorstore's public
specification (kvstore/ocdbt in its documentation).

Every manifest and B-tree node is checked: its magic, its length, its
format version and its CRC-32C (Castagnoli) footer. Anything this reader
does not know (another compression byte, zarr v3, another codec or dtype,
a numbered manifest) raises a ValueError naming the file.
"""

import json
import os

import numpy as np

from plenoctree_tpu_torch.utils import zstd

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_DTYPES = ("<f2", "<f4", "<f8", "|i1", "<i2", "<i4", "<i8", "|u1", "<u2", "<u4", "<u8", "|b1")
_ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data):
    """CRC-32C (Castagnoli, reflected 0x82F63B78) of bytes-like `data`."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Sequential reads from a decoded body; errors name the file."""

    def __init__(self, data, what):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, msg):
        raise ValueError(f"{self.what}: {msg}")

    def bytes(self, n):
        if self.pos + n > len(self.data):
            self.fail("truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self):
        return self.bytes(1)[0]

    def varint(self):
        value, shift = 0, 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint too long")

    def varints(self, n):
        return [self.varint() for _ in range(n)]


def _decode(buf, magic, what):
    """Check one encoded manifest or node and return its decoded body."""
    if len(buf) < 18:
        raise ValueError(f"{what}: {len(buf)} bytes, too short for an OCDBT encoding")
    got = int.from_bytes(buf[:4], "big")
    if got != magic:
        raise ValueError(f"{what}: magic {got:08x}, want {magic:08x}")
    length = int.from_bytes(buf[4:12], "little")
    if length != len(buf):
        raise ValueError(f"{what}: header length {length} != {len(buf)} bytes")
    crc = int.from_bytes(buf[-4:], "little")
    if crc32c(buf[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    head = _Reader(buf[:-4], what)
    head.pos = 12
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version}")
    compression = head.varint()
    body = buf[head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise ValueError(f"{what}: {e}") from None
    raise ValueError(f"{what}: unknown compression byte {compression}")


def _data_file_table(r):
    """[path relative to the store root] of a manifest's or node's table."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev) or base[i] > prefix[i] + suffix[i]:
            r.fail("bad data file table")
        prev = prev[:prefix[i]] + r.bytes(suffix[i])
        paths.append(prev.decode())
    return paths


def _keys(r, n, interior):
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("bad key prefix")
        prev = prev[:prefix[i]] + r.bytes(suffix[i])
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """The newest version of an OCDBT key-value store in `root`."""

    def __init__(self, root):
        self.root = root
        self._files = {}
        what = os.path.join(root, "manifest.ocdbt")
        if not os.path.isfile(what):
            raise ValueError(f"{what}: no OCDBT manifest")
        with open(what, "rb") as f:
            r = _Reader(_decode(f.read(), _MANIFEST_MAGIC, what), what)
        r.bytes(16)  # uuid
        kind = r.varint()
        if kind != 0:
            r.fail(f"manifest kind {kind} (numbered manifests are not read)")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.u8()  # version_tree_arity_log2
        if r.varint() == 1:  # the nodes' compression: zstd, with its level
            r.bytes(4)
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            self.root_ref = None
            return
        generation = r.varints(n)
        height = [r.u8() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        newest = max(range(n), key=generation.__getitem__)
        if file_id[newest] >= len(files):
            r.fail("root node in an unknown data file")
        self.root_ref = (files[file_id[newest]], offset[newest], length[newest], height[newest])

    def _read(self, rel, offset, length):
        path = os.path.join(self.root, rel)
        if path not in self._files:
            if not os.path.isfile(path):
                raise ValueError(f"{path}: referenced data file is missing")
            with open(path, "rb") as f:
                self._files[path] = f.read()
        data = self._files[path]
        if offset + length > len(data):
            raise ValueError(f"{path}: [{offset}, {offset + length}) past its {len(data)} bytes")
        return data[offset:offset + length], path

    def items(self):
        """{key (str): value (bytes)} of every entry, in key order."""
        out = {}
        if self.root_ref is not None:
            rel, offset, length, height = self.root_ref
            self._node(rel, offset, length, height, b"", out)
        return out

    def _node(self, rel, offset, length, height, prefix, out):
        buf, path = self._read(rel, offset, length)
        what = f"{path}@{offset}"
        r = _Reader(_decode(buf, _NODE_MAGIC, what), what)
        if r.u8() != height:
            r.fail(f"node height differs from its reference ({height})")
        files = _data_file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            refs = [r.varints(n) for _ in range(6)]  # file, offset, length, keys, bytes, indirect
            for i in range(n):
                if refs[0][i] >= len(files):
                    r.fail("child node in an unknown data file")
                self._node(files[refs[0][i]], refs[1][i], refs[2][i], height - 1,
                           prefix + keys[i][:common[i]], out)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k not in (0, 1) for k in kinds):
            r.fail("unknown value kind")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        where = dict(zip(indirect, zip(ids, offsets)))
        for i in range(n):
            if kinds[i] == 0:
                value = r.bytes(lengths[i])
            else:
                fid, off = where[i]
                if fid >= len(files):
                    r.fail("value in an unknown data file")
                value = self._read(files[fid], off, lengths[i])[0]
            out[(prefix + keys[i]).decode()] = value
        if r.pos != len(r.data):
            r.fail(f"{len(r.data) - r.pos} bytes after the last entry")


def _fill(fill, what):
    if fill is None:
        return 0
    if isinstance(fill, str):
        if fill in ("NaN", "Infinity", "-Infinity"):
            return float(fill.replace("Infinity", "inf"))
        raise ValueError(f"{what}: fill_value {fill!r}")
    return fill


def read_zarr(kv, name, what=""):
    """The zarr v2 array `name` of key-value dict `kv` as numpy."""
    what = what or name
    meta_key = f"{name}/.zarray"
    if meta_key not in kv:
        raise ValueError(f"{what}: no {meta_key} in the store")
    meta = json.loads(kv[meta_key])
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{what}: zarr_format {meta.get('zarr_format')} (only 2 is read)")
    if meta.get("dtype") not in _DTYPES:
        raise ValueError(f"{what}: dtype {meta.get('dtype')!r}")
    if meta.get("filters"):
        raise ValueError(f"{what}: zarr filters {meta['filters']}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{what}: compressor {comp.get('id')!r} (only zstd is read)")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{what}: order {order!r}")
    dtype = np.dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape):
        raise ValueError(f"{what}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), what), dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/" + (sep.join(map(str, idx)) if idx else "0")
        if key not in kv:
            continue
        raw = kv[key]
        if comp is not None:
            try:
                raw = zstd.decompress(raw)
            except zstd.ZstdError as e:
                raise ValueError(f"{what}: chunk {key}: {e}") from None
        want = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
        if len(raw) != want:
            raise ValueError(f"{what}: chunk {key} holds {len(raw)} bytes, want {want}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sel] = chunk[tuple(slice(0, s.stop - s.start) for s in sel)]
    return out


def read_pytree(directory):
    """An orbax PyTree checkpoint directory as nested dicts of numpy: dict
    keys and sequence indices both become str keys (as flax's state dicts
    have them), `scalar` leaves become Python scalars, and an empty
    subtree (orbax's `None` leaf, e.g. optax's EmptyState) becomes {}."""
    meta_path = os.path.join(directory, "_METADATA")
    if not os.path.isfile(meta_path):
        raise ValueError(f"{meta_path}: no orbax PyTree metadata")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{meta_path}: zarr3 checkpoints (use_zarr3) are not read")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{meta_path}: checkpoints without OCDBT are not read")
    kv = OcdbtStore(directory).items()
    tree = {}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        if any(k["key_type"] not in (1, 2) for k in entry["key_metadata"]):
            raise ValueError(f"{meta_path}: unknown key type in {keys}")
        vtype = entry["value_metadata"]["value_type"]
        if vtype in _ARRAY_TYPES:
            value = read_zarr(kv, ".".join(keys), f"{directory}: {'.'.join(keys)}")
            if vtype == "scalar":
                value = value.item()
        elif vtype == "None":
            value = {}
        else:
            raise ValueError(f"{meta_path}: value type {vtype!r} of {keys}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree
