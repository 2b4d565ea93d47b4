"""The port's zstd decoder (utils/zstd.py) against the zstandard package.

A grid of levels (1, 3, 19), sizes (0, 1, 1 KB, 200 KB: several 128 KB
blocks, 3 MB) and data (random float32, zeros, repeated text), each
compressed with and without the content checksum and the content size and
decoded bytewise equal; concatenated and skippable frames; a flipped
checksum byte raises; and the frames of a real orbax save (the zarr chunks
and the OCDBT node bodies the JAX package's save_checkpoint writes) decode
as zstandard decodes them.
"""

import os

import numpy as np
import pytest

from plenoctree_tpu_torch.utils import zstd

zstandard = pytest.importorskip("zstandard")

SIZES = (0, 1, 1000, 200_000, 3_000_000)


def _data(kind, n):
    rng = np.random.default_rng(n)
    if kind == "f32":
        return rng.normal(size=(n + 3) // 4).astype(np.float32).tobytes()[:n]
    if kind == "zeros":
        return bytes(n)
    words = [b"sigma", b"density", b"octree", b"leaf", b"ray", b" ", b"\n", b"spherical"]
    text = b"".join(words[i] for i in rng.integers(0, len(words), 4000))
    return (text * (n // len(text) + 1))[:n]


@pytest.mark.parametrize("level", (1, 3, 19))
@pytest.mark.parametrize("kind", ("f32", "zeros", "text"))
@pytest.mark.parametrize("size", SIZES)
def test_decoder_matches_zstandard(kind, size, level):
    data = _data(kind, size)
    for checksum, content_size in ((True, True), (False, False)):
        frame = zstandard.ZstdCompressor(
            level=level, write_checksum=checksum, write_content_size=content_size
        ).compress(data)
        assert zstd.decompress(frame) == data, (checksum, content_size)


def test_windowed_streamed_frames():
    """Frames written by the streaming compressor (no content size, a
    window descriptor) with every block type, at once and concatenated."""
    parts = [_data("text", 300_000), _data("zeros", 150_000), _data("f32", 70_000)]
    frames = []
    for i, part in enumerate(parts):
        cctx = zstandard.ZstdCompressor(level=3 + 8 * i, write_checksum=bool(i % 2))
        stream = cctx.compressobj()
        frames.append(stream.compress(part) + stream.flush())
        assert frames[-1][4] & 0x20 == 0  # not single-segment: a window descriptor
    assert zstd.decompress(b"".join(frames)) == b"".join(parts)


def test_concatenated_and_skippable_frames():
    a, b = _data("text", 5000), _data("f32", 4000)
    skip = (0x184D2A53).to_bytes(4, "little") + (7).to_bytes(4, "little") + b"ignored"
    frames = (zstandard.ZstdCompressor(level=1).compress(a) + skip
              + zstandard.ZstdCompressor(level=19, write_checksum=True).compress(b))
    assert zstd.decompress(frames) == a + b


def test_checksum_mismatch_raises():
    data = _data("text", 50_000)
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    assert zstd.decompress(bytes(frame)) == data
    frame[-2] ^= 0x40
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))


def test_xxh64_vectors():
    """XXH64's published test values (seed 0 and a seed), at every tail
    length around the 32-byte stripe."""
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    xxhash = pytest.importorskip("xxhash")
    rng = np.random.default_rng(5)
    for n in list(range(0, 80)) + [1000, 4097]:
        buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert zstd.xxh64(buf) == xxhash.xxh64_intdigest(buf), n
        assert zstd.xxh64(buf, seed=12345) == xxhash.xxh64_intdigest(buf, seed=12345), n


def test_dictionary_and_garbage_raise():
    data = _data("text", 2000)
    # single segment, a 1-byte Dictionary_ID, content size 3, one raw block
    frame = (0xFD2FB528).to_bytes(4, "little") + bytes([0x21, 7, 3, 0x19, 0, 0]) + b"abc"
    with pytest.raises(zstd.ZstdError, match="dictionar"):
        zstd.decompress(frame)
    assert zstd.decompress(frame[:5] + b"\x00" + frame[6:]) == b"abc"  # dictionary id 0: none
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(b"not a frame")
    good = zstandard.ZstdCompressor(level=3).compress(data)
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(good[:-5])


def test_frames_of_a_real_orbax_save(tmp_path):
    """Every zstd frame in a checkpoint the JAX package's save_checkpoint
    writes (orbax + tensorstore): the zarr chunks and the compressed OCDBT
    node and manifest bodies decode as zstandard decodes them."""
    pytest.importorskip("orbax.checkpoint")
    from plenoctree_tpu.utils import checkpoints as jckpt

    rng = np.random.default_rng(1)
    params = {"MLP_0": {"Dense_0": {"kernel": rng.normal(size=(63, 64)).astype(np.float32),
                                    "bias": np.zeros(64, np.float32)}}}
    jckpt.save_checkpoint(str(tmp_path), jckpt.create_train_state({"params": params}), 3)
    ckpt_dir = tmp_path / "checkpoint_3"
    frames = []
    for root, _, files in os.walk(ckpt_dir):
        for name in files:
            buf = (ckpt_dir / root / name).read_bytes()
            at = buf.find(b"\x28\xb5\x2f\xfd")
            while at >= 0:
                frames.append(buf[at:])
                at = buf.find(b"\x28\xb5\x2f\xfd", at + 1)
    decoded = 0
    dctx = zstandard.ZstdDecompressor()
    for f in frames:
        try:  # a frame, trimmed of what follows it, as zstandard reads it
            obj = dctx.decompressobj()
            want = obj.decompress(f)
            frame = f[:len(f) - len(obj.unused_data)]
        except zstandard.ZstdError:
            continue  # the magic inside other bytes
        assert zstd.decompress(frame) == want
        decoded += 1
    assert decoded >= 6, decoded  # the node bodies and the zarr chunks
