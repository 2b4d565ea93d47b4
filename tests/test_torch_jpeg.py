"""The port's JPEG reader (plenoctree_tpu_torch/utils/jpeg.py) against PIL,
bitwise: `read_jpeg(f)` equals `np.array(Image.open(f))` (Pillow with
libjpeg-turbo: the islow IDCT, fancy upsampling, the fixed-point colour
tables) on files from PIL's writer and from the numpy encoder in
tests/torch_fixtures/jpeg_writer.py (4:4:0, 4:1:1 and other sampling PIL
cannot write). The C++ scan decoder (csrc/jpeg_scan.cc) and the pure-Python
one give equal coefficient arrays on every case; what the reader refuses
raises a ValueError naming the file."""

import glob
import io
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from plenoctree_tpu_torch.utils import jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
sys.path.insert(0, FIXTURES)

import jpeg_writer  # noqa: E402

SIZES = [(1, 1), (5, 7), (23, 37), (67, 129)]


def _texture(h, w, c, seed, noise=20.0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / (5.0 + k) + k) * np.cos(y / (4.0 + k) - k)
                    for k in range(c)], -1)
    img = np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _pil_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def native():
    """The C++ scan decoder, built with g++ into build/native/."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the C++ scan decoder cannot be built")
    lib = jpeg.get_lib()
    assert lib is not None, jpeg.build_error
    return lib


def _check(data, native_lib):
    """PIL's decode, bitwise, through both scan decoders, whose coefficient
    arrays must be equal."""
    want = np.array(Image.open(io.BytesIO(data)))
    got = jpeg.decode_jpeg(data, "case.jpg", native=True)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    a = jpeg.decode_coefficients(data, native=True)[2]
    b = jpeg.decode_coefficients(data, native=False)[2]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.coef, y.coef)
    np.testing.assert_array_equal(jpeg.reconstruct(*jpeg.decode_coefficients(data,
                                                                           native=False)), want)
    return want


@pytest.mark.parametrize("mode", ["baseline", "optimize", "progressive", "restart"])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_pil_writer_files_bitwise(native, size, subsampling, mode):
    """PIL's own files at quality 1, 50 and 100: baseline, optimised
    Huffman tables, progressive (spectral selection, successive
    approximation, EOB runs), restart intervals."""
    kw = {"baseline": {}, "optimize": {"optimize": True}, "progressive": {"progressive": True},
          "restart": {"restart_marker_blocks": 1}}[mode]
    for quality in (1, 50, 100):
        img = _texture(*size, 3, seed=quality + subsampling)
        _check(_pil_bytes(img, quality=quality, subsampling=subsampling, **kw), native)


SAMPLINGS = {
    "440": [(1, 2), (1, 1), (1, 1)],
    "411": [(4, 1), (1, 1), (1, 1)],
    "1x4": [(1, 4), (1, 1), (1, 1)],
    "420_dri": [(2, 2), (1, 1), (1, 1)],
    "mixed": [(2, 2), (1, 2), (2, 1)],
    "3x1": [(3, 1), (1, 1), (1, 1)],
    "2x1_all": [(2, 1), (2, 1), (2, 1)],
}


@pytest.mark.parametrize("name", list(SAMPLINGS))
@pytest.mark.parametrize("size", SIZES + [(2, 2), (3, 9)],
                         ids=[f"{h}x{w}" for h, w in SIZES + [(2, 2), (3, 9)]])
def test_writer_sampling_bitwise(native, name, size):
    """Sampling factors PIL's writer cannot produce (4:4:0, 4:1:1, 1x4,
    per-component ratios, a ratio of 3: pixel replication), partial MCUs at
    the edges, components at most 2 samples wide (jdsample.c replicates
    there), restart intervals of 1-3 MCUs."""
    img = _texture(*size, 3, seed=len(name))
    for quality, restart in ((90, 0), (40, 1), (100, 3)):
        data = jpeg_writer.encode_jpeg(img, quality=quality, sampling=SAMPLINGS[name],
                                       restart_interval=restart)
        _check(data, native)


@pytest.mark.parametrize("mode", ["baseline", "progressive", "writer_dri"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_greyscale_is_hw(native, size, mode):
    """One component gives [H, W], as PIL's 'L' mode does."""
    img = _texture(*size, 1, seed=3)
    if mode == "writer_dri":
        data = jpeg_writer.encode_jpeg(img, quality=85, restart_interval=2)
    else:
        data = _pil_bytes(img, quality=75, progressive=mode == "progressive")
    assert _check(data, native).shape == size


def test_exif_orientation_is_not_applied(native, tmp_path):
    """PIL's Image.open leaves EXIF orientation unapplied, so the JAX
    loaders see the stored orientation; so does the port."""
    img = _texture(20, 30, 3, seed=4)
    exif = Image.Exif()
    exif[0x0112] = 6
    path = tmp_path / "rotated.jpg"
    Image.fromarray(img).save(path, quality=90, exif=exif)
    assert Image.open(path).getexif()[0x0112] == 6
    got = jpeg.read_jpeg(path)
    assert got.shape == (20, 30, 3)
    np.testing.assert_array_equal(got, np.array(Image.open(path)))


def test_colour_transform_from_the_file(native):
    """jdapimin.c's choice: JFIF means YCbCr; without it, Adobe APP14's
    transform flag (0: none, 1: YCbCr), else component ids 'R','G','B'
    mean no transform, anything else YCbCr."""
    img = _texture(16, 24, 3, seed=5)
    cases = [
        dict(jfif=True),
        dict(jfif=False, adobe_transform=0),
        dict(jfif=False, adobe_transform=1),
        dict(jfif=False, component_ids=[82, 71, 66]),
        dict(jfif=False, component_ids=[7, 8, 9]),
    ]
    transforms = []
    for kw in cases:
        data = jpeg_writer.encode_jpeg(img, quality=90, sampling=[(1, 1)] * 3, **kw)
        _check(data, native)
        transforms.append(jpeg.decode_coefficients(data)[3])
    assert transforms == ["ycc", "rgb", "ycc", "rgb", "ycc"]


@pytest.mark.parametrize("seed", range(8))
def test_random_sweep(native, seed):
    """Seeded random sizes, qualities, processes and sampling, on both
    writers."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(1, 100, 2))
        img = _texture(h, w, 3, seed=int(rng.integers(1 << 30)),
                       noise=float(rng.choice([0.0, 8.0, 60.0])))
        if rng.random() < 0.6:
            kw = dict(quality=int(rng.integers(1, 101)), subsampling=int(rng.integers(0, 3)),
                      optimize=bool(rng.random() < 0.5), progressive=bool(rng.random() < 0.5))
            if rng.random() < 0.3:
                kw["restart_marker_blocks"] = int(rng.integers(1, 5))
            data = _pil_bytes(img[..., 0] if rng.random() < 0.2 else img, **kw)
        else:
            name = list(SAMPLINGS)[int(rng.integers(len(SAMPLINGS)))]
            data = jpeg_writer.encode_jpeg(img, quality=int(rng.integers(1, 101)),
                                           sampling=SAMPLINGS[name],
                                           restart_interval=int(rng.integers(0, 4)))
        _check(data, native)


def test_scans_counted_per_path(native, monkeypatch):
    """Each scan is counted on the path that decoded it; a progressive
    file has several. PLENOCTREE_NO_NATIVE=1 leaves the Python decoder,
    and the summary says why."""
    data = _pil_bytes(_texture(40, 56, 3, seed=6), quality=80, progressive=True)
    before = dict(jpeg.calls)
    jpeg.decode_jpeg(data, native=True)
    scans = jpeg.calls["native"] - before["native"]
    assert scans > 3 and jpeg.calls["python"] == before["python"]
    assert jpeg.summary().startswith("g++ scan decoder")
    monkeypatch.setenv("PLENOCTREE_NO_NATIVE", "1")
    monkeypatch.setattr(jpeg, "_LIB", None)
    monkeypatch.setattr(jpeg, "_TRIED", False)
    monkeypatch.setattr(jpeg, "build_error", None)
    assert jpeg.get_lib() is None and jpeg.build_error == "PLENOCTREE_NO_NATIVE is set"
    jpeg.decode_jpeg(data)
    assert jpeg.calls["python"] - before["python"] == scans
    assert jpeg.summary().startswith("Python scan decoder (PLENOCTREE_NO_NATIVE is set)")


def test_threads_wait_for_one_build(native, monkeypatch):
    """Threads that decode a split's frames at once all wait for the one
    build or load of the library and all take the C++ path (a thread that
    came while another was building once took the Python decoder)."""
    from concurrent.futures import ThreadPoolExecutor

    import time

    data = _pil_bytes(_texture(32, 48, 3, seed=9), quality=85)
    build = jpeg.build_shared_library

    def slow_build(*args):  # a build that takes a while, as a first g++ run does
        time.sleep(0.3)
        return build(*args)

    monkeypatch.setattr(jpeg, "build_shared_library", slow_build)
    monkeypatch.setattr(jpeg, "_LIB", None)
    monkeypatch.setattr(jpeg, "_TRIED", False)
    before = dict(jpeg.calls)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda _: jpeg.decode_jpeg(data), range(16)))
    assert jpeg.calls["native"] - before["native"] == 16
    assert jpeg.calls["python"] == before["python"]


def _scalar_idct_islow(coef, q):
    """jidctint.c's jpeg_idct_islow transcribed one block at a time, with
    Python ints (JLONG never overflows) and the RANGE_MASK wrap."""
    c = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373, c1175=9633,
             c1501=12299, c1847=15137, c1961=16069, c2053=16819, c2562=20995, c3072=25172)

    def one_d(x, shift):
        z1 = (x[2] + x[6]) * c["c0541"]
        tmp2, tmp3 = z1 - x[6] * c["c1847"], z1 + x[2] * c["c0765"]
        tmp0, tmp1 = (x[0] + x[4]) * 8192, (x[0] - x[4]) * 8192
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * c["c1175"]
        t0, t1, t2, t3 = t0 * c["c0298"], t1 * c["c2053"], t2 * c["c3072"], t3 * c["c1501"]
        z1, z2 = -z1 * c["c0899"], -z2 * c["c2562"]
        z3, z4 = -z3 * c["c1961"] + z5, -z4 * c["c0390"] + z5
        t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
        r = 1 << (shift - 1)
        return [(v + r) >> shift for v in (t10 + t3, t11 + t2, t12 + t1, t13 + t0,
                                          t13 - t0, t12 - t1, t11 - t2, t10 - t3)]

    d = [[int(coef[u * 8 + v]) * int(q[u * 8 + v]) for v in range(8)] for u in range(8)]
    ws = [[0] * 8 for _ in range(8)]
    for col in range(8):
        out = one_d([d[u][col] for u in range(8)], 11)
        for u in range(8):
            ws[u][col] = out[u]
    res = np.zeros((8, 8), np.uint8)
    for row in range(8):
        out = one_d(ws[row], 18)
        for v in range(8):
            x = out[v] & 1023
            res[row, v] = min(x + 128, 255) if x < 512 else max(x - 1024 + 128, 0)
    return res


@pytest.mark.parametrize("scale", [1, 40, 2000], ids=["photo", "overshoot", "wrap"])
def test_idct_matches_scalar_jidctint(scale):
    """The vectorised IDCT (int32 where every intermediate fits, int64
    beyond) against jidctint.c transcribed block by block, including
    coefficients far outside any real photograph's, where the C code's
    int workspace and RANGE_MASK wrap hold (and libjpeg-turbo's 16-bit
    SIMD IDCT, and so PIL, does not: see ROADMAP.md §C)."""
    rng = np.random.default_rng(scale)
    coef = (rng.standard_normal((24, 64)) * scale * np.exp(-np.arange(64) / 12)).astype(np.int16)
    q = rng.integers(1, 256, 64)
    got = jpeg.idct_islow(coef, q)
    for b in range(coef.shape[0]):
        np.testing.assert_array_equal(got[b], _scalar_idct_islow(coef[b], q))


def _relabel(data, marker):
    return data.replace(b"\xff\xc0", bytes([0xFF, marker]), 1)


def _raising_cases():
    img = _texture(24, 40, 3, seed=7)
    base = jpeg_writer.encode_jpeg(img, quality=90, restart_interval=2)
    sos = base.index(b"\xff\xda")
    scan_start = sos + 2 + int.from_bytes(base[sos + 2:sos + 4], "big")
    bad_code = bytearray(base)
    bad_code[scan_start:scan_start + 4] = b"\xff\x00\xff\x00"  # 32 one-bits: no such code
    bad_rst = bytearray(base)
    rst = bytes(bad_rst).index(b"\xff\xd0", scan_start)
    bad_rst[rst + 1] = 0xD3
    cmyk = io.BytesIO()
    Image.new("CMYK", (16, 8), (10, 20, 30, 40)).save(cmyk, format="JPEG")
    return {
        "arithmetic_sof9": (_relabel(base, 0xC9), "arithmetic coding"),
        "arithmetic_sof10": (_relabel(base, 0xCA), "arithmetic coding"),
        "12_bit": (jpeg_writer.encode_jpeg(img, quality=90, precision=12, sof=0xC1),
                   "12-bit samples"),
        "lossless": (jpeg_writer.encode_lossless_jpeg(img[..., 0]), "lossless"),
        "hierarchical": (_relabel(base, 0xC5), "hierarchical"),
        "cmyk": (cmyk.getvalue(), "4-component"),
        "truncated_scan": (base[:scan_start + 200], "truncated"),
        "no_eoi": (base[:-2], "truncated"),
        "bad_huffman_code": (bytes(bad_code), "Huffman code"),
        "bad_restart": (bytes(bad_rst), "restart marker"),
        "png": (b"\x89PNG\r\n\x1a\n" + b"\x00" * 16, "not a JPEG"),
    }


@pytest.mark.parametrize("case", list(_raising_cases()))
def test_refused_files_raise_naming_the_file(native, case, tmp_path):
    """Arithmetic coding, 12-bit samples, the lossless and hierarchical
    processes, CMYK, truncated and corrupt streams: a ValueError naming the
    file and the reason, on both scan decoders."""
    data, reason = _raising_cases()[case]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    for use_native in (True, False):
        with pytest.raises(ValueError, match=rf"{case}\.jpg: .*{reason}"):
            jpeg.read_jpeg(path, native=use_native)


def test_lossless_is_what_pil_decodes():
    """The lossless fixture is a real SOF3 file: PIL decodes it exactly
    (ROADMAP.md lists the process as not queued)."""
    img = _texture(9, 13, 1, seed=8)
    got = np.array(Image.open(io.BytesIO(jpeg_writer.encode_lossless_jpeg(img))))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("name", sorted(os.path.basename(p)[:-4] for p in
                                        glob.glob(os.path.join(FIXTURES, "jpeg", "*.jpg"))))
def test_committed_fixtures(native, name):
    """tests/torch_fixtures/jpeg (make_jpeg_fixtures.py): PIL still decodes
    each file to the committed .npy, and the port does too, on both scan
    decoders (chip_smoke.py phase 38 checks the same on the GPU host)."""
    path = os.path.join(FIXTURES, "jpeg", name + ".jpg")
    want = np.load(os.path.join(FIXTURES, "jpeg", name + ".npy"))
    np.testing.assert_array_equal(np.array(Image.open(path)), want)
    for use_native in (True, False):
        got = jpeg.read_jpeg(path, native=use_native)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_reads_jpeg_with_pil_cv2_and_jax_blocked(native, tmp_path):
    """On a host without PIL, imageio, cv2 or the JAX stack (the GPU
    host), the fixtures decode bitwise and an LLFF scene of JPEG frames
    loads through the C++ path."""
    import subprocess

    from plenoctree_tpu_torch.data.synthetic import write_llff_dataset

    scene = write_llff_dataset(str(tmp_path / "llff"), n_views=4, resolution=24)
    images = os.path.join(scene, "images")
    for name in sorted(os.listdir(images)):
        png = os.path.join(images, name)
        Image.open(png).save(png[:-4] + ".jpg", quality=90)
        os.remove(png)
    script = f"""
import glob, sys
for name in ("plenoctree_tpu", "jax", "flax", "PIL", "imageio", "cv2"):
    sys.modules[name] = None
import numpy as np
from plenoctree_tpu_torch.data import get_dataset
from plenoctree_tpu_torch.utils import config, jpeg
for p in glob.glob({os.path.join(FIXTURES, "jpeg", "*.jpg")!r}):
    assert np.array_equal(jpeg.read_jpeg(p), np.load(p[:-4] + ".npy")), p
ds = get_dataset("train", config.default_config(dataset="llff", data_dir={scene!r},
                                                batch_size=8, factor=0, llffhold=3))
assert (ds.h, ds.w, ds.size) == (24, 24, 2), (ds.h, ds.w, ds.size)
print(jpeg.summary())
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=os.path.dirname(FIXTURES), timeout=300,
                         env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
                             FIXTURES))))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "jpeg: 2 frames" in out.stdout and "g++ scan decoder" in out.stdout
