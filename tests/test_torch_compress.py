"""Port parity on the CPU: the median cut and tree compression
(plenoctree_tpu_torch/octree/quantize.py, cli/compress.py) against the JAX
package.

Both packages' quantize_median_cut use their native library where it
loads, and the native median cut gives another palette than the numpy path
(tests/test_native.py checks only their mean error). So the comparisons
that take the `jax_numpy_path` fixture run both packages on their numpy
paths: PLENOCTREE_NO_NATIVE=1 with both library handles reset, by
monkeypatch. The compress CLI cases at the end run both CLIs on their
default paths (tests/test_torch_native.py holds the native median cuts to
each other). Everything is compared bit for bit.
"""

import numpy as np
import pytest

from plenoctree_tpu import native
from plenoctree_tpu.cli import compress as jcompress_cli
from plenoctree_tpu.octree import quantize as jquantize
from plenoctree_tpu.octree.n3tree import N3Tree as JaxN3Tree
from plenoctree_tpu_torch import native as port_native
from plenoctree_tpu_torch.cli import compress as compress_cli
from plenoctree_tpu_torch.octree import quantize


@pytest.fixture
def jax_numpy_path(monkeypatch):
    """Both packages on their numpy paths (the name is the fixture's first
    use: the JAX side's numpy path)."""
    monkeypatch.setenv("PLENOCTREE_NO_NATIVE", "1")
    for lib in (native, port_native):
        monkeypatch.setattr(lib, "_LIB", None)
        monkeypatch.setattr(lib, "_TRIED", False)
        assert lib.median_cut_native(np.zeros((4, 3), np.float32)) is None


def _colors(m, seed, ties=False):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(m, 3)).astype(np.float32)
    if ties:  # repeated values, and -0 beside +0 (equal in a sort)
        c = np.round(c * 4) / 4
        c[::3, 1] = -0.0
        c[1::5, 2] = np.inf
    return c


def _assert_bitwise(got, want):
    assert got[0].dtype == want[0].dtype == np.float32
    assert got[1].dtype == want[1].dtype == np.uint32
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("bits", [4, 6, 16])
@pytest.mark.parametrize("weighted", [False, True])
def test_median_cut_equals_jax_numpy_path(bits, weighted, jax_numpy_path):
    """Palette and ids bit for bit, m = 0 and sizes that split unevenly,
    with ties and -0 among the values (a stable sort's order)."""
    rng = np.random.default_rng(bits)
    for m, ties in ((0, False), (1, False), (3, True), (257, True), (5000, False), (5000, True)):
        c = _colors(m, m + bits, ties)
        w = rng.random(m).astype(np.float32) if weighted else None
        want = jquantize.quantize_median_cut(c, w, bits)
        got = quantize.quantize_median_cut(c, w, bits)
        _assert_bitwise(got, want)
        assert got[0].shape[0] <= 2**bits
        if m:
            assert got[1].max() == got[0].shape[0] - 1  # dense ids


def test_median_cut_empty_weights_and_palette_size(jax_numpy_path):
    c = _colors(4096, 9)
    _assert_bitwise(quantize.quantize_median_cut(c, np.zeros(0, np.float32), 16),
                    jquantize.quantize_median_cut(c, None, 16))
    errs = []
    for bits in (2, 6, 12):
        pal, ids = quantize.quantize_median_cut(c, None, bits)
        assert pal.shape == (2**bits, 3)
        errs.append(float(np.abs(pal[ids] - c).mean()))
    # Each palette colour is its box's mean: more boxes, less error.
    assert errs[0] > errs[1] > errs[2] and errs[2] < 0.05


def _tree_npz(path, seed, basis_dim=4, depth=3, data_format=None, n_points=300):
    """A small tree (SH unless `data_format` says otherwise) with seeded
    data, saved by the JAX package's N3Tree (sigma in [0, 8), so sigma_thresh
    2 keeps about three quarters)."""
    rng = np.random.default_rng(seed)
    tree = JaxN3Tree(data_dim=1 + 3 * basis_dim, depth_limit=depth, radius=1.0,
                     center=(0, 0, 0), data_format=data_format or f"SH{basis_dim}",
                     extra_data=np.ones((basis_dim, 4), np.float32)
                     if (data_format or "").startswith("SG") else None)
    tree.build_from_points(rng.uniform(-1, 1, (n_points, 3)).astype(np.float32))
    tree.data[...] = rng.normal(size=tree.data.shape).astype(np.float32)
    tree.data[..., -1] = rng.uniform(0, 8, tree.data.shape[:-1])
    tree.save(str(path), compress=False)
    return str(path)


@pytest.mark.parametrize("kw", [dict(), dict(retain=1), dict(noquant=True),
                                dict(weighted=True, bits=6, sigma_thresh=4.0)],
                         ids=["retain0", "retain1", "noquant", "weighted6"])
def test_compress_tree_npz_equals_jax(kw, tmp_path, jax_numpy_path):
    src = _tree_npz(tmp_path / "tree.npz", 1)
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    assert jquantize.compress_tree_npz(src, a, **kw) is True
    assert quantize.compress_tree_npz(src, b, **kw) is True
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    if kw.get("noquant"):
        assert "data" in zb.files and "quant_colors" not in zb.files
    else:
        assert {"quant_colors", "quant_map", "sigma"} <= set(zb.files) and "data" not in zb.files
        assert ("data_retained" in zb.files) == bool(kw.get("retain"))
        assert zb["quant_map"].dtype == np.uint16 and zb["quant_colors"].dtype == np.float16
        assert zb["quant_colors"].shape[0] == 4 - kw.get("retain", 0)
    assert "parent_depth" not in zb.files


def test_compressed_tree_is_skipped(tmp_path, jax_numpy_path):
    """An input that already holds quant_colors is left alone (False) by
    both packages, unless --noquant only deflates it."""
    src = _tree_npz(tmp_path / "tree.npz", 2)
    once = str(tmp_path / "once.npz")
    assert quantize.compress_tree_npz(src, once)
    for pkg in (jquantize, quantize):
        assert pkg.compress_tree_npz(once, str(tmp_path / "twice.npz")) is False
    assert not (tmp_path / "twice.npz").exists()
    assert quantize.compress_tree_npz(once, str(tmp_path / "deflated.npz"), noquant=True)


def test_compress_cli(tmp_path, capsys, jax_numpy_path):
    """The CLI writes <out_dir>/<name> for each input with the flags passed
    through, skips an existing output without --overwrite, and prints the
    sizes."""
    src = _tree_npz(tmp_path / "tree.npz", 3)
    out_dir = str(tmp_path / "min")
    compress_cli.main([src, "--out_dir", out_dir, "--bits", "4", "--retain", "1"])
    out = tmp_path / "min" / "tree.npz"
    z = np.load(out)
    assert z["quant_colors"].shape == (3, 16, 3) and "data_retained" in z.files
    jquantize.compress_tree_npz(src, str(tmp_path / "jax.npz"), bits=4, retain=1)
    np.testing.assert_array_equal(z["quant_map"], np.load(tmp_path / "jax.npz")["quant_map"])
    mtime = out.stat().st_mtime_ns
    compress_cli.main([src, "--out_dir", out_dir])
    assert out.stat().st_mtime_ns == mtime
    compress_cli.main([src, "--out_dir", out_dir, "--overwrite", "--noquant"])
    assert "data" in np.load(out).files
    text = capsys.readouterr().out
    assert " > skip" in text and "MB ->" in text and "Quantization enabled" in text
    assert "native: numpy paths (PLENOCTREE_NO_NATIVE is set)" in text


@pytest.fixture
def native_default_paths(monkeypatch):
    """Both packages' default paths with their native libraries loaded.

    The JAX package builds its library with g++ straight onto its output
    path while tests/test_native.py is collected, so under xdist a worker
    can load a half-written file and keep None for good. No g++ is writing
    once tests run: one reset of the JAX handle and a second try load the
    whole file. Skips only if a library still does not load."""
    monkeypatch.delenv("PLENOCTREE_NO_NATIVE", raising=False)
    if native.get_lib() is None:
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", False)
    if native.get_lib() is None:
        pytest.skip("the JAX package's native library is unavailable")
    if port_native.get_lib() is None:
        pytest.skip(f"the port's native library is unavailable: {port_native.build_error}")


@pytest.mark.parametrize("data_format,basis_dim", [("RGBA", 1), ("SH9", 9), ("SG4", 4)])
def test_compress_cli_equals_jax_cli_on_default_paths(data_format, basis_dim, tmp_path, capsys,
                                                      native_default_paths):
    """One tree per format through both compress CLIs as a user runs them
    (each package's default path: its native median cut), with --weighted,
    whose palettes the numpy path rounds otherwise: each CLI took its native
    path, and the two files hold the same arrays, bit for bit."""
    src = _tree_npz(tmp_path / "tree.npz", 4, basis_dim=basis_dim, depth=5,
                    data_format=data_format, n_points=3000)
    flags = ["--bits", "12", "--weighted"]
    jcompress_cli.main([src, "--out_dir", str(tmp_path / "jax"), *flags])
    assert native._LIB is not None, "the JAX compress CLI took its numpy path"
    cuts = port_native.calls["median_cut"]
    compress_cli.main([src, "--out_dir", str(tmp_path / "port"), *flags])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("native:")]
    assert line and line[-1].startswith("native: g++ library"), f"the port's compress CLI took another path: {line}"
    assert port_native.calls["median_cut"] - cuts == basis_dim
    za, zb = np.load(tmp_path / "jax" / "tree.npz"), np.load(tmp_path / "port" / "tree.npz")
    assert sorted(za.files) == sorted(zb.files) and "quant_colors" in zb.files
    assert zb["quant_colors"].shape[0] == basis_dim
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
