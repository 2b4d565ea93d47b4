"""Port parity on the CPU: the port's native host library
(plenoctree_tpu_torch/native.py, csrc/plenoctree_native.cc) against the JAX
package's, and against the port's own numpy paths.

`build_from_points` and `query_points` give the same arrays on every path
(the port's native library, its numpy refine loop and descent, the JAX
package's default path). The median cut is compared bit for bit with the
JAX package's default path (its native library where it loads): palette
and ids. At 1M colours the numpy path gives other ids, so there the test
also shows the fault the port's native path repairs.

Every test needs both libraries built (g++): the `libs` fixture skips
otherwise, with the reason, as tests/test_native.py skips without its own.
A JAX library handle lost to a build race at collection is retried first
(`jax_lib_retried`).
"""

import os
import threading

import numpy as np
import pytest

from plenoctree_tpu import native as jnative
from plenoctree_tpu.octree import quantize as jquantize
from plenoctree_tpu.octree.n3tree import N3Tree as JaxN3Tree
from plenoctree_tpu_torch import native
from plenoctree_tpu_torch.kernels._build import build_shared_library
from plenoctree_tpu_torch.octree import quantize
from plenoctree_tpu_torch.octree.n3tree import N3Tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_lib_retried(monkeypatch):
    """The JAX package's native library, loaded again if a first try failed.

    The JAX package builds its library with g++ straight onto its output
    path, and tests/test_native.py asks for it while pytest collects. Under
    xdist every worker collects every file, so several g++ processes write
    that file at once, and a worker that loads it half-written keeps None
    for good. By the time a test runs no g++ is writing, so one reset of the
    handle and a second try load the whole file; None after that means the
    library cannot be built here."""
    if jnative.get_lib() is None:
        monkeypatch.setattr(jnative, "_LIB", None)
        monkeypatch.setattr(jnative, "_TRIED", False)
    return jnative.get_lib()


@pytest.fixture
def libs(monkeypatch):
    monkeypatch.delenv("PLENOCTREE_NO_NATIVE", raising=False)
    if native.get_lib() is None:
        pytest.skip(f"the port's native library is unavailable: {native.build_error}")
    if jax_lib_retried(monkeypatch) is None:
        pytest.skip("the JAX package's native library is unavailable")


@pytest.fixture
def port_numpy_path(monkeypatch):
    """run(fn, *args): fn on the port's numpy paths, as PLENOCTREE_NO_NATIVE=1
    gives them; the library handle is put back afterwards."""

    def run(fn, *args):
        saved = native._LIB, native._TRIED, native.build_error
        with monkeypatch.context() as m:
            m.setenv("PLENOCTREE_NO_NATIVE", "1")
            native._LIB, native._TRIED = None, False
            try:
                assert native.get_lib() is None and native.build_error == "PLENOCTREE_NO_NATIVE is set"
                return fn(*args)
            finally:
                native._LIB, native._TRIED, native.build_error = saved

    return run


def test_source_is_the_jax_packages_byte_for_byte():
    """Below its header comment, csrc/plenoctree_native.cc is the JAX
    package's native/cc/plenoctree_native.cc unchanged."""
    def body(path):
        text = open(os.path.join(REPO, path)).read()
        return text[text.index("#include <algorithm>"):]

    assert body("plenoctree_tpu_torch/csrc/plenoctree_native.cc") == body("native/cc/plenoctree_native.cc")


def _points(seed, n, depth):
    """n uniform points in [-1.1, 1.1]^3 (some outside the [-1, 1] tree),
    and as many again on cell faces of every level down to depth + 1
    (world coordinates that map to k / 2^(depth+1) exactly)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.1, 1.1, (n, 3))
    reso = 2 ** (depth + 1)
    faces = -1.0 + 2.0 * rng.integers(0, reso + 1, (n, 3)) / reso
    return np.concatenate([pts, faces]).astype(np.float32)


def _tree(cls, depth):
    return cls(data_dim=4, depth_limit=depth, radius=1.0, center=(0, 0, 0))


@pytest.mark.parametrize("seed,depth,n", [(0, 1, 40), (1, 3, 500), (2, 5, 4000), (3, 7, 20000)])
def test_build_and_query_equal_numpy_and_jax(seed, depth, n, libs, port_numpy_path):
    """The native build and descent against the port's numpy refine loop and
    descent and against the JAX package's default path: the same child and
    parent_depth arrays, and the same (node, cell, depth) per query point,
    points on cell faces and outside the tree included."""
    pts = _points(seed, n, depth)
    queries = np.concatenate([_points(seed + 100, n, depth), pts])
    before = dict(native.calls)
    nat = _tree(N3Tree, depth).build_from_points(pts)
    nat_q = nat.query_points(queries)
    assert native.calls["build_octree"] == before["build_octree"] + 1
    assert native.calls["query_points"] == before["query_points"] + 1
    jax = _tree(JaxN3Tree, depth).build_from_points(pts)
    jax_q = jax.query_points(queries)
    num = port_numpy_path(lambda: _tree(N3Tree, depth).build_from_points(pts))
    num_q = port_numpy_path(num.query_points, queries)
    assert native.calls["build_octree"] == before["build_octree"] + 1  # the numpy path ran
    n_int = nat.n_internal
    assert n_int == num.n_internal == jax.n_internal and nat.max_depth == depth
    for other in (num, jax):
        np.testing.assert_array_equal(nat.child[:n_int], other.child[:n_int])
        np.testing.assert_array_equal(nat.parent_depth[:n_int], other.parent_depth[:n_int])
        np.testing.assert_array_equal(nat.data[:n_int], other.data[:n_int])
    for other in (num_q, jax_q):
        for a, b in zip(nat_q, other):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_build_from_points_on_a_built_tree_raises(libs):
    tree = _tree(N3Tree, 2).build_from_points(_points(0, 10, 2))
    with pytest.raises(ValueError, match="fresh tree"):
        tree.build_from_points(_points(1, 10, 2))


def _colors(m, seed, ties=False):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(m, 3)).astype(np.float32)
    if ties:  # repeated values, and -0 beside +0 (equal in a comparison)
        c = np.round(c * 4) / 4
        c[::3, 1] = -0.0
    return c


def _weights(kind, m, seed):
    if kind == "none":
        return None
    if kind == "empty":
        return np.zeros(0, np.float32)
    if kind == "zeros":
        return np.zeros(m, np.float32)
    return np.random.default_rng(seed + 7).uniform(size=m).astype(np.float32)


def _assert_bitwise(got, want):
    assert got[0].dtype == want[0].dtype == np.float32
    assert got[1].dtype == want[1].dtype == np.uint32
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("weights", ["none", "empty", "zeros", "uniform"])
@pytest.mark.parametrize("m,bits,ties", [(0, 16, False), (1, 16, False), (3, 16, True),
                                         (257, 4, True), (257, 16, False), (5000, 6, True),
                                         (5000, 16, True), (60000, 16, False)])
def test_median_cut_equals_jax_default_path(m, bits, ties, weights, libs):
    """The port's median_cut_native and its default quantize_median_cut
    against the JAX package's default path: palette and ids bit for bit
    (m below and above 2^bits, ties, every kind of weights)."""
    c = _colors(m, m + bits, ties)
    w = _weights(weights, m, m)
    before = native.calls["median_cut"]
    want = jquantize.quantize_median_cut(c, w, bits)
    _assert_bitwise(native.median_cut_native(c, w, bits), jnative.median_cut_native(c, w, bits))
    _assert_bitwise(quantize.quantize_median_cut(c, w, bits), want)
    # m == 0 returns before the library is called, in both functions.
    assert native.calls["median_cut"] == before + (2 if m else 0)
    if m:
        assert want[0].shape[0] <= min(2**bits, m) and want[1].max() == want[0].shape[0] - 1


def test_median_cut_1m_colours_is_the_jax_default_path(libs, port_numpy_path):
    """ROADMAP's fault: at 1M N(0, 1) colours with uniform weights (16 bits)
    the numpy path gives other ids than the JAX package's default path; the
    port's default path gives its palette and ids bit for bit."""
    c = _colors(1_000_000, 1)
    w = _weights("uniform", c.shape[0], 1)
    want = jquantize.quantize_median_cut(c, w, 16)
    _assert_bitwise(quantize.quantize_median_cut(c, w, 16), want)
    pal, ids = port_numpy_path(quantize.quantize_median_cut, c, w, 16)
    assert not np.array_equal(ids, want[1])
    assert pal.shape == want[0].shape


def test_build_error_is_kept(monkeypatch, tmp_path, libs):
    """A build that fails leaves get_lib() None and the compiler's message
    in build_error; PLENOCTREE_NO_NATIVE=1 names itself."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.delenv("PLENOCTREE_NO_NATIVE", raising=False)
    for attr, value in (("_LIB", None), ("_TRIED", False), ("build_error", None),
                        ("SOURCE", bad), ("BUILD_DIR", tmp_path / "out")):
        monkeypatch.setattr(native, attr, value)
    assert native.get_lib() is None
    assert "failed with code" in native.build_error and "bad.cc" in native.build_error
    assert native.build_octree_native(np.zeros((1, 3), np.int32), 1) is None
    assert native.summary().startswith("numpy paths (RuntimeError: ")
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setenv("PLENOCTREE_NO_NATIVE", "1")
    assert native.get_lib() is None and native.build_error == "PLENOCTREE_NO_NATIVE is set"


def test_concurrent_builds_write_one_whole_library(tmp_path, libs):
    """Threads that build the same library at once each get the same path
    to a whole file that loads (each compiles to its own temporary name,
    then renames)."""
    import ctypes

    out = []

    def build():
        out.append(build_shared_library("g++", native.CXX_FLAGS, "concurrent", [native.SOURCE],
                                        tmp_path)[0])

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(out) == 4 and len(set(out)) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [out[0].name]
    assert ctypes.CDLL(str(out[0])).pn_median_cut is not None


def test_calls_counted_from_threads(libs):
    """The compress CLI runs its median cuts on threads: every native call
    is counted (the counter's update holds a lock), with more threads than
    cores and a short switch interval."""
    import sys

    c = _colors(500, 3)
    before = native.calls["median_cut"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run():
            for _ in range(25):
                native.median_cut_native(c, None, 6)

        threads = [threading.Thread(target=run) for _ in range(2 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert native.calls["median_cut"] == before + 25 * len(threads)
