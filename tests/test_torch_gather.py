"""Port parity on the CPU: the plain `gather_sum` (plenoctree_tpu_torch/
kernels/gather_sum.py) against the three Pallas kernels of
scripts/bench_gather.py and scripts/bench_gather2.py, run in interpret mode.

The scripts are loaded as they are, with `importlib`: pallas_call is
wrapped to add interpret=True, the module's `measure` is replaced by one
that runs one call and keeps its (index array, output), and the sizes are
shrunk (`--table_rows 40000 --vmem_rows 1024 --rays 256` for the first
script; module R = 256 and T = 1 << 16 for the second, whose local_32k
pattern needs T > 32768). Each table is rebuilt from default_rng(0)'s
first draw, as the scripts make it.

Tolerance: each sum is checked against the float64 sum of the same rows,
for the Pallas kernels and for the port alike. A recursive f32 sum of n
terms errs by at most 2^-24 per addition of the running sum, and a running
sum of n zero-mean N(0, 1) terms stays within ~4 sqrt(n): tol = 2^-24 * n *
4 sqrt(n) per output (n = 512 rows per output with one group, 2.8e-3;
64 with eight, 1.2e-4; measured <= 6.0e-5 for the Pallas kernels and
<= 9.6e-6 for the port).
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from plenoctree_tpu_torch.kernels import gather_sum as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_STEPS = 2  # grid steps of the [K, R] probes
D = 56


def _tol(n):
    return 2.0**-24 * n * 4.0 * np.sqrt(n)


def _load(name, monkeypatch):
    """The script as a module, its Pallas calls interpreted, its `measure`
    keeping one call's (idx, out) per case in `module.calls`."""
    from jax.experimental import pallas as pl

    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # The scripts point JAX's compilation cache outside the repo; undo it.
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: real(*a, **dict(k, interpret=True)))
    mod.calls = []

    def measure(make_run, make_idx, rays=None):
        run = make_run()
        idx = make_idx(K_STEPS)
        mod.calls.append((np.asarray(idx), np.asarray(run(idx))))
        return 0.0

    mod.measure = measure
    return mod


def _check(idx, out, table, groups):
    """Pallas output and the port's plain version, both against f64."""
    f64 = table.astype(np.float64)[idx.reshape(-1)].reshape(-1, groups, D).sum(0)
    n = idx.size // groups
    got = G.gather_sum(torch.from_numpy(np.array(idx)), torch.from_numpy(table), groups).numpy()
    assert got.shape == out.reshape(groups, D).shape == (groups, D)
    assert np.abs(out.reshape(groups, D) - f64).max() <= _tol(n)
    assert np.abs(got - f64).max() <= _tol(n)


def test_plain_matches_bench_gather_pallas_kernels(monkeypatch):
    mod = _load("bench_gather", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["bench_gather.py", "--table_rows", "40000", "--vmem_rows", "1024",
                                      "--rays", "256"])
    mod.main()
    assert len(mod.calls) == 7  # four XLA cases, then pallas_vmem u1, u8, pallas_vmem_tile
    table = np.random.default_rng(0).normal(size=(40000, D)).astype(np.float32)
    vtable = table[:1024]
    for (idx, out), groups in zip(mod.calls[4:], (1, 1, 8)):
        assert idx.shape == (K_STEPS, 256) and idx.max() < 1024
        _check(idx, out, vtable, groups)
    # The XLA gather case is the same function with one group.
    idx, out = mod.calls[0]
    _check(idx, out.reshape(1, D), table, 1)


def test_plain_matches_bench_gather2_pallas_kernel(monkeypatch):
    mod = _load("bench_gather2", monkeypatch)
    monkeypatch.setattr(mod, "R", 256)
    monkeypatch.setattr(mod, "T", 1 << 16)
    mod.main()
    assert len(mod.calls) == 7  # uniform .. u32_64mb, then the Pallas [R, K] probe
    table = np.random.default_rng(0).normal(size=(1 << 16, D)).astype(np.float32)
    idx, out = mod.calls[-1]
    assert idx.shape == (256, K_STEPS) and idx.max() < 1 << 15
    _check(idx, out, table[: 1 << 15], 1)


def test_wrapper_checks_on_cpu():
    table = torch.zeros(10, 8)
    with pytest.raises(ValueError, match="multiple of groups"):
        G.gather_sum(torch.zeros(12, dtype=torch.int32), table, groups=8)
    with pytest.raises(ValueError, match="groups"):
        G.gather_sum(torch.zeros(8, dtype=torch.int32), table, groups=2)
    out = G.gather_sum(torch.tensor([1, 2, 3, 1], dtype=torch.int32), torch.arange(40.0).reshape(10, 4))
    np.testing.assert_array_equal(out.numpy(), [[28.0, 32.0, 36.0, 40.0]])
