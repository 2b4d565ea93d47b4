"""Gather probes: ns per gathered row by table size and access pattern.

Port of scripts/bench_gather.py and scripts/bench_gather2.py as one entry
point, on one GPU:

    python -m plenoctree_tpu_torch.bench_gather [--table_rows N] \\
        [--vmem_rows N] [--dim D] [--rays R] [--device cuda]

The probes size the exact march's tables (octree/march.py): a sigma-only
table, the accel grid (64 MB of int32 at reso 256) and the full leaf rows.
The scripts' XLA cases become the plain torch ops that compute the same
thing (`table[idx].sum(0)` over the whole [K, R] stream, the 4-row slices,
the int32-stored u32 grid summed in int64 and reduced mod 2^32, the
uniform / mostly_zero / sorted / local_32k patterns, and the scatter-add as
one `index_add_`); their three Pallas kernels become `gather_sum` launches
(kernels/gather_sum.py) with the wrapper's own placement (the 32k-row table
sliced across the SMs' shared memory, as the TPU kernels hold it in VMEM).
The kernel also runs by placement: the 32k-row table sliced and through L2,
a 1024-row table copied into every block's shared memory and through L2,
and the 1M-row table in HBM.

Timing: CUDA events around a batch of CALLS calls, best of 3 batches, at
K_LO and at K_HI steps of R rays; the difference (t_hi - t_lo) / ((K_HI -
K_LO) * R) cancels each call's fixed cost. Each batch is queued behind a
device spin, so the events time the device's work and not the host's
launches (a plain case is several small ops whose launches would otherwise
take longer than their work). Output: one `name : x ns/row` line per case,
then one JSON line. On `--device cpu` the host clock stands in (a check of
the control flow; its numbers are the CPU's).
"""

import argparse
import json
import time

import numpy as np
import torch

from plenoctree_tpu_torch.kernels import gather_sum as G

K_LO, K_HI = 32, 256
GRID_ROWS = 1 << 24  # u32_64mb: a 64 MB grid, the accel grid at reso 256
CALLS = 10  # calls per timed batch
# Device clock cycles the stream spins before a batch (~2.5 ms on an H100):
# longer than the host takes to queue CALLS calls of any case.
SPIN_CYCLES = 5_000_000


def _timer(dev):
    """fn -> ms per call of a batch of CALLS calls, on the device's clock."""
    if dev.type == "cuda":
        def ms(fn, arg):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            e0.record()
            for _ in range(CALLS):
                fn(arg)
            e1.record()
            torch.cuda.synchronize(dev)
            return e0.elapsed_time(e1) / CALLS
    else:
        def ms(fn, arg):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn(arg)
            return (time.perf_counter() - t0) * 1e3 / CALLS
    return ms


def kernel_split(fn, calls=20):
    """Device microseconds per call of each CUDA kernel that fn launches,
    by kernel name, from one torch.profiler window over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        if t > 0:
            name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0]
            split[name] = split.get(name, 0.0) + t / calls
    return split


def measure(run, make_idx, rays, dev, reps=3):
    """ns/row = (t_hi - t_lo) / ((K_HI - K_LO) * rays), best of `reps`."""
    timed = _timer(dev)
    args = {K: make_idx(K) for K in (K_LO, K_HI)}
    for K in (K_LO, K_HI):
        run(args[K])  # warm-up
    ts = {K: min(timed(run, args[K]) for _ in range(reps)) for K in (K_LO, K_HI)}
    return (ts[K_HI] - ts[K_LO]) / ((K_HI - K_LO) * rays) * 1e6


def run(table_rows=1 << 20, vmem_rows=1 << 15, dim=56, rays=8192, device="cuda"):
    """Every case of both scripts; returns {"ns_per_row": {case: ns},
    "launches": {case: gather_sum launches}, ...}."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_gather on 'cuda' but torch.cuda.is_available() is False")
    R, D, T = rays, dim, table_rows
    rng = np.random.default_rng(0)
    grid_rows = GRID_ROWS

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    table = t(rng.normal(size=(T, D)).astype(np.float32))
    vtable = table[:vmem_rows].contiguous()
    stable = table[: min(1024, vmem_rows)].contiguous()  # fits in shared memory
    grid = t(rng.integers(0, 2**31, size=(T,)).astype(np.int32))  # u32 values < 2^31
    grid64 = t(rng.integers(0, 2**31, size=(grid_rows,)).astype(np.int32))

    def idx_in(rows, shape):
        return t(rng.integers(0, rows, size=shape).astype(np.int32))

    def gather_rows(tab):
        return lambda idx: tab.index_select(0, idx.reshape(-1)).sum(0)

    def gather_4(idx):
        ix = idx.reshape(-1, 1) + torch.arange(4, dtype=torch.int32, device=dev)
        return table.index_select(0, ix.reshape(-1)).reshape(-1, 4, D).sum(1).sum(0)

    def gather_u32(g):
        return lambda idx: g.index_select(0, idx.reshape(-1)).long().sum() % (1 << 32)

    def kernel(tab, groups=1, unroll=1, placement="auto"):
        return lambda idx: G.gather_sum(idx, tab, groups, unroll, placement)

    def idx_mostly_zero(K):
        idx = rng.integers(0, T, size=(K, R)).astype(np.int32)
        idx[rng.random((K, R)) < 0.9] = 0
        return t(idx)

    def idx_local(K):
        base = rng.integers(0, T - (1 << 15), size=(K, 1))
        return t((base + rng.integers(0, 1 << 15, size=(K, R))).astype(np.int32))

    vals = t(rng.normal(size=(R, D)).astype(np.float32))

    def scatter_args(K):
        return idx_in(T, (K, R)), vals.repeat(K, 1)

    def scatter(args):
        idx, v = args
        acc = torch.zeros((T, D), dtype=torch.float32, device=dev)
        return acc.index_add_(0, idx.reshape(-1), v).sum()

    hbm = lambda K: idx_in(T - 4, (K, R))  # noqa: E731
    vmem = lambda K: idx_in(vmem_rows, (K, R))  # noqa: E731
    smem = lambda K: idx_in(stable.shape[0], (K, R))  # noqa: E731
    cases = [
        # scripts/bench_gather.py
        ("xla_gather_1", gather_rows(table), hbm, ""),
        ("xla_gather_4", gather_4, hbm, " (x4 rows each)"),
        ("xla_gather_u32", gather_u32(grid), hbm, ""),
        ("xla_gather_vmtab", gather_rows(vtable), vmem, f" ({vmem_rows}-row table)"),
        ("pallas_vmem_u1", kernel(vtable), vmem, f" (gather_sum, {vmem_rows}-row table)"),
        ("pallas_vmem_u8", kernel(vtable, unroll=8), vmem, f" (gather_sum, {vmem_rows}-row table)"),
        ("pallas_vmem_tile", kernel(vtable, groups=8), vmem, f" (gather_sum, {vmem_rows}-row table)"),
        # scripts/bench_gather2.py
        ("uniform", gather_rows(table), lambda K: idx_in(T, (K, R)), ""),
        ("mostly_zero", gather_rows(table), idx_mostly_zero, ""),
        ("sorted", gather_rows(table), lambda K: idx_in(T, (K, R)).sort(dim=1).values, ""),
        ("local_32k", gather_rows(table), idx_local, ""),
        ("scatter_add", scatter, scatter_args, " (index_add_)"),
        ("u32_64mb", gather_u32(grid64), lambda K: idx_in(grid_rows, (K, R)),
         f" ({grid_rows}-entry grid)"),
        ("pallas_vmem", kernel(vtable), lambda K: idx_in(vmem_rows, (R, K)),
         f" (gather_sum, [R, K] stream, {vmem_rows}-row table)"),
        # the kernel by placement and table size: sliced, shared memory, L2, HBM
        ("gather_sum_sliced_32k", kernel(vtable, unroll=8, placement="sliced"), vmem,
         f" ({vmem_rows}-row table sliced across the SMs)"),
        ("gather_sum_l2_32k", kernel(vtable, unroll=8, placement="l2"), vmem,
         f" ({vmem_rows}-row table through L2)"),
        ("gather_sum_smem_1k", kernel(stable, unroll=8, placement="smem"), smem,
         f" ({stable.shape[0]}-row table in shared memory)"),
        ("gather_sum_u8_1k", kernel(stable, unroll=8, placement="l2"), smem,
         f" ({stable.shape[0]}-row table through L2)"),
        ("gather_sum_u8_1m", kernel(table, unroll=8), hbm, f" ({T}-row table)"),
    ]
    ns, launches = {}, {}
    for name, fn, make_idx, note in cases:
        before = G.launches
        ns[name] = measure(fn, make_idx, R, dev)
        launches[name] = G.launches - before
        print(f"{name:18s}: {ns[name]:7.2f} ns/row{note}", flush=True)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {
        "device": kind, "table_rows": T, "vmem_rows": vmem_rows, "smem_rows": int(stable.shape[0]),
        "grid_rows": grid_rows, "dim": D, "rays": R, "k_lo": K_LO, "k_hi": K_HI,
        "ns_per_row": ns, "launches": launches,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--table_rows", type=int, default=1 << 20)
    p.add_argument("--vmem_rows", type=int, default=1 << 15)
    p.add_argument("--dim", type=int, default=56)
    p.add_argument("--rays", type=int, default=8192)
    p.add_argument("--device", default="cuda", help="'cuda' raises when there is no GPU")
    args = p.parse_args(argv)
    res = run(args.table_rows, args.vmem_rows, args.dim, args.rays, args.device)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
