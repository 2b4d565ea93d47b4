"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is benchmark/workloads/<cell>.json: its configuration
(benchmark/configs/<config>.json) and its traffic mix
(benchmark/traffic/<traffic>.json), whose "kind" names the driver
benchmark/traffic/<kind>.py. The metrics it reports are BENCHMARK.json's:
with --trace 0 the cell's end-to-end metrics, which the driver measures on
the host clock over a window of --seconds; with --trace 1 its per-layer
metrics, each read by benchmark/metrics/<metric>.py from a profiler trace
of a shorter window (the traffic's traced units). Either way the run then
checks what the window produced against the plain reference and prints
each number compared beside its limit, on standard error and as the
result line's last key.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1 the breakdown of the traced
window). The run needs CUDA: without it, or with fewer devices than the
cell asks for, it exits with code 2 and prints no result.
"""

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time


def _process_start():
    """Seconds since the epoch at which this process started (from /proc;
    this module's import time where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


START = _process_start()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# Run as a script, this directory leads sys.path: its modules (trace,
# scene, ...) would shadow others of those names. They are imported as the
# package `benchmark` from the checkout's root instead.
if sys.path and os.path.abspath(sys.path[0] or ".") == BENCH:
    sys.path[0] = ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "plenoctree_tpu")
# Every build and kernel cache at a fixed place inside the checkout (the
# port's own nvcc builds go to build/kernels/ there already).
CACHE_ENV = {"TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton"),
             "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions")}


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name, overrides=None):
    """(cell, config, traffic) dicts of a cell, found by name; `overrides`
    {"config": {...}, "traffic": {...}} (tests' small sizes) is merged in,
    one level of nesting deep."""
    cell = load_json(BENCH, "workloads", f"{name}.json")
    config = load_json(BENCH, "configs", f"{cell['config']}.json")
    traffic = load_json(BENCH, "traffic", f"{cell['traffic']}.json")
    for part, d in (("config", config), ("traffic", traffic)):
        for k, v in ((overrides or {}).get(part) or {}).items():
            d[k] = {**d[k], **v} if isinstance(v, dict) and isinstance(d.get(k), dict) else v
    return cell, config, traffic


def cell_metrics(manifest, name, section):
    """The manifest's metrics of `section` that cell `name` reports."""
    return [m for m in manifest[section] if name in m.get("workloads", [name])]


def load_reader(metric):
    """benchmark/metrics/<metric>.py's read(view) function."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (the name before the first dot, compared whole)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit():
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class Ctx:
    """What a driver is given: the cell's files, the seed, the device, and
    the fault to plant (tests only; None in every run of the benchmark)."""

    def __init__(self, name, cell, config, traffic, seed, device, fault=None):
        self.name, self.cell, self.config, self.traffic = name, cell, config, traffic
        self.seed, self.device, self.fault = seed, device, fault


class View:
    """What a per-layer metric reader is given: the traced window's Summary
    (benchmark/trace.py), the units (frames or steps) it served, and the
    least seconds the driver worked out for them (benchmark/roofline.py)."""

    def __init__(self, summary, units, least):
        self.summary, self.units, self.least = summary, units, least


def execute(name, seed, seconds, trace, device, fault=None, control=None, manifest=None,
            overrides=None):
    """Run the cell; returns the result dict (its `checks` key last)."""
    import torch

    from benchmark import trace as trace_lib

    cell, config, traffic = load_cell(name, overrides)
    manifest = manifest or load_json(ROOT, "BENCHMARK.json")
    driver = importlib.import_module(f"benchmark.traffic.{traffic['kind']}")
    ctx = Ctx(name, cell, config, traffic, seed, device, fault)
    t0 = time.time()
    drv = driver.Driver(ctx)
    log(f"set-up: driver {time.time() - t0:.2f} s, since process start {time.time() - START:.2f} s")
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - START
    metrics = {}
    if trace:
        with trace_lib.traced() as tr:
            drv.run(units=traffic["traced_units"])
        summary = tr.summary
    else:
        drv.run(seconds=seconds)
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    e2e, attempted, failed = drv.end_to_end()
    e2e["setup_s"] = setup_s
    t0 = time.time()
    checks = drv.check(control=control)
    log(f"check: {time.time() - t0:.2f} s")
    if trace:
        t0 = time.time()
        view = View(summary, attempted, drv.least(attempted))
        log(f"least times: {time.time() - t0:.2f} s")
        for m in cell_metrics(manifest, name, "per_layer"):
            v = load_reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell_metrics(manifest, name, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= lim for _, v, lim in checks), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["card"] = power_limit() if device.type == "cuda" else None
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def log(msg):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


class ForbiddenImport(RuntimeError):
    pass


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    os.environ.update(CACHE_ENV)
    import torch

    cell, _, _ = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    # One process, few threads: the port's CPU-side torch work is small, and
    # idle intra-op workers only compete with the host thread that paces
    # every cell.
    torch.set_num_threads(1)
    try:
        out = execute(a.workload, a.seed, a.seconds, bool(a.trace), device)
    except ForbiddenImport as e:
        print(f"benchmark: loaded modules of JAX or the JAX package: {e.args[0]}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
