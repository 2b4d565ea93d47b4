"""The readings that a cell's limits are set from, many seeds in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --units 40 \
        [--control] [--fault frozen|half|alter]

For each seed it builds the cell's driver at the cell's own sizes, runs
`--units` frames or steps (enough to finish what the check compares), and
prints one JSON line: the numbers the check compares for the program, and,
with --control, for the control (the reference in the precision below the
configuration's, in the program's place, on the same inputs). With --fault
the driver plants that fault in the timed path instead. The benchmark's own
runs never run this; PERF.md gives the readings and the limits set from
them.
"""

import argparse
import gc
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == BENCH:
    sys.path[0] = os.path.dirname(BENCH)

CONTROL = {"serve": "bf16", "tileopt": "bf16", "train": "fp8"}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--units", type=int, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    a = p.parse_args(argv)
    import importlib

    import torch

    from benchmark import run

    os.environ.update(run.CACHE_ENV)
    dev = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    cell, config, traffic = run.load_cell(a.workload)
    driver = importlib.import_module(f"benchmark.traffic.{traffic['kind']}")
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.time()
        drv = driver.Driver(run.Ctx(a.workload, cell, config, traffic, seed, dev, a.fault))
        drv.run(units=a.units)
        out = {"seed": seed, "fault": a.fault,
               "program": {n: v for n, v, _ in drv.check()}}
        if hasattr(drv, "detail"):
            out["program_detail"] = drv.detail
        if a.control:
            out["control"] = {n: v for n, v, _ in drv.check(control=CONTROL[traffic["kind"]])}
            if hasattr(drv, "detail"):
                out["control_detail"] = drv.detail
        out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)
        del drv
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
