"""The tile kernels on the card at chip_smoke.py's 800x800 cells, beside
other builds of csrc/tile_composite.cu (for example an earlier commit's), in
turns within one process.

    python -m plenoctree_tpu_torch.bench_tile [--baseline PATH.cu ...] [--reps 3]

Cells: the depth-7 SH16 scene tree (chip_smoke.py's), one 800x800 pose
each: serving (sigma and stop thresholds 1e-2, phase 4's pose), and the
exact-mode forward and the backward (the tile optimizer's keep_all index,
phase 11's pose and seeded cotangent). For each build (this tree's, then
each --baseline, built with the same nvcc flags; a baseline must keep the C
interface): its errors against the plain versions (forward max abs,
backward per field group relative to the group's largest |gradient|, and
between two runs), and ms per launch from CUDA events over 5 launches,
taken in turns (this tree, the baselines, the baselines again in reverse,
this tree) --reps times. A build that exports pn_split_reset and
pn_split_read (a clock64-instrumented copy) also gets the share of its
leading threads' cycles in each section of each kernel (sections named by
its pn_split_names, else SPLIT_SECTIONS). Prints one JSON line per build,
then the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from plenoctree_tpu_torch.kernels import _build
from plenoctree_tpu_torch.kernels import tile_composite as K

RES = 800
SEED = 0
# Section names of an instrumented build's cycle counters (pn_split_read)
# when it does not name them itself: the layout of a copy of this PR's parent.
SPLIT_SECTIONS = {
    "forward": {0: "saturation test", 1: "staging", 2: "sort", 3: "walk", 4: "decode (in walk)",
                5: "total"},
    "backward": {8: "staging", 9: "sort", 10: "walk", 11: "decode (in walk)",
                 12: "reduction (in walk)", 13: "flush", 14: "total"},
}


def cells(device):
    """(serving (p2, soa, kw), exact (p2, soa, kw, out, g, backward kw)) of
    chip_smoke's tree and poses (as its phases 4 and 11 make them: the exact
    cell must fit its caps), with the exact forward output from the plain
    version."""
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.data.synthetic import build_scene_tree
    from plenoctree_tpu_torch.octree.tile_opt import TileOptimizer
    from plenoctree_tpu_torch.octree.tile_render import TileRenderer

    tree = build_scene_tree(7, 16, 0.05, SEED)
    focal = 1.1 * RES
    serving = TileRenderer(tree, step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2, device=device)
    opt = TileOptimizer(tree, step_size=1e-5, ccap=512, device=device)
    out = []
    for r, c2w in ((serving, orbit_pose(0.0)), (opt.r, orbit_pose(0.3))):
        r.w1cap = r.w1cap or int(min(r.grid_c, np.ceil(np.sqrt(3) * r.tile / focal * r.grid_c) + 3))
        ti = r.make_tile_inputs_fn(RES, RES, focal, r.rcap, r.w1cap, r.ccap)
        idx = r.index
        p2, _, nck, w1o = ti(c2w, idx["csr"], idx["base"], r.extra_data, idx["blk_bbox"])
        if r is opt.r and (int(nck.max()) > r.ccap or int(w1o.max()) > 0):
            raise RuntimeError(f"caps too small: pieces {int(nck.max())}, w1 {int(w1o.max())}")
        out.append(p2)
    s_kw = serving._kernel_kw
    e_kw = dict(opt._kw, stop_thresh=0.0, od_cap=1e30)
    soa_s, soa_e = serving.index["soa"], opt.static_soa
    fwd_e = K.composite_tiles_reference(*out[1], soa_e, **e_kw)
    g = torch.tensor(np.random.default_rng(SEED).normal(size=tuple(fwd_e.shape)),
                     dtype=torch.float32, device=device)
    return (out[0], soa_s, s_kw), (out[1], soa_e, e_kw, fwd_e, g, opt._kw)


def cuda_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def group_errs(got, ref, sigma_row):
    errs = {}
    for name, sl in (("sigma", slice(sigma_row, sigma_row + 1)), ("colour", slice(6, sigma_row))):
        top = float(ref[:, sl].abs().max())
        errs[name] = float((got[:, sl] - ref[:, sl]).abs().max()) / top
    return errs


def run(baselines, reps, device="cuda"):
    serving, exact = cells(device)
    p2s, soa_s, s_kw = serving
    p2e, soa_e, e_kw, fwd_e, g, b_kw = exact
    ref_s = K.composite_tiles_reference(*p2s, soa_s, **s_kw)
    ref_b = K.composite_tiles_bwd_reference(*p2e, soa_e, fwd_e, g, **b_kw)
    sr = b_kw["sigma_row"]
    builds = [("this tree", K.build())]
    for i, path in enumerate(baselines):
        lib = _build.load_library(f"tile_composite_base{i}", [os.path.abspath(path)])
        builds.append((path, K._bind(lib)))
    res = {}
    for name, lib in builds:
        fns = {
            "serving": lambda lib=lib: K._launch_fwd(lib, p2s[:10], soa_s, **s_kw),
            "exact": lambda lib=lib: K._launch_fwd(lib, p2e[:10], soa_e, **e_kw),
            "backward": lambda lib=lib: K._launch_bwd(lib, p2e[:10], soa_e, fwd_e, g, **b_kw),
        }
        got_b, again = fns["backward"](), fns["backward"]()
        r = {
            "build": name,
            "serving_max_abs_err": float((fns["serving"]() - ref_s).abs().max()),
            "exact_max_abs_err": float((fns["exact"]() - fwd_e).abs().max()),
            "bwd_rel_err": group_errs(got_b, ref_b, sr),
            "bwd_rerun_rel": group_errs(again, got_b, sr),
            "ms": {k: [] for k in fns},
            "split": None,
        }
        if hasattr(lib, "pn_split_read"):
            r["split"] = split(lib, fns)
        res[name] = (r, fns)
    order = [n for n, _ in builds]
    for _ in range(reps):
        for name in order + order[::-1]:
            r, fns = res[name]
            for k, fn in fns.items():
                r["ms"][k].append(cuda_ms(fn))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = []
    for name in order:
        r = res[name][0]
        r["ms_median"] = {k: float(np.median(v)) for k, v in r["ms"].items()}
        r["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(r), flush=True)
        out.append(r)
    print(smi, flush=True)
    return out


def split(lib, fns):
    """Share of the block leaders' cycles per section, one launch of each kernel."""
    buf = (ctypes.c_ulonglong * 16)()
    lib.pn_split_reset.restype = lib.pn_split_read.restype = ctypes.c_int
    lib.pn_split_read.argtypes = [ctypes.c_void_p]
    out = {}
    for kernel, fn in (("forward", fns["exact"]), ("forward_serving", fns["serving"]),
                       ("backward", fns["backward"])):
        torch.cuda.synchronize()
        lib.pn_split_reset()
        fn()
        torch.cuda.synchronize()
        lib.pn_split_read(ctypes.cast(buf, ctypes.c_void_p))
        names = SPLIT_SECTIONS["backward" if kernel == "backward" else "forward"]
        if hasattr(lib, "pn_split_names"):
            lib.pn_split_names.restype = ctypes.c_char_p
            pairs = (item.split("=") for item in lib.pn_split_names().decode().split(";"))
            names = {int(i): n for i, n in pairs}
        # Each section as a share of its thread's total: "consumer: walk" of
        # "consumer: total"; unprefixed names are one thread's.
        thread = lambda n: n.split(":")[0] if ":" in n else ""  # noqa: E731
        totals = {thread(n): buf[i] for i, n in names.items() if n.endswith("total")}
        out[kernel] = {n: buf[i] / totals[thread(n)] for i, n in names.items()
                       if not n.endswith("total") and totals.get(thread(n))}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="another tile_composite.cu with the same C interface")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_tile times the CUDA kernels: it needs a CUDA device")
    run(args.baseline, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
