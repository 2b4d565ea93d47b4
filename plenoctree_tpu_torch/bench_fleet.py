"""The conversion fleet and extraction step 2 on one card, timed.

    python -m plenoctree_tpu_torch.bench_fleet [--res 48 64] [--step2_ab]
        [--stop_after_s 400] [--out_dir build/bench_fleet]

Trains the two checkpoints that chip_smoke.py's fleet converts (the train
CLI, 200 steps at full width with the fused kernels and bf16 on the
synthetic scene: nerf_sh/config/blender at batch 4096 (SH16) and
nerf_sh/config/misc/sg (SG25)), then:

- with --step2_ab: the extract CLI on the SH16 checkpoint with chip_smoke.py's
  phase-9 flags (syn_sh16's, init_grid_depth 7, no eval), step 2
  (`step2_fill`) timed in turns, with 2^20-point dispatches: the jitter
  drawn on the calling thread, then on threads (`extract._jitter_chunks`),
  then the two again in reverse;
- for each --res: the fleet (`cli.task_manager --gpus 0`) on chip_smoke.py's
  two tasks (`fleet_tasks`) with the synthetic scene's views at res x res:
  the wall-clock of each stage and the leaves of each tree; then the
  compress CLI (--bits 16) on both trees, timed. Once a fleet takes longer
  than --stop_after_s, the larger resolutions are skipped (every stage does
  more work at more views: more leaves, more pixels).

Prints one JSON line per measurement, then the card's name and power limit.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_STEPS = 200
SH_CONFIG, SG_CONFIG = "nerf_sh/config/blender", "nerf_sh/config/misc/sg"
# The flags the checkpoints are trained with; every later stage gets them.
TRAINED_MODEL_FLAGS = ["--use_pallas", "--compute_dtype", "bfloat16"]
# syn_sh16's extraction flags at init_grid_depth 7 (chip_smoke.py phase 9).
STEP2_FLAGS = [
    "--autoscale", "--scale_alpha_thresh", "0.1", "--radius", "1.4", "--samples_per_cell", "256",
    "--no_early_stop", "--renderer_step_size", "1e-5", "--init_grid_depth", "7", "--noeval",
]


def train(config, train_dir, extra=()):
    """The train CLI for TRAIN_STEPS steps on the synthetic scene (its
    per-step lines to train.log); returns train_dir."""
    from plenoctree_tpu_torch.cli import train as train_cli

    os.makedirs(train_dir, exist_ok=True)
    with open(os.path.join(train_dir, "train.log"), "w") as log, contextlib.redirect_stdout(log):
        train_cli.main([
            "--config", config, "--dataset", "synthetic", "--train_dir", train_dir,
            "--device", "cuda", *TRAINED_MODEL_FLAGS, *extra, "--max_steps", str(TRAIN_STEPS),
            "--lr_final", "5e-5", "--print_every", "1", "--save_every", str(TRAIN_STEPS),
            "--render_every", str(TRAIN_STEPS),
        ])
    return train_dir


def fleet_tasks(sh_dir, sg_dir, data_dir, epochs):
    """Two tasks in the form of octree/config/syn_sh16.json and syn_sg25.json:
    their configs and published extr/opt/eval flags, --num_epochs 80 ->
    `epochs`, plus the model flags the checkpoints were trained with."""
    tasks = []
    for name, train_dir in (("syn_sh16.json", sh_dir), ("syn_sg25.json", sg_dir)):
        with open(os.path.join(ROOT, "octree", "config", name)) as f:
            task = json.load(f)["scene_tasks"][0]
        opt = task["opt_flags"]
        i = opt.index("--num_epochs")
        tasks.append(dict(
            task, train_dir=train_dir, data_dir=data_dir,
            extr_flags=task["extr_flags"] + TRAINED_MODEL_FLAGS,
            opt_flags=opt[:i] + ["--num_epochs", str(epochs)] + opt[i + 2:] + TRAINED_MODEL_FLAGS,
            eval_flags=task["eval_flags"] + TRAINED_MODEL_FLAGS,
        ))
    return tasks


def run_fleet(tasks, fleet_dir, gpus="0"):
    """`python -m plenoctree_tpu_torch.cli.task_manager tasks.json --gpus
    <gpus>` as a subprocess (its output to fleet.log) on `tasks` (a list of
    tasks, or a whole task-file spec with its scenes and roots) written to
    fleet_dir/tasks.json; returns (rc, {task's train_dir name: {stage: s}}
    from the workers' stage lines, the results.txt lines, wall s). With
    several workers ("0 0": two on one card) a stage's time runs to the
    next line of the same task."""
    os.makedirs(fleet_dir, exist_ok=True)
    results_path = os.path.join(fleet_dir, "results.txt")
    if os.path.exists(results_path):
        os.remove(results_path)
    task_file = os.path.join(fleet_dir, "tasks.json")
    with open(task_file, "w") as f:
        json.dump(tasks if isinstance(tasks, dict) else {"tasks": tasks}, f, indent=1)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    marks = {}  # task's train_dir name -> [(seconds since start, stage or None)]
    with open(os.path.join(fleet_dir, "fleet.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "plenoctree_tpu_torch.cli.task_manager", task_file,
             "--gpus", gpus], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1,
        )
        for line in proc.stdout:
            log.write(line)
            if line.startswith("[worker] done"):
                scene, stage = line.split("'scene': '")[1].split("'")[0], None
            elif line.startswith("[worker]"):
                scene = line.split("--train_dir ")[1].split()[0]
                stage = line.split("plenoctree_tpu_torch.cli.")[1].split()[0]
            else:
                continue
            marks.setdefault(os.path.basename(scene), []).append((time.time() - t0, stage))
        rc = proc.wait()
    wall = time.time() - t0
    stages = {}
    for scene, seq in marks.items():
        for (t_a, stage), (t_b, _) in zip(seq, seq[1:]):
            if stage is not None:
                stages.setdefault(scene, {})[stage] = round(t_b - t_a, 2)
    lines = []
    if os.path.exists(results_path):
        with open(results_path) as f:
            lines = [json.loads(x) for x in f.read().splitlines() if x.strip()]
    if not isinstance(tasks, dict):  # the tasks' order, whichever worker finished first
        order = {t["train_dir"]: i for i, t in enumerate(tasks)}
        lines.sort(key=lambda r: order.get(r.get("scene"), len(order)))
    return rc, stages, lines, wall


def fleet_trees(lines):
    """{SH16, SG25: the tree the fleet evaluated} from its results lines."""
    trees = {}
    for name, r in zip(("SH16", "SG25"), lines):
        octrees = os.path.join(r["scene"], "octrees")
        best = os.path.join(octrees, "tree_opt.npz")
        trees[name] = best if os.path.exists(best) else os.path.join(octrees, "tree.npz")
    return trees


def _sequential_jitter(tree, corner, size, S, chunk_size, rng):
    """extract._jitter_chunks' chunks drawn on the calling thread, one after
    another."""
    n = corner.shape[0]
    for lo in range(0, n, chunk_size):
        hi = min(lo + chunk_size, n)
        u = rng.random((hi - lo, S, 3), dtype=np.float64)
        t = corner[lo:hi, None, :] + u * size[lo:hi, None, None]
        yield lo, hi, tree.tree2world(t.astype(np.float32)).reshape(-1, 3)


def step2_ab(sh_dir, out_dir):
    """Step 2 of the SH16 extraction per variant (see the module docstring);
    returns [(variant, s)]."""
    import torch

    from plenoctree_tpu_torch.cli import extract as extract_cli
    from plenoctree_tpu_torch.octree import extract as extract_lib

    fill, threaded = extract_lib.step2_fill, extract_lib._jitter_chunks
    took = []

    def timed_fill(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fill(*args, **kw)
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t0)
        return out

    variants = [(1 << 20, False), (1 << 20, True), (1 << 20, True), (1 << 20, False)]
    rows = []
    extract_lib.step2_fill = timed_fill
    try:
        for chunk, on_threads in variants:
            extract_lib._jitter_chunks = threaded if on_threads else _sequential_jitter
            log_path = os.path.join(out_dir, "step2.log")
            with open(log_path, "a") as log, contextlib.redirect_stdout(log):
                extract_cli.main([
                    "--config", SH_CONFIG, "--dataset", "synthetic", "--train_dir", sh_dir,
                    "--device", "cuda", *TRAINED_MODEL_FLAGS, "--point_chunk", str(chunk),
                    "--output", os.path.join(out_dir, "step2", "tree.npz"), *STEP2_FLAGS,
                ])
            name = f"2^{chunk.bit_length() - 1} points, jitter on " + (
                "threads" if on_threads else "the calling thread")
            rows.append((name, took[-1]))
    finally:
        extract_lib.step2_fill, extract_lib._jitter_chunks = fill, threaded
    return rows


def compress_trees(trees, out_dir):
    """The compress CLI (--bits 16) on each tree: {name: (s, MB before, MB
    after)}."""
    from plenoctree_tpu_torch.cli import compress as compress_cli

    out = {}
    for name, src in trees.items():
        dst_dir = os.path.join(out_dir, name)
        t0 = time.time()
        compress_cli.main([src, "--out_dir", dst_dir, "--bits", "16", "--overwrite"])
        dst = os.path.join(dst_dir, os.path.basename(src))
        out[name] = (round(time.time() - t0, 2), os.path.getsize(src) / 2**20,
                     os.path.getsize(dst) / 2**20)
    return out


def main(argv=None):
    import torch

    from plenoctree_tpu_torch.data.synthetic import write_blender_dataset

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--res", type=int, nargs="*", default=[48, 64])
    parser.add_argument("--step2_ab", action="store_true")
    parser.add_argument("--stop_after_s", type=float, default=400.0)
    parser.add_argument("--epochs", type=int, default=2, help="--num_epochs of the fleet's tasks")
    parser.add_argument("--out_dir", default=os.path.join(ROOT, "build", "bench_fleet"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_fleet needs a CUDA GPU")
    os.makedirs(args.out_dir, exist_ok=True)

    t0 = time.time()
    sh_dir = train(SH_CONFIG, os.path.join(args.out_dir, "train_sh16"),
                   ["--batch_size", "4096", "--image_batching"])
    sg_dir = train(SG_CONFIG, os.path.join(args.out_dir, "train_sg25"))
    print(json.dumps({"train_s": round(time.time() - t0, 2)}), flush=True)

    if args.step2_ab:
        for name, s in step2_ab(sh_dir, args.out_dir):
            print(json.dumps({"step2": name, "s": s}), flush=True)

    for res in sorted(args.res):
        scene = os.path.join(args.out_dir, f"scene_{res}")
        write_blender_dataset(scene, 12, 4, res)
        rc, stages, lines, wall = run_fleet(
            fleet_tasks(sh_dir, sg_dir, scene, args.epochs),
            os.path.join(args.out_dir, f"fleet_{res}"),
        )
        row = {"fleet_res": res, "rc": rc, "wall_s": round(wall, 2), "stage_s": stages,
               "leaves": [r.get("raw_n_leaves") for r in lines],
               "psnr": [r.get("psnr") for r in lines],
               "errors": [r["error"] for r in lines if "error" in r]}
        if rc == 0 and len(lines) == 2 and not row["errors"]:
            row["compress_s_mb"] = compress_trees(
                fleet_trees(lines), os.path.join(args.out_dir, f"compressed_{res}"))
        print(json.dumps(row), flush=True)
        if rc != 0 or wall > args.stop_after_s:
            break
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
