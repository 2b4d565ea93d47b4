"""Per-scene conversion fleet.

Port of plenoctree_tpu/cli/task_manager.py: JSON task files with '{%}'
scene templating, a queue of scenes handed to one worker per `--gpus` id
(each pinned to its card through CUDA_VISIBLE_DEVICES), each running the
port's extract -> optimize -> evaluate CLIs as subprocesses
(`python -m plenoctree_tpu_torch.cli.{extract,optimize,evaluate}`) and
appending one JSON line per scene to `results.txt` beside the task file:
the extraction's `<tree>.results.json` under `raw_*` keys, then the
evaluation's. A stage that fails records `error` and ends the scene. A
CPU run passes `--device cpu` in the task's `*_flags`.

Usage:
  python -m plenoctree_tpu_torch.cli.task_manager tasks.json --gpus "0 1 2 3"
"""

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
from multiprocessing import Process, Queue

_STAGES = "plenoctree_tpu_torch.cli."


def parse_results_file(path):
    if not osp.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def convert_one(task, device, python=sys.executable):
    """Run extraction -> optimization -> evaluation for one scene; returns
    its results dict."""
    env = dict(os.environ)
    if device is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(device)

    train_dir = task["train_dir"]
    data_dir = task["data_dir"]
    config = task.get("config")
    octree_name = task.get("octree_name", "")
    out_dir = osp.join(train_dir, "octrees" if not octree_name else octree_name)
    os.makedirs(out_dir, exist_ok=True)
    tree_path = osp.join(out_dir, "tree.npz")
    tree_opt_path = osp.join(out_dir, "tree_opt.npz")

    base = ["--train_dir", train_dir, "--data_dir", data_dir]
    if config:
        base += ["--config", config]

    def run(stage, extra):
        cmd = [python, "-m", _STAGES + stage] + base + extra
        print("[worker]", " ".join(cmd), flush=True)
        return subprocess.run(cmd, env=env).returncode

    results = {"scene": train_dir}
    rc = run("extract", ["--output", tree_path] + task.get("extr_flags", []))
    if rc != 0:
        results["error"] = f"extraction failed rc={rc}"
        return results
    results.update(
        {"raw_" + k: v for k, v in parse_results_file(tree_path + ".results.json").items()}
    )

    rc = run("optimize", ["--input", tree_path, "--output", tree_opt_path]
             + task.get("opt_flags", []))
    if rc != 0:
        results["error"] = f"optimization failed rc={rc}"
        return results

    eval_input = tree_opt_path if osp.exists(tree_opt_path) else tree_path
    rc = run("evaluate", ["--input", eval_input] + task.get("eval_flags", []))
    if rc != 0:
        results["error"] = f"evaluation failed rc={rc}"
        return results
    results.update(parse_results_file(eval_input + ".results.json"))
    return results


def process_main(queue, results_path, device):
    while True:
        task = queue.get()
        if task is None:
            return
        results = convert_one(task, device)
        with open(results_path, "a") as f:
            f.write(json.dumps(results) + "\n")
        print("[worker] done:", results, flush=True)


def expand_tasks(spec):
    """A task file's spec -> the concrete per-scene tasks: '{%}' replaced by
    each scene of `scenes` in every `scene_tasks` entry, then the explicit
    `tasks`, with train_dir and data_dir joined to their roots."""
    data_root = spec.get("data_root", "")
    train_root = spec.get("train_root", "")
    tasks = []
    for task in spec.get("scene_tasks", []):
        for scene in spec.get("scenes", []):
            tasks.append(json.loads(json.dumps(task).replace("{%}", scene)))
    tasks.extend(json.loads(json.dumps(t)) for t in spec.get("tasks", []))
    for t in tasks:
        t["train_dir"] = osp.join(train_root, t["train_dir"])
        t["data_dir"] = osp.join(data_root, t["data_dir"])
    return tasks


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("task_file", type=str, help="JSON task file")
    parser.add_argument(
        "--gpus", type=str, default="0",
        help='space-separated CUDA device ids, e.g. "0 1 2 3" (one worker each)',
    )
    args = parser.parse_args(argv)

    with open(args.task_file) as f:
        spec = json.load(f)
    tasks = expand_tasks(spec)

    results_path = osp.join(osp.dirname(osp.abspath(args.task_file)), "results.txt")
    devices = args.gpus.split()
    queue = Queue()
    for t in tasks:
        queue.put(t)
    for _ in devices:
        queue.put(None)

    if len(devices) == 1:
        process_main(queue, results_path, devices[0])
    else:
        procs = [Process(target=process_main, args=(queue, results_path, d)) for d in devices]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    print("All tasks finished; results in", results_path)


if __name__ == "__main__":
    sys.exit(main())
