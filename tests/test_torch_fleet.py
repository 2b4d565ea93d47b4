"""The port's conversion fleet (plenoctree_tpu_torch/cli/task_manager.py) on
the CPU: task expansion equal to the JAX package's on every published task
file, the results file parser, a fleet run of an SH16-form and an SG-form
task (the published flags cut to init_grid_depth 4, 4 samples per cell, 1
epoch, with --device cpu) writing the JAX fleet's result keys, the
compress CLI on both trees, a task in tt_sh25.json's form on an
NSVF-layout scene (its {%} scene templating, --bbox_from_data,
--split_train), and a failed extraction recorded as the JAX fleet records
it. Small sizes: 2 x 16 trunks, 4 + 4 samples, scenes at 16 x 16.
"""

import copy
import json
import math
import os

import numpy as np
import pytest

from plenoctree_tpu.cli import task_manager as jtask_manager
from plenoctree_tpu_torch.cli import task_manager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("syn_sh16.json", "syn_sg25.json", "tt_sh25.json")
# The keys of one results.txt line of the JAX fleet: the scene, the
# extraction's <tree>.results.json under raw_* (JAX cli/extract.py), the
# evaluation's <tree>.results.json (JAX cli/evaluate.py).
RESULT_KEYS = {"scene", "raw_psnr", "raw_ssim", "raw_lpips", "raw_capacity", "raw_n_leaves",
               "psnr", "ssim", "lpips"}
SMALL = ["--device", "cpu", "--net_depth", "2", "--net_width", "16", "--num_coarse_samples", "4",
         "--num_fine_samples", "4", "--chunk", "1024"]


def _spec(name):
    with open(os.path.join(REPO, "octree", "config", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_expand_tasks_matches_jax(name):
    spec = _spec(name)
    want = jtask_manager.expand_tasks(copy.deepcopy(spec))
    got = task_manager.expand_tasks(copy.deepcopy(spec))
    assert got == want and len(got) >= 5
    assert all("{%}" not in json.dumps(t) for t in got)


def test_parse_results_file(tmp_path):
    p = tmp_path / "x.results.json"
    p.write_text(json.dumps({"psnr": 30.5, "ssim": 0.95}))
    for pkg in (task_manager, jtask_manager):
        assert pkg.parse_results_file(str(p)) == {"psnr": 30.5, "ssim": 0.95}
        assert pkg.parse_results_file(str(tmp_path / "missing.json")) == {}


def test_failed_extraction_is_recorded(tmp_path):
    """A scene whose checkpoint directory holds no checkpoint cannot be
    extracted: the worker records `extraction failed rc=1` and runs no later
    stage, as the JAX fleet does."""
    task = {"train_dir": str(tmp_path / "nothing"), "data_dir": str(tmp_path / "nothing"),
            "config": "nerf_sh/config/blender", "extr_flags": SMALL + ["--sh_deg", "1"]}
    res = task_manager.convert_one(task, None)
    assert res == {"scene": task["train_dir"], "error": "extraction failed rc=1"}
    assert not os.path.exists(os.path.join(task["train_dir"], "octrees", "tree.npz"))


def _train(train_dir, scene, config, extra):
    from plenoctree_tpu_torch.cli import train as train_cli

    train_cli.main(["--config", config, "--data_dir", scene, "--train_dir", train_dir,
                    "--batch_size", "64", "--max_steps", "3", "--print_every", "3",
                    "--save_every", "3", "--render_every", "0", "--sparsity_npoints", "50",
                    "--lr_init", "5e-3"] + SMALL + extra)


def test_fleet_runs_sh_and_sg_tasks(tmp_path):
    """Two tasks in the form of syn_sh16.json and syn_sg25.json (their
    configs, extr/opt/eval flags; cut: init_grid_depth 4, samples_per_cell
    4, num_epochs 1, sizes above) on checkpoints the port's train CLI
    wrote: one results.txt line each, no error, the JAX fleet's keys with
    finite PSNRs; then the compress CLI on both trees (an SG4 tree's
    extra_data kept)."""
    from plenoctree_tpu_torch.cli import compress as compress_cli
    from plenoctree_tpu_torch.data.synthetic import write_blender_dataset

    data_root, train_root = tmp_path / "data", tmp_path / "ckpt"
    write_blender_dataset(str(data_root / "scene"), n_train=4, n_test=1, resolution=16)
    spec = {"data_root": str(data_root), "train_root": str(train_root), "tasks": []}
    for name, model in (("syn_sh16.json", ["--sh_deg", "1"]), ("syn_sg25.json", ["--sg_dim", "4"])):
        task = _spec(name)["scene_tasks"][0]
        tdir = name.split(".")[0]
        _train(str(train_root / tdir), str(data_root / "scene"), task["config"], model)
        flags = SMALL + model
        i = task["opt_flags"].index("--num_epochs")
        spec["tasks"].append(dict(
            task, train_dir=tdir, data_dir="scene",
            extr_flags=task["extr_flags"] + flags + ["--init_grid_depth", "4",
                                                     "--samples_per_cell", "4"],
            opt_flags=task["opt_flags"][:i] + task["opt_flags"][i + 2:] + flags
            + ["--num_epochs", "1"],
            eval_flags=task["eval_flags"] + flags,
        ))
    task_file = tmp_path / "tasks.json"
    task_file.write_text(json.dumps(spec))
    task_manager.main([str(task_file), "--gpus", "0"])
    lines = [json.loads(x) for x in (tmp_path / "results.txt").read_text().splitlines()]
    assert [r["scene"] for r in lines] == [str(train_root / "syn_sh16"), str(train_root / "syn_sg25")]
    trees = []
    for r in lines:
        assert "error" not in r and set(r) == RESULT_KEYS, r
        assert math.isfinite(r["raw_psnr"]) and math.isfinite(r["psnr"]) and r["raw_n_leaves"] > 0
        trees.append(os.path.join(r["scene"], "octrees", "tree.npz"))
    out_dir = str(tmp_path / "min")
    compress_cli.main(trees[:1] + ["--out_dir", out_dir])
    compress_cli.main(trees[1:] + ["--out_dir", os.path.join(out_dir, "sg")])
    sh = np.load(os.path.join(out_dir, "tree.npz"))
    sg = np.load(os.path.join(out_dir, "sg", "tree.npz"))
    assert sh["quant_colors"].shape[0] == 4 and sg["quant_colors"].shape[0] == 4
    assert sg["extra_data"].shape == (4, 4) and str(sg["data_format"]) == "SG4"


def test_fleet_runs_a_tt_sh25_task(tmp_path):
    """octree/config/tt_sh25.json as it stands, its scenes cut to one, on an
    NSVF-layout fixture (10 train, 2 test views) and a checkpoint the train
    CLI wrote on nerf_sh/config/tt: the {%} substitution, the extraction's
    --bbox_from_data --data_bbox_scale 1.2 (bbox.txt's centre and radius),
    the optimizer's --split_train --split_holdout_prop 0.1 (one held-out
    view); the published flags cut: init_grid_depth 3, 4 samples per cell,
    1 epoch, the sizes above."""
    from plenoctree_tpu_torch.data.synthetic import write_nsvf_dataset

    spec = _spec("tt_sh25.json")
    spec["data_root"], spec["train_root"] = str(tmp_path / "data"), str(tmp_path / "ckpt")
    spec["scenes"] = spec["scenes"][:1]
    scene = spec["scenes"][0]
    write_nsvf_dataset(str(tmp_path / "data" / scene), n_train=10, n_test=2, resolution=16)
    task = spec["scene_tasks"][0]
    model = SMALL + ["--sh_deg", "1"]
    _train(str(tmp_path / "ckpt" / scene), str(tmp_path / "data" / scene), task["config"], model)
    i = task["opt_flags"].index("--num_epochs")
    task["extr_flags"] += model + ["--init_grid_depth", "3", "--samples_per_cell", "4"]
    task["opt_flags"] = task["opt_flags"][:i] + task["opt_flags"][i + 2:] + model + [
        "--num_epochs", "1"]
    task["eval_flags"] += model
    task_file = tmp_path / "tasks.json"
    task_file.write_text(json.dumps(spec))
    task_manager.main([str(task_file), "--gpus", "0"])
    (line,) = [json.loads(x) for x in (tmp_path / "results.txt").read_text().splitlines()]
    assert line["scene"] == str(tmp_path / "ckpt" / scene)
    assert "error" not in line and set(line) == RESULT_KEYS, line
    assert math.isfinite(line["raw_psnr"]) and math.isfinite(line["psnr"])
    from plenoctree_tpu_torch.octree import N3Tree

    tree = N3Tree.load(os.path.join(line["scene"], "octrees", "tree.npz"))
    # bbox.txt holds [-1, 1]^3: centre 0, radius 1 x data_bbox_scale 1.2
    np.testing.assert_allclose(tree.invradius, 0.5 / 1.2, rtol=1e-6)
    np.testing.assert_allclose(tree.offset, 0.5, rtol=1e-6)


def test_bench_fleet_tasks_keep_published_flags():
    """The fleet that chip_smoke.py and bench_fleet.py drive: each published
    task's config and extr/opt/eval flags, only --num_epochs replaced, the
    trained model's flags appended, and the checkpoints and views given."""
    from plenoctree_tpu_torch import bench_fleet

    tasks = bench_fleet.fleet_tasks("/ckpt/sh", "/ckpt/sg", "/views", 2)
    extra = bench_fleet.TRAINED_MODEL_FLAGS
    dirs = ("/ckpt/sh", "/ckpt/sg")
    for task, name, train_dir in zip(tasks, ("syn_sh16.json", "syn_sg25.json"), dirs):
        want = _spec(name)["scene_tasks"][0]
        assert task["config"] == want["config"]
        assert (task["train_dir"], task["data_dir"]) == (train_dir, "/views")
        assert task["extr_flags"] == want["extr_flags"] + extra
        assert task["eval_flags"] == want["eval_flags"] + extra
        i = want["opt_flags"].index("--num_epochs")
        assert task["opt_flags"][i + 1] == "2" and want["opt_flags"][i + 1] == "80"
        assert task["opt_flags"][:i + 1] + task["opt_flags"][i + 2:] == (
            want["opt_flags"][:i + 1] + want["opt_flags"][i + 2:] + extra)
