"""On the card only (marker `gpu`; skipped without CUDA, decided inside each
test): every cell runs once through the command the driver uses, with a
short window, and prints a correct result; the control at a cell's own
size comes out not correct. Run on the card with
`python -m pytest benchmark/tests -m gpu`."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ["sh16-serve-800", "sh16-train-b4096", "sg25-tileopt-800", "sg25-serve-800"]


def _need_cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    _need_cuda()
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2**31 + 17), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and "setup_s" in out["metrics"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    _need_cuda()
    res = subprocess.run([sys.executable, "benchmark/readings.py", "--workload", cell,
                          "--seeds", str(2**31 + 19), "--units", "2", "--control"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    with open(os.path.join(ROOT, "benchmark", "workloads", f"{cell}.json")) as f:
        limits = json.load(f)["limits"]
    assert any(got["control"][k] > lim for k, lim in limits.items()), got
