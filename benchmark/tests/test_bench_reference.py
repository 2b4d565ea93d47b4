"""The plain references against the port's plain paths at a small size on
the CPU, and each cell's check: sound runs pass; the control (the reference
in the precision below the configuration's, in the program's place) and
the faults a cell can have come out not correct."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402

# At these sizes a 128-row block of the tile index spans much of the scene,
# and the tile path's within-chunk order (by each piece's centre along the
# tile's mean direction) departs from the per-ray order on most pixels;
# 32-row blocks keep it where it is at 800x800 on the depth-7 tree.
CHUNKS = {"runrows": 128, "quantum": 32}
SERVE = {"config": {"tree": {"depth": 4}},
         "traffic": {"height": 33, "width": 33, "focal_factor": 3.0, "grid_c": 16,
                     "warmup_frames": 2, "check_frames": 2, "check_pixels": 600, **CHUNKS}}
TRAIN = {"config": {"model": {"net_width": 32, "net_depth": 4, "skip_layer": 2,
                              "num_coarse_samples": 16, "num_fine_samples": 16,
                              "sparsity_npoints": 64}},
         "traffic": {"batch_size": 64, "views": 3, "height": 16, "width": 16,
                     "warmup_steps": 1}}
OPT = {"config": {"tree": {"depth": 4}},
       "traffic": {"height": 24, "width": 24, "focal_factor": 3.0, "grid_c": 16, "views": 3,
                   "warmup_steps": 0, **CHUNKS}}
# Limits at these small sizes, between the sound readings and the control's.
SMALL_LIMITS = {
    "sh16-serve-800": {"pixel_off_share": 0.05},
    "sg25-serve-800": {"pixel_off_share": 0.05},
    "sh16-train-b4096": {"loss_gap": 1e-4, "grad_norm_gap": 1e-4, "change_norm_gap": 1e-3},
    "sg25-tileopt-800": {"loss_gap": 3e-3, "grad_norm_gap": 5e-3, "change_norm_gap": 0.03},
}
SIZES = {"sh16-serve-800": SERVE, "sg25-serve-800": SERVE, "sh16-train-b4096": TRAIN,
         "sg25-tileopt-800": OPT}
MAN = {"end_to_end": [], "per_layer": []}


def _run(cell, seed, monkeypatch, **kw):
    real = run.load_cell

    def load(name, overrides=None):
        c, cfg, tr = real(name, overrides)
        c["limits"] = SMALL_LIMITS[cell]
        return c, cfg, tr

    monkeypatch.setattr(run, "load_cell", load)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return run.execute(cell, seed, 0.0, False, torch.device("cpu"), manifest=MAN,
                       overrides=SIZES[cell], **kw)


@pytest.mark.parametrize("cell", sorted(SIZES))
@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_sound_runs_are_correct(cell, seed, monkeypatch):
    out = _run(cell, seed, monkeypatch)
    assert out["correct"], out["checks"]


CASES = [("sh16-serve-800", {"control": "bf16"}), ("sg25-serve-800", {"control": "bf16"}),
         ("sh16-serve-800", {"fault": "alter"}),
         ("sh16-train-b4096", {"control": "fp8"}), ("sh16-train-b4096", {"fault": "frozen"}),
         ("sh16-train-b4096", {"fault": "half"}),
         ("sg25-tileopt-800", {"control": "bf16"}), ("sg25-tileopt-800", {"fault": "frozen"}),
         ("sg25-tileopt-800", {"fault": "half"})]


@pytest.mark.parametrize("cell,kw", CASES, ids=[f"{c}-{list(k.values())[0]}" for c, k in CASES])
def test_control_and_faults_are_not_correct(cell, kw, monkeypatch):
    out = _run(cell, 11, monkeypatch, **kw)
    assert not out["correct"], out["checks"]
