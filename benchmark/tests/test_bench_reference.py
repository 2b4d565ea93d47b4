"""The plain references against the port's plain paths at a small size on
the CPU, and each cell's check: sound runs pass; the control (the reference
in the precision below the configuration's, in the program's place) and
the faults a cell can have come out not correct."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    MANIFEST_CELLS = sorted(w["name"] for w in json.load(_f)["workloads"])

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
# Limits at these small sizes, between the sound readings and the control's,
# by traffic kind: every cell of BENCHMARK.json runs at its kind's size.
SMALL_LIMITS = {
    "serve": {"pixel_off_share": 0.05},
    "train": {"loss_gap": 1e-4, "grad_norm_gap": 1e-4, "change_norm_gap": 1e-3},
    "tileopt": {"loss_gap": 3e-3, "grad_norm_gap": 5e-3, "change_norm_gap": 0.03},
}
SIZES = {"serve": SERVE, "train": TRAIN, "tileopt": OPT}
# The control and the faults each kind of cell can have.
FAULTS = {"serve": [{"control": "bf16"}, {"fault": "alter"}],
          "train": [{"control": "fp8"}, {"fault": "frozen"}, {"fault": "half"}],
          "tileopt": [{"control": "bf16"}, {"fault": "frozen"}, {"fault": "half"}]}
MAN = {"end_to_end": [], "per_layer": []}


def _kind(cell):
    return run.load_cell(cell)[2]["kind"]


def _small_cells():
    """The manifest's cells, one for each distinct run at the small sizes (the
    first by name): cells that differ only at full size, as sh16-serve-d8's
    depth 8 from sh16-serve-800's 7, are one case here. A cell whose traffic
    kind has no small size stays in the list, and its cases skip."""
    cells, seen = [], set()
    for c in MANIFEST_CELLS:
        kind = _kind(c)
        if kind in SIZES:
            _, cfg, tr = run.load_cell(c, SIZES[kind])
            key = json.dumps([{k: cfg.get(k) for k in ("model", "tree", "optimize")}, tr],
                             sort_keys=True)
            if key in seen:
                continue
            seen.add(key)
        cells.append(c)
    return cells


CELLS = _small_cells()


def _need_size(cell):
    if _kind(cell) not in SIZES:
        pytest.skip(f"no small size for traffic kind {_kind(cell)!r}")


def _run(cell, seed, monkeypatch, overrides=None, **kw):
    real = run.load_cell
    kind = _kind(cell)

    def load(name, overrides=None):
        c, cfg, tr = real(name, overrides)
        c["limits"] = SMALL_LIMITS[kind]
        return c, cfg, tr

    monkeypatch.setattr(run, "load_cell", load)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return run.execute(cell, seed, 0.0, False, torch.device("cpu"), manifest=MAN,
                       overrides=overrides or SIZES[kind], **kw)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_sound_runs_are_correct(cell, seed, monkeypatch):
    _need_size(cell)
    out = _run(cell, seed, monkeypatch)
    assert out["correct"], out["checks"]


CASES = [(c, kw) for c in CELLS for kw in FAULTS.get(_kind(c), [{"control": "none"}])]


@pytest.mark.parametrize("cell,kw", CASES, ids=[f"{c}-{list(k.values())[0]}" for c, k in CASES])
def test_control_and_faults_are_not_correct(cell, kw, monkeypatch):
    _need_size(cell)
    out = _run(cell, 11, monkeypatch, **kw)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_train_check_at_sh_degree_4_is_correct(seed, monkeypatch):
    """The train traffic's check with a degree-4 SH head (tt.yaml's sh_deg),
    at the small size: the reference's basis reaches degree 4."""
    cell = next(c for c in CELLS if _kind(c) == "train")
    sizes = {**TRAIN, "config": {"model": {**TRAIN["config"]["model"], "sh_deg": 4}}}
    out = _run(cell, seed, monkeypatch, overrides=sizes)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_bf16_reference_follows_the_ports_bf16_trunk(seed):
    """The train reference with bfloat16 operands (the precision the
    configuration states) against the port's bfloat16 fused trunk, which on
    the CPU runs its plain kernel references, at the same parameters, batch
    and draws: the loss parts and the gradients' norms agree to float32
    rounding, where the float32 reference parts from both by bfloat16's."""
    from plenoctree_tpu_torch import engine
    from plenoctree_tpu_torch.data.rays import Rays
    from plenoctree_tpu_torch.models.nerf import get_model_state
    from plenoctree_tpu_torch.utils.config import default_config

    from benchmark.reference import nerf_ref
    from benchmark.traffic import train

    cell = next(c for c in CELLS if _kind(c) == "train")
    _, config, _ = run.load_cell(cell, TRAIN)
    m = config["model"]
    assert m["compute_dtype"] == "bfloat16" and m["use_pallas"]
    dev, b = torch.device("cpu"), 64
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cfg = default_config(dataset="blender", batch_size=b, **m)
    model, _ = get_model_state(cfg, seed=0, restore=False, device=dev)
    init = train.init_params(model, seed, dev)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(init[k])
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(b, 3, generator=g)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = 0.5 * torch.randn(b, 3, generator=g) - o
    vd = d / d.norm(dim=-1, keepdim=True)
    r = m["sparsity_radius"]
    batch = {"pixels": torch.rand(b, 3, generator=g), "rays": Rays(o, d, vd)}
    draws = {"t_rand": torch.rand(b, m["num_coarse_samples"], generator=g),
             "u": torch.rand(b, m["num_fine_samples"] + 1, generator=g),
             "sp_points": torch.rand(m["sparsity_npoints"], 3, generator=g) * (2 * r) - r}
    stats, grads = engine.loss_and_grads(model, batch, cfg, draws=draws)
    mine = (float(stats.loss), float(stats.loss_c), float(stats.loss_sp))
    flat = {"pixels": batch["pixels"], "origins": o, "directions": d, "viewdirs": vd}

    def gaps(quant):
        p = {k: v.clone().requires_grad_(True) for k, v in init.items()}
        total, parts = nerf_ref.render_loss(p, flat, draws, m, quant)
        ref_g = dict(zip(p, torch.autograd.grad(total, list(p.values()))))
        ref = [float(x.detach()) for x in parts]
        loss = max(abs(a - r_) / abs(r_) for a, r_ in zip(mine, ref))
        return loss, train._worst_leaf(grads, ref_g, list(ref_g))[0]

    loss16, grad16 = gaps("bf16")
    loss32, grad32 = gaps(None)
    assert loss16 <= 1e-5 and grad16 <= 1e-4, (loss16, grad16)
    assert grad32 >= 10 * max(grad16, 1e-6), (grad32, grad16)
