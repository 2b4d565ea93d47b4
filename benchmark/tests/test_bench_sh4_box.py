"""Degree-4 SH in the plain references and a tree box with its own radius on
each axis, on the CPU: the basis against quadrature and the port's, the
existing configurations pinned to what they read before either existed,
and a Tanks-and-Temples-shaped cell (SH25, a per-axis box, a non-square
frame) made from data files alone, whose checks pass sound runs and fail
the control and the faults it can have."""

import copy
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import port_inputs, run  # noqa: E402
from benchmark import scene as scene_lib  # noqa: E402
from benchmark.reference import octree_ref  # noqa: E402

# tt_sh25.json's tree (nerf_sh/config/tt.yaml: sh_deg 4) on the blob scene:
# the box is the scene's occupied bounds [-1.06, -0.96, -0.82] to [1.07,
# 0.86, 0.82], as an NSVF bbox.txt would give them, scaled by 1.2
# (--bbox_from_data --data_bbox_scale 1.2).
TT_TREE = {"format": "SH", "basis_dim": 25, "data_dim": 76, "depth": 8,
           "radius": [1.278, 1.092, 0.984], "center": [0.005, -0.05, 0.0],
           "occupied_sigma": 0.05, "coeff_std": 0.05, "step_size": 1e-5}
TT_CONFIG = {"name": "tt-sh25", "tree": TT_TREE, "optimize": {"sgd": True, "lr": 1.5e6}}
SMALL = {"config": {"tree": {"depth": 4}}}
CHUNKS = {"runrows": 128, "quantum": 32}
# A non-square frame on each kind of traffic the tree takes.
TT_TRAFFIC = {
    "serve-24x40": {"kind": "serve", "height": 24, "width": 40, "focal_factor": 1.8,
                    "orbit_radius": 2.2, "orbit_height": 0.8, "sigma_thresh": 0.01,
                    "stop_thresh": 0.01, "grid_c": 16, "warmup_frames": 2, "max_frames": 64,
                    "traced_units": 2, "check_frames": 2, "check_pixels": 600, **CHUNKS},
    "tileopt-24x40": {"kind": "tileopt", "height": 24, "width": 40, "focal_factor": 1.8,
                      "views": 3, "distance": 2.3409399, "elevation_deg": [10.0, 60.0],
                      "grid_c": 16, "checked_steps": 3, "warmup_steps": 0, "traced_units": 2,
                      **CHUNKS},
}
# Limits at this size, between the sound readings (serve at most 0.011;
# tileopt at most 2.6e-4) and the lowest of the control's and the faults'
# (serve 0.37; tileopt 2.3e-3) over five seeds.
TT_CELLS = {"tt-sh25-serve": ("serve-24x40", {"pixel_off_share": 0.05}),
            "tt-sh25-tileopt": ("tileopt-24x40", {"loss_gap": 1e-3, "grad_norm_gap": 1e-3,
                                                  "change_norm_gap": 1e-3})}
MAN = {"end_to_end": [], "per_layer": []}


def _parent_sh_basis(deg, d):
    """The reference's basis of degrees 0-3 as it was before degree 4."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    c0, c1, c2, c3 = (octree_ref._SH_C0, octree_ref._SH_C1, octree_ref._SH_C2,
                      octree_ref._SH_C3)
    out = [torch.full_like(x, c0)]
    if deg >= 1:
        out += [-c1 * y, c1 * z, -c1 * x]
    if deg >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out += [c2[0] * xy, c2[1] * yz, c2[2] * (2 * zz - xx - yy), c2[3] * xz,
                c2[4] * (xx - yy)]
    if deg >= 3:
        out += [c3[0] * y * (3 * xx - yy), c3[1] * xy * z, c3[2] * y * (4 * zz - xx - yy),
                c3[3] * z * (2 * zz - 3 * xx - 3 * yy), c3[4] * x * (4 * zz - xx - yy),
                c3[5] * z * (xx - yy), c3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, -1)


def _directions(n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    d = torch.randn((n, 3), generator=g, dtype=torch.float64)
    return (d / d.norm(dim=-1, keepdim=True)).to(dtype)


def test_sh_basis_degree_4_is_orthonormal_on_the_sphere():
    """Gauss-Legendre in cos(theta) x uniform phi, exact to degree 8."""
    ct, wt = np.polynomial.legendre.leggauss(12)
    phi = 2.0 * np.pi * np.arange(24) / 24
    st = np.sqrt(1.0 - ct ** 2)
    d = np.stack([st[:, None] * np.cos(phi), st[:, None] * np.sin(phi),
                  np.broadcast_to(ct[:, None], (12, 24))], -1).reshape(-1, 3)
    w = torch.as_tensor(np.repeat(wt, 24) * (2.0 * np.pi / 24))
    b = octree_ref.sh_basis(4, torch.as_tensor(d))
    gram = (b * w[:, None]).T @ b
    assert b.shape == (288, 25)
    assert float((gram - torch.eye(25, dtype=torch.float64)).abs().max()) < 1e-12


def test_sh_basis_degree_4_equals_the_ports():
    from plenoctree_tpu_torch.ops.sh import sh_basis

    d = _directions(4096, torch.float64)
    for deg in range(5):
        ref = octree_ref.sh_basis(deg, d)
        assert float((ref - sh_basis(deg, d)).abs().max()) < 1e-12, deg
    with pytest.raises(ValueError):
        octree_ref.sh_basis(5, d)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_sh_basis_to_degree_3_is_bitwise_what_it_was(dtype):
    d = _directions(4096, dtype, seed=1)
    for deg in range(4):
        assert torch.equal(octree_ref.sh_basis(deg, d), _parent_sh_basis(deg, d)), deg


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("radius", [1.2, 1, 0.875, 1.0 / 3.0, 1e-3 * 7, 123.456])
def test_scalar_tree_to_world_is_bitwise_what_it_was(radius, dtype):
    t = torch.rand((4096, 3), generator=torch.Generator().manual_seed(2), dtype=dtype)
    center = [0.0, 0.0, 0.0] if radius == 1.2 else [0.1, -0.2, 0.3]
    before = (t - 0.5) * (2.0 * radius) + torch.as_tensor(center, dtype=t.dtype)
    assert torch.equal(scene_lib.tree_to_world(t, radius, center), before)


def test_scene_keys_of_the_existing_configurations_are_pinned():
    """The topology cache (build/bench_cache) of every existing cell keeps
    its key, so no cell rebuilds its tree in set-up."""
    want = {"sh16": "7c831dd8cbc10a9e", "sg25": "7c831dd8cbc10a9e",
            "sh16-d8": "ff687b2387c80de1"}
    for name, key in want.items():
        cfg = run.load_json(ROOT, "benchmark", "configs", f"{name}.json")
        assert scene_lib.scene_key(cfg) == key, name


def test_per_axis_tree_to_world():
    t = torch.tensor([[0.0, 0.5, 1.0], [0.25, 0.75, 0.5]])
    w = scene_lib.tree_to_world(t, [2.0, 1.0, 0.5], [1.0, 0.0, -1.0])
    assert torch.allclose(w, torch.tensor([[-1.0, 0.0, -0.5], [0.0, 0.5, -1.0]]))


def test_per_axis_box_port_tree_and_reference_hold_the_same_leaves(tmp_path, monkeypatch):
    """The port's tree and the reference's Scene of a per-axis box: the same
    leaf rows, each at the same world position by each side's own transform,
    and inside the box on each axis."""
    monkeypatch.setattr(port_inputs, "CACHE_DIR", str(tmp_path))
    cfg = copy.deepcopy(TT_CONFIG)
    cfg["tree"]["depth"] = 4
    dev = torch.device("cpu")
    tree, n = port_inputs.scene_tree(cfg, 5, dev)
    sc = scene_lib.reference_scene(cfg, 5, dev, torch.float32)
    assert n == sc.data.shape[0] > 100
    assert np.allclose(tree.invradius, 0.5 / np.asarray(TT_TREE["radius"]))

    leaves = tree._leaf_nodes()
    size = tree._cell_size(leaves)
    fine = np.isclose(size, 1.0 / sc.res)
    rows = tree.data[tuple(leaves[fine].T)]
    port_world = tree.tree2world(tree._cell_corner(leaves[fine]) + size[fine, None] / 2)
    assert rows.shape[0] == n

    ids = torch.nonzero(sc.grid >= 0).squeeze(1)
    ijk = torch.stack([ids // sc.res ** 2, ids // sc.res % sc.res, ids % sc.res], -1)
    invr = 0.5 / sc.radius
    offset = 0.5 * (1.0 - sc.center / sc.radius)
    ref_world = (((ijk.double() + 0.5) / sc.res) - offset) / invr
    ref_rows = sc.data[sc.grid[ids].long()].numpy()
    where = {r.tobytes(): i for i, r in enumerate(ref_rows)}
    match = np.array([where[r.tobytes()] for r in rows])
    assert sorted(match) == list(range(n))
    gap = np.abs(port_world - ref_world.numpy()[match]).max()
    assert gap < 1e-5, gap
    r, c = np.asarray(TT_TREE["radius"]), np.asarray(TT_TREE["center"])
    assert (np.abs(port_world - c) < r).all()


@pytest.fixture
def tt_bench(tmp_path, monkeypatch):
    """A copy of the benchmark's data with a tt-shaped configuration, its
    traffic files and cells added, no file edited."""
    bench = tmp_path / "benchmark"
    for part in ("workloads", "configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "benchmark", part), bench / part)
    (bench / "configs" / "tt-sh25.json").write_text(json.dumps(TT_CONFIG))
    for name, traffic in TT_TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for cell, (traffic, limits) in TT_CELLS.items():
        (bench / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": "tt-sh25", "traffic": traffic, "chips": 1, "limits": limits}))
    monkeypatch.setattr(run, "BENCH", str(bench))
    monkeypatch.setattr(port_inputs, "CACHE_DIR", str(tmp_path / "cache"))
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return bench


def _execute(cell, seed, **kw):
    return run.execute(cell, seed, 0.0, False, torch.device("cpu"), manifest=MAN,
                       overrides=SMALL, **kw)


@pytest.mark.parametrize("cell", sorted(TT_CELLS))
@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_tt_shaped_cell_sound_runs_are_correct(cell, seed, tt_bench):
    out = _execute(cell, seed)
    assert out["correct"], out["checks"]


def _zero_degree_4(real):
    def scene_tree(cfg, seed, device):
        tree, n = real(cfg, seed, device)
        bd = cfg["tree"]["basis_dim"]
        for c in range(3):
            tree.data[..., c * bd + 16: (c + 1) * bd] = 0.0
        return tree, n
    return scene_tree


def _mean_radius(real):
    def scene_tree(cfg, seed, device):
        cfg = copy.deepcopy(cfg)
        cfg["tree"]["radius"] = float(np.mean(cfg["tree"]["radius"]))
        return real(cfg, seed, device)
    return scene_tree


TT_FAULTS = {"serve": ["bf16", "alter", "zero_degree_4", "mean_radius"],
             "tileopt": ["bf16", "frozen", "half", "zero_degree_4", "mean_radius"]}
TT_CASES = [(c, f) for c in sorted(TT_CELLS) for f in TT_FAULTS[c.rsplit("-", 1)[1]]]


@pytest.mark.parametrize("cell,fault", TT_CASES, ids=[f"{c}-{f}" for c, f in TT_CASES])
def test_tt_shaped_cell_control_and_faults_are_not_correct(cell, fault, tt_bench, monkeypatch):
    """The bf16 control, the faults the traffic code plants, and a program tree
    with its nine degree-4 coefficients zeroed or built with the mean of
    the three radii."""
    planted = {"zero_degree_4": _zero_degree_4, "mean_radius": _mean_radius}
    kw = {}
    if fault in planted:
        monkeypatch.setattr(port_inputs, "scene_tree", planted[fault](port_inputs.scene_tree))
    elif fault == "bf16":
        kw["control"] = "bf16"
    else:
        kw["fault"] = fault
    out = _execute(cell, 11, **kw)
    assert not out["correct"], out["checks"]
