"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name; a cell added from files alone runs."""

import json
import os
import re
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_and_paths(manifest):
    assert set(manifest) == TOP_KEYS
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells fits the driver's budget at this length.
    assert 2 * (rs + 60) + 24 * (14 * (rs + 60) + 2 * 90) + 1200 <= 43200


def test_names_units_and_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and "\n" not in w["why"]
        names += [w["name"], w["config"], w["traffic"]]
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in manifest["end_to_end"])


def test_every_moves_points_at_a_reported_metric(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    reports = {c: {m["name"] for m in run.cell_metrics(manifest, c, "end_to_end")}
               for c in cells}
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in manifest["end_to_end"]}
        for c in m.get("workloads", sorted(cells)):
            assert c in cells and m["moves"] in reports[c], (m["name"], c)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())  # one spelling per layer
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
        assert run.cell_metrics(manifest, c, "per_layer")


def test_every_cell_file_found_by_name(manifest):
    kinds = set()
    for w in manifest["workloads"]:
        cell, config, traffic = run.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", f"{traffic['kind']}.py"))
        assert cell["limits"]
        kinds.add(traffic["kind"])
    for m in manifest["per_layer"]:
        assert callable(run.load_reader(m["name"]))
    assert kinds == {"serve", "train", "tileopt"}


def test_a_cell_added_from_files_alone_runs(tmp_path, monkeypatch):
    """A new cell: one workload file and one traffic file in a copy of the
    benchmark's data, no file edited; it runs (on the CPU, at a small size)
    and reports the metrics the manifest lists for it."""
    import torch

    bench = tmp_path / "benchmark"
    for part in ("workloads", "configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "benchmark", part), bench / part)
    (bench / "traffic" / "serve-tiny.json").write_text(json.dumps({
        "kind": "serve", "height": 33, "width": 33, "focal_factor": 2.0, "orbit_radius": 2.2,
        "orbit_height": 0.8, "sigma_thresh": 0.01, "stop_thresh": 0.01, "grid_c": 16,
        "warmup_frames": 2, "max_frames": 64, "traced_units": 2, "check_frames": 2,
        "check_pixels": 300}))
    (bench / "workloads" / "sh16-serve-tiny.json").write_text(json.dumps({
        "config": "sh16", "traffic": "serve-tiny", "chips": 1,
        "limits": {"pixel_off_share": 0.05}}))
    monkeypatch.setattr(run, "BENCH", str(bench))
    manifest = {"end_to_end": [{"name": "frame_ms", "unit": "ms", "workloads": ["sh16-serve-tiny"]},
                               {"name": "setup_s", "unit": "s"}], "per_layer": []}
    out = run.execute("sh16-serve-tiny", 2**31 + 101, 0.2, False, torch.device("cpu"),
                      manifest=manifest, overrides={"config": {"tree": {"depth": 4}}})
    assert set(out["metrics"]) == {"frame_ms", "setup_s"}
    assert out["attempted"] >= 1 and list(out)[-1] == "checks"
