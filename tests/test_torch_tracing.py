"""The port's spans (plenoctree_tpu_torch/utils/tracing.py) on the CPU: off
they do nothing at all, on they nest as the layers do and land in the
profiler's trace; their counts; self time; the benchmark's readers of them."""

import collections
import contextlib
import json
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from plenoctree_tpu_torch import engine
from plenoctree_tpu_torch.data.poses import orbit_pose
from plenoctree_tpu_torch.data.rays import Rays
from plenoctree_tpu_torch.data.synthetic import build_scene_tree
from plenoctree_tpu_torch.models.nerf import get_model_state
from plenoctree_tpu_torch.octree import tile_render
from plenoctree_tpu_torch.octree.tile_opt import TileOptimizer
from plenoctree_tpu_torch.utils import tracing
from plenoctree_tpu_torch.utils.config import default_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import run as bench_run  # noqa: E402

RES, FOCAL = 33, 40.0
B, SC, SF, NPTS = 16, 4, 6, 30
FRAME_SPANS = {"tile.frame", "tile.render", "tile.inputs", "tile.composite", "tile.assemble",
               "tile.fetch"}


@pytest.fixture(scope="module")
def tree():
    return build_scene_tree(4)


def _renderer(tree):
    return tile_render.TileRenderer(tree, step_size=1e-4, sigma_thresh=0.01, stop_thresh=0.01,
                                    grid_c=16, output="u8", device="cpu")


def _train_setup():
    cfg = default_config(dataset="blender", batch_size=B, net_depth=2, net_width=16, sh_deg=1,
                         num_coarse_samples=SC, num_fine_samples=SF, sparsity_npoints=NPTS,
                         randomized=True)
    model, state = get_model_state(cfg, seed=0, restore=False, device="cpu")
    g = torch.Generator().manual_seed(3)
    o = torch.rand((B, 3), generator=g) * 0.2
    d = torch.nn.functional.normalize(torch.rand((B, 3), generator=g) - 0.5, dim=-1)
    batch = {"rays": Rays(o - 4.0 * d, d, d), "pixels": torch.rand((B, 3), generator=g)}
    return cfg, model, state, engine.make_train_step(model, cfg), batch


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _ops(fn):
    with _OpCount() as c:
        fn()
    return c.ops


@pytest.fixture
def no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(tracing._profiler, "record_function", refuse)


def _bare(monkeypatch):
    monkeypatch.setattr(tracing, "span", lambda *a, **k: contextlib.nullcontext())


def test_off_a_frame_issues_the_ops_a_bare_context_does(tree, no_record_function, monkeypatch):
    r = _renderer(tree)
    c2w = orbit_pose(0.7)
    r.render_persp(c2w, RES, RES, FOCAL)  # the caps settle
    before = tracing.window()["records"]
    traced_off = _ops(lambda: r.render_persp(c2w, RES, RES, FOCAL))
    assert tracing.window()["records"] == before
    _bare(monkeypatch)
    bare = _ops(lambda: r.render_persp(c2w, RES, RES, FOCAL))
    assert traced_off == bare and sum(bare.values()) > 100


def test_off_a_train_step_issues_the_ops_a_bare_context_does(no_record_function, monkeypatch):
    _, _, state, step, batch = _train_setup()
    step(state, batch, torch.Generator().manual_seed(1))
    before = tracing.window()["records"]
    traced_off = _ops(lambda: step(state, batch, torch.Generator().manual_seed(1)))
    assert tracing.window()["records"] == before
    _bare(monkeypatch)
    bare = _ops(lambda: step(state, batch, torch.Generator().manual_seed(1)))
    assert traced_off == bare and sum(bare.values()) > 100


def test_off_span_is_one_shared_falsy_object(no_record_function):
    a, b = tracing.span("x"), tracing.span("y", request=3, rows=5)
    assert a is b and not a
    with a as s:
        s.count(pieces=torch.ones(()))


def test_a_traced_frame_nests_and_lands_in_the_chrome_trace(tree, tmp_path):
    r = _renderer(tree)
    c2w = orbit_pose(1.3)
    r.render_persp(c2w, RES, RES, FOCAL)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render_persp(c2w, RES, RES, FOCAL)
    recs = tracing.window()["records"]
    assert {x["name"] for x in recs} == FRAME_SPANS and len(recs) == len(FRAME_SPANS)
    ids = {x["id"]: x for x in recs}
    parent = {x["name"]: ids[x["parent"]]["name"] if x["parent"] in ids else None
              for x in recs}
    assert parent == {"tile.frame": None, "tile.render": "tile.frame",
                      "tile.fetch": "tile.frame", "tile.inputs": "tile.render",
                      "tile.composite": "tile.render", "tile.assemble": "tile.render"}
    assert {x["request"] for x in recs} == {r.frames} and r.frames == 2
    for x in recs:
        assert x["t0_ns"] <= x["t1_ns"] and 0 <= x["self_s"] <= x["total_s"]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert FRAME_SPANS <= names


def test_pieces_is_the_chunks_handed_to_the_kernel(tree):
    r = _renderer(tree)
    c2w = orbit_pose(2.1)
    r.render_persp(c2w, RES, RES, FOCAL)
    idx = r.index
    fn = r.make_tile_inputs_fn(RES, RES, FOCAL, r.rcap, r.w1cap, r.ccap)
    p2_args, _, _, _ = fn(c2w, idx["csr"], idx["base"], r.extra_data, idx["blk_bbox"])
    nck = int(p2_args[0][:, 0, 0].sum())
    off = _ops(lambda: r.render_persp(c2w, RES, RES, FOCAL))
    with profile(activities=[ProfilerActivity.CPU]):
        on = _ops(lambda: r.render_persp(c2w, RES, RES, FOCAL))
    w = tracing.window()
    assert nck > 0 and w["by_name"]["tile.inputs"]["counts"] == {"pieces": nck}
    # Traced, a frame issues one more op than off (the sum), and the spans'
    # profiler ranges.
    extra = on - off
    assert not off - on and extra.pop("aten.sum.default") == 1
    assert set(extra) <= {"profiler._record_function_enter_new.default",
                          "profiler._record_function_exit._RecordFunction"}


def test_a_traced_optimizer_step(tree):
    opt = TileOptimizer(tree, step_size=1e-4, grid_c=16, device="cpu")
    leaf = opt.initial_leaf_dataT()
    c2w = orbit_pose(0.4)
    gt = np.full((RES, RES, 3), 0.5, np.float32)
    opt.loss_and_grad(leaf, c2w, gt, RES, RES, FOCAL)
    with profile(activities=[ProfilerActivity.CPU]):
        opt.loss_and_grad(leaf, c2w, gt, RES, RES, FOCAL)
    w = tracing.window()
    by = {x["id"]: x for x in w["records"]}
    step = next(x for x in w["records"] if x["name"] == "tile_opt.step")
    kids = {x["name"] for x in w["records"] if x["parent"] == step["id"]}
    assert kids == {"tile.inputs", "tile_opt.gather", "tile.composite", "tile_opt.backward"}
    assert step["request"] == opt.steps == 2
    bwd = [x for x in w["records"] if x["name"] == "tile.composite_bwd"]
    assert len(bwd) == 1
    # On the CPU autograd runs the backward on the calling thread.
    assert by[bwd[0]["parent"]]["name"] == "tile_opt.backward"


def test_a_traced_train_step_and_its_rows():
    _, _, state, step, batch = _train_setup()
    step(state, batch, torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batch, torch.Generator().manual_seed(1))
    w = tracing.window()
    recs = {x["id"]: x for x in w["records"]}
    names = {x["name"]: x for x in w["records"]}
    assert names["nerf.step"]["request"] == state.step - 1
    assert {x["request"] for x in w["records"]} == {state.step - 1}

    def parent(name):
        return recs[names[name]["parent"]]["name"]

    assert [parent(n) for n in ("nerf.forward", "nerf.backward", "nerf.update")] == [
        "nerf.step"] * 3
    assert [parent(n) for n in ("nerf.coarse", "nerf.fine", "nerf.sparsity")] == [
        "nerf.forward"] * 3
    trunk = w["by_name"]["nerf.trunk"]
    assert trunk["count"] == 3 and trunk["counts"] == {"rows": B * SC + B * (SC + SF) + NPTS}
    assert "nerf.allreduce" not in w["by_name"]


def test_self_time_on_a_nested_log():
    def rec(i, name, parent, t0, t1, **counts):
        return {"name": name, "id": i, "parent": parent, "request": 7, "t0_ns": t0,
                "t1_ns": t1, "counts": counts}

    log = [rec(1, "a", None, 0, 100), rec(2, "b", 1, 10, 40, rows=3),
           rec(3, "c", 2, 20, 30), rec(4, "b", 1, 35, 60, rows=torch.tensor(4)),
           rec(5, "d", 1, 90, 130), rec(6, "e", None, 50, None)]
    w = tracing.summarize(log)
    self_ns = {x["id"]: round(x["self_s"] * 1e9) for x in w["records"]}
    # a: 100 less b's [10, 40] and [35, 60] (50 covered) and d's part in it (10).
    assert self_ns == {1: 40, 2: 20, 3: 10, 4: 25, 5: 40}
    assert w["by_name"]["b"]["count"] == 2 and w["by_name"]["b"]["counts"] == {"rows": 7}
    assert round(w["by_name"]["b"]["total_s"] * 1e9) == 55
    assert round(w["by_name"]["b"]["self_s"] * 1e9) == 45
    assert "e" not in w["by_name"]  # never closed


def test_sessions_threads_and_the_bound(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("old"):
            pass
    with tracing.span("between"):  # off: marks the log stale
        pass
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer", request=5) as s:
            assert s
            done = []

            def worker():
                with tracing.span("worker"):
                    done.append(True)

            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive() and done
            with tracing.span("inner"):
                pass
            with tracing.span("dropped"):
                pass
    w = tracing.window()
    by = {x["name"]: x for x in w["records"]}
    assert set(by) == {"outer", "worker", "inner"} and w["dropped"] == 1
    assert by["worker"]["parent"] is None and by["worker"]["request"] is None
    assert by["inner"]["parent"] == by["outer"]["id"] and by["inner"]["request"] == 5


# -- the benchmark's readers of the program's spans ---------------------------

READERS = {
    "serve.inputs_host_ms": 1e3 * (0.004 + 0.006) / 2,
    "serve.pieces_per_frame": (100 + 140) / 2,
    "serve.inputs_idle_share": 100.0 * 0.3 / 2.0,
    "serve.fetch_idle_share": 100.0 * 0.1 / 2.0,
    "train.forward_host_ms": 1e3 * 0.020 / 2,
    "train.backward_host_ms": 1e3 * 0.010 / 2,
    "train.update_host_ms": 1e3 * 0.006 / 2,
    "train.trunk_rows_per_call": (300 + 300 + 90) * 2 / 6,
    "opt.pieces_per_step": 500 / 1,
}


def _synthetic_log():
    recs, ids = [], iter(range(1, 1000))

    def add(name, parent, t0, t1, **counts):
        i = next(ids)
        recs.append({"name": name, "id": i, "parent": parent, "request": None,
                     "t0_ns": int(t0 * 1e9), "t1_ns": int(t1 * 1e9), "counts": counts})
        return i

    for k, (dur, pieces) in enumerate(((0.004, 100), (0.006, 140))):
        f = add("tile.frame", None, k, k + 0.5)
        rr = add("tile.render", f, k, k + 0.1)
        add("tile.inputs", rr, k, k + dur, pieces=torch.tensor(pieces))
        add("tile.fetch", f, k + 0.1, k + 0.2)
    for k in range(2):
        s = add("nerf.step", None, 10 + k, 10.1 + k)
        fw = add("nerf.forward", s, 10 + k, 10 + k + 0.010)
        for rows in (300, 300, 90):
            add("nerf.trunk", fw, 10 + k, 10 + k + 0.001, rows=rows)
        add("nerf.backward", s, 10.02 + k, 10.025 + k)
        add("nerf.update", s, 10.03 + k, 10.033 + k)
    st = add("tile_opt.step", None, 20, 21)
    add("tile.inputs", st, 20, 20.1, pieces=500)
    add("tile.inputs", None, 30, 30.1, pieces=7)  # in no frame and no step
    return recs


def _view():
    gaps = {"tile.inputs | aten::mul": 0.2, "tile.inputs | no op": 0.1,
            "tile.fetch | aten::copy_": 0.1, "serve.render_persp | no op": 0.5}
    return types.SimpleNamespace(summary=types.SimpleNamespace(gaps=gaps, window_s=2.0))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_of_program_spans(metric, monkeypatch):
    read = bench_run.load_reader(metric)
    monkeypatch.setattr(tracing, "window", lambda: tracing.summarize([]))
    assert read(_view()) is None
    log = _synthetic_log()
    monkeypatch.setattr(tracing, "window", lambda: tracing.summarize(log))
    assert read(_view()) == pytest.approx(READERS[metric], rel=1e-9)


def test_every_span_reader_is_in_the_manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        want = "device_trace" if "idle" in name else (
            "program_counter" if ("pieces" in name or "rows" in name) else "program_span")
        assert m["source"] == want, name
