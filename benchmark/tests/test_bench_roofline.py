"""The yardstick's arithmetic on hand-worked cases: least times, the trunk's
model FLOPs, the tile kernels' work, the trace reduction and the tail."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import roofline, trace  # noqa: E402


def test_least_time_takes_the_larger_bound():
    assert roofline.least_time(989e12, 0.0, roofline.BF16_FLOPS) == pytest.approx(1.0)
    assert roofline.least_time(1.0, 3.35e12, roofline.BF16_FLOPS) == pytest.approx(1.0)
    assert roofline.least_time(67e12, 3.35e12 * 2, roofline.F32_FLOPS) == pytest.approx(2.0)


def test_trunk_macs_by_hand():
    # 63x256, four 256x256, (256 + 63)x256 after the skip, two 256x256, heads 256 x (1 + 48)
    want = 63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256 + 256 * 49
    assert want == 503552
    assert roofline.trunk_macs(63, 256, 8, 4, 1, 48) == want
    assert roofline.trunk_params(63, 256, 8, 4, 1, 48) == want + 8 * 256 + 49


def test_train_step_flops_count_the_backward_twice():
    model = {"max_deg_point": 10, "min_deg_point": 0, "sh_deg": 3, "net_width": 256,
             "net_depth": 8, "skip_layer": 4, "num_coarse_samples": 64,
             "num_fine_samples": 128, "sparsity_npoints": 10000}
    flops, nbytes = roofline.train_step_work(model, 4096)
    rows = 4096 * 64 + 4096 * 192 + 10000
    assert flops == pytest.approx(2 * 503552 * rows * 3)
    assert flops / roofline.BF16_FLOPS == pytest.approx(3.2e-3, rel=0.02)  # ~3.2 ms a step
    assert nbytes / roofline.HBM_BYTES_PER_S < flops / roofline.BF16_FLOPS


def test_tile_work_by_hand():
    c = {"pairs": 1000, "leaves": 10, "rays": 4}
    flops, nbytes = roofline.tile_fwd_work(c, basis_dim=16, n_channels=3, data_dim=49)
    assert flops == 1000 * (12 + 3 * 34 + 8)
    assert nbytes == 4 * (10 * 55 + 4 * 4)
    bflops, bbytes = roofline.tile_bwd_work(c, basis_dim=16, n_channels=3, data_dim=49)
    assert bflops == flops + 1000 * (2 * 3 * 16 + 10)
    assert bbytes == 4 * (10 * (6 + 98) + 4 * 8)
    assert roofline.sgd_update_bytes(5) == 60


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_union_launches_and_gaps():
    """Window 0..100 us: kernels 10-30 and 20-40 overlap (busy 30 us once),
    a copy 60-70; three launch calls, one kernel without a launch call;
    gaps 0-10, 40-60 and 70-100 named by the innermost span and op."""
    ev = [
        _ev("user_annotation", trace.WINDOW, 0, 100),
        _ev("user_annotation", "serve.render_persp", 0, 50),
        _ev("cpu_op", "aten::add", 35, 30),
        _ev("cpu_op", "aten::item", 38, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 15, 1, corr=2),
        _ev("cuda_driver", "cuLaunchKernel", 16, 1, corr=3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 55, 1, corr=4),
        _ev("kernel", "(anonymous namespace)::fwd_kernel(Net)", 10, 20, corr=1),
        _ev("kernel", "void (anonymous namespace)::tile_composite_kernel<2>(Params)", 20, 20,
            corr=2),
        _ev("kernel", "(anonymous namespace)::atb_kernel(Net)", 70, 0, corr=9),
        _ev("gpu_memcpy", "Memcpy HtoD", 60, 10, corr=4),
    ]
    s = trace.summarize({"traceEvents": ev})
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(40e-6)
    assert s.launches == 4
    assert s.kernel_s("tile_composite_kernel") == pytest.approx(20e-6)
    assert s.kernel_s("fwd_kernel", "atb_kernel") == pytest.approx(20e-6)
    assert s.kernel_s("composite_kernel", "fwd") == 0.0  # whole names only
    assert s.gaps == pytest.approx({"serve.render_persp | no op": 10e-6,
                                    "serve.render_persp | aten::item": 20e-6,
                                    "no span | no op": 30e-6})
    b = s.breakdown()
    assert b["device_ops"][0][0] == "(anonymous namespace)::fwd_kernel(Net)"
    assert len(b["idle_gaps"]) == 3


def test_frame_tail_is_the_95th_percentile_of_all_frames():
    from benchmark.traffic import serve

    d = serve.Driver.__new__(serve.Driver)
    d.frames = [None] * 100
    d.lat = [k / 1000.0 for k in range(1, 101)]  # 1 .. 100 ms
    d.window_s = 5.05
    e2e, n, failed = d.end_to_end()
    assert n == 100 and failed == 0
    assert e2e["frame_ms"] == pytest.approx(50.5)
    assert e2e["frame_ms_p95"] == pytest.approx(float(np.percentile(np.arange(1, 101), 95)))
