"""The traced window: a torch.profiler trace of the device and the host, read
into what the per-layer metric readers and the breakdown need.

Spans come from the benchmark's own files (`span`, a record_function around
each call into a layer). From the trace's chrome export:
  * device operations: kernels, copies and sets, as intervals on the device;
    `busy_s` is the length of their union inside the window (overlapping
    kernels count once), `idle_s` the rest of the window;
  * launches: the host's kernel- and graph-launch calls (runtime or driver
    API), one each, plus any kernel the trace shows no launch call for;
  * idle gaps: each stretch of the window with no device operation, named
    by the innermost benchmark span and the innermost operator the host
    was in when it began.
"""

import contextlib
import json
import os
import sys
import tempfile
import time

import torch

WINDOW = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_NAMES = ("LaunchKernel", "GraphLaunch", "cuLaunch", "LaunchCooperativeKernel")


def span(name):
    return torch.profiler.record_function(name)


class Stages:
    """Host-clock seconds of a driver's set-up stages, logged to stderr."""

    def __init__(self, what):
        self.what, self.t = what, time.perf_counter()

    def __call__(self, stage):
        now = time.perf_counter()
        print(f"benchmark: {self.what} {stage} {now - self.t:.2f} s", file=sys.stderr, flush=True)
        self.t = now


@contextlib.contextmanager
def traced():
    """Profile the block; yields a holder whose .summary is set on exit."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Traced", (), {})()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with span(WINDOW):
            yield holder
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        holder.host_window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        holder.summary = summarize(_load(path))
    finally:
        os.remove(path)


def _load(path):
    with open(path) as f:
        return json.load(f)


def _union(intervals):
    """Merged, sorted [(start, end)] of intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Summary:
    """The window's device and host activity (times in seconds)."""

    def __init__(self, window_s, busy_s, launches, kernels, gaps):
        self.window_s = window_s
        self.busy_s = busy_s
        self.launches = launches
        self.kernels = kernels  # name -> device seconds (summed)
        self.gaps = gaps  # "span | op" -> idle seconds (summed)

    def kernel_s(self, *names):
        """Device seconds of the kernels whose function name (without its
        namespaces, template and argument lists) is one of names."""
        def base(k):
            k = k.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            return k.split("::")[-1].strip().split(" ")[-1]

        return sum(t for k, t in self.kernels.items() if base(k) in names)

    def breakdown(self):
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def summarize(trace):
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernels, launch_corr, kernel_corr = [], {}, set(), []
    spans, ops = [], []
    launches = 0
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if ts + dur < w0 or ts > w1:
            continue
        if cat in _DEVICE_CATS:
            s, t = max(ts, w0), min(ts + dur, w1)
            if t > s:
                dev.append((s, t))
                key = name if cat == "kernel" else cat
                kernels[key] = kernels.get(key, 0.0) + (t - s) * 1e-6
            if cat == "kernel":
                kernel_corr.append(e.get("args", {}).get("correlation"))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if any(n in name for n in _LAUNCH_NAMES):
                launches += 1
                launch_corr.add(e.get("args", {}).get("correlation"))
        elif cat == "user_annotation" and name != WINDOW:
            spans.append((ts, ts + dur, name))
        elif cat == "cpu_op":
            ops.append((ts, ts + dur, name))
    launches += sum(1 for c in kernel_corr if c is None or c not in launch_corr)
    busy = _union(dev)
    busy_us = sum(e - s for s, e in busy)
    gaps = {}
    prev = w0
    in_span, in_op = _Innermost(spans), _Innermost(ops)
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            label = f"{in_span(prev) or 'no span'} | {in_op(prev) or 'no op'}"
            gaps[label] = gaps.get(label, 0.0) + (s - prev) * 1e-6
        prev = max(prev, e)
    return Summary((w1 - w0) * 1e-6, busy_us * 1e-6, launches, kernels, gaps)


class _Innermost:
    """Name of the shortest interval holding time t, for t that never
    decreases from one call to the next (a sweep over start-sorted
    intervals, keeping those that have begun and not ended)."""

    def __init__(self, intervals):
        self.items = sorted(intervals)
        self.next = 0
        self.active = []

    def __call__(self, t):
        while self.next < len(self.items) and self.items[self.next][0] <= t:
            self.active.append(self.items[self.next])
            self.next += 1
        self.active = [iv for iv in self.active if iv[1] >= t]
        best = min(self.active, key=lambda iv: iv[1] - iv[0], default=None)
        return None if best is None else best[2]
