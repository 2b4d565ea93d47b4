"""Spans and counts at the port's layer boundaries, recorded while a torch
profiler runs.

    with tracing.span("nerf.trunk", rows=n):      # a host count
        ...
    with tracing.span("tile.inputs") as s:
        ...
        if s:  # on: a count that needs device work is made only then
            s.count(pieces=nck.sum())

Off (no torch profiler active), `span` returns one shared object that does
nothing: it enters no record_function, issues no torch op, allocates
nothing and is false. On, a span enters
torch.profiler.record_function(name), so it lands in the profiler's Chrome
trace on the profiler's clock beside the device's kernels, and appends a
record to an in-memory log: its name, id, parent's id, request id, host
start and end (time.perf_counter_ns) and counts. Parents are kept per
thread, so a span opened on autograd's worker thread (the tile backward's)
has none; a span without a request id takes its parent's.

Counts are host numbers or 0-d device tensors, read only by `window()`. The
log holds at most MAX_RECORDS records; later ones are counted as dropped. A
traced session starts at the first span recorded after tracing was off,
which clears the previous session's log.

`window()` reads the session: every record with its counts resolved and its
self time (its duration less the part of it that its children cover), and
by span name the count, total and self seconds and the sums of the counts.
Measured cost off (torch 2.13 on the CPU, 100,000 calls): a bare
record_function entered and left, 11.7 us; `span`, 0.67 us (0.83 us with
one count); contextlib.nullcontext, 0.82 us.
"""

import itertools
import threading
import time

from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 16


class _Off:
    """What `span` returns with tracing off: a context that does nothing."""

    __slots__ = ()

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts):
        pass


_OFF = _Off()


class _Log:
    """The records of the current session, shared by every thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records = []
        self.dropped = 0
        self.stale = True  # set by a span with tracing off
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self):
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_log = _Log()


class _Span:
    __slots__ = ("name", "request", "counts", "rec", "rf")

    def __init__(self, name, request, counts):
        self.name, self.request, self.counts = name, request, counts
        self.rec = None

    def __bool__(self):
        return True

    def __enter__(self):
        stack = _log.stack()
        parent = stack[-1] if stack else None
        request = self.request
        if request is None and parent is not None:
            request = parent["request"]
        rec = {"name": self.name, "id": next(_log.ids),
               "parent": None if parent is None else parent["id"], "request": request,
               "t0_ns": None, "t1_ns": None, "counts": self.counts}
        with _log.lock:
            if _log.stale:
                _log.records, _log.dropped, _log.stale = [], 0, False
            if len(_log.records) < MAX_RECORDS:
                _log.records.append(rec)
            else:
                _log.dropped += 1
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        stack.append(rec)
        self.rec = rec
        rec["t0_ns"] = time.perf_counter_ns()
        return self

    def count(self, **counts):
        """Add counts to this span (host numbers or 0-d device tensors)."""
        c = self.rec["counts"]
        for k, v in counts.items():
            c[k] = c[k] + v if k in c else v  # a first count issues no op

    def __exit__(self, *exc):
        self.rec["t1_ns"] = time.perf_counter_ns()
        _log.stack().pop()
        self.rf.__exit__(*exc)
        return False


def span(name, request=None, **counts):
    """A context manager around one layer's work; see the module docstring.
    `request` ties the spans of one frame or step together (children
    inherit it)."""
    if not _profiler._is_profiler_enabled:
        _log.stale = True
        return _OFF
    return _Span(name, request, counts)


def _number(v):
    return v.item() if hasattr(v, "item") else v


def summarize(records, dropped=0):
    """{"records", "by_name", "dropped"} of closed span records (dicts as
    `span` writes them); see `window`."""
    recs = [dict(r, counts={k: _number(v) for k, v in r["counts"].items()})
            for r in records if r["t1_ns"] is not None]
    children = {}
    for r in recs:
        if r["parent"] is not None:
            children.setdefault(r["parent"], []).append((r["t0_ns"], r["t1_ns"]))
    by_name = {}
    for r in recs:
        t0, t1 = r["t0_ns"], r["t1_ns"]
        covered, end = 0, t0
        for s, e in sorted(children.get(r["id"], ())):
            s, e = max(s, end), min(e, t1)
            if e > s:
                covered += e - s
                end = e
        r["total_s"] = (t1 - t0) * 1e-9
        r["self_s"] = (t1 - t0 - covered) * 1e-9
        agg = by_name.setdefault(r["name"], {"count": 0, "total_s": 0.0, "self_s": 0.0,
                                             "counts": {}})
        agg["count"] += 1
        agg["total_s"] += r["total_s"]
        agg["self_s"] += r["self_s"]
        for k, v in r["counts"].items():
            agg["counts"][k] = agg["counts"].get(k, 0) + v
    return {"records": recs, "by_name": by_name, "dropped": dropped}


def per_unit(by_name, units):
    """{span name: {"count", "total_ms", "self_ms", "counts"}} per unit (a
    frame, a step) of a `by_name` as `summarize` gives it, over `units`."""
    return {
        name: {"count": a["count"] / units, "total_ms": 1e3 * a["total_s"] / units,
               "self_ms": 1e3 * a["self_s"] / units,
               "counts": {k: v / units for k, v in a["counts"].items()}}
        for name, a in sorted(by_name.items())
    }


def window():
    """The current traced session: its closed records, each with its counts
    resolved (a device count is read here) and `total_s` / `self_s`; by span
    name {"count", "total_s", "self_s", "counts": {name: sum}}; and the
    number of records dropped past MAX_RECORDS."""
    with _log.lock:
        records, dropped = list(_log.records), _log.dropped
    return summarize(records, dropped)
