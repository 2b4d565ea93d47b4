"""What the readers of the program's own spans share.

The port records spans at its layer boundaries while a profiler runs
(plenoctree_tpu_torch/utils/tracing.py); after the traced window its
`window()` holds that window's span records (name, id, parent's id,
duration, counts), and the trace's idle gaps are labelled by the innermost
of them open when the gap began. A program without that module, or one
that recorded no span of the unit (a frame or a step) asked for, gives
None: the metric is then left out of the line.
"""


def _inside(unit, name):
    """(the `name` records that are a `unit` record or lie inside one, the
    number of `unit` records), or None where there is no `unit` record."""
    try:
        from plenoctree_tpu_torch.utils import tracing
    except ImportError:
        return None
    recs = tracing.window()["records"]
    units = {r["id"] for r in recs if r["name"] == unit}
    if not units:
        return None
    by_id = {r["id"]: r for r in recs}
    out = []
    for r in recs:
        p = r if r["name"] == name else None
        while p is not None and p["id"] not in units:
            p = by_id.get(p["parent"])
        if p is not None:
            out.append(r)
    return out, len(units)


def host_ms_per_unit(unit, name):
    """ms of host time in the `name` spans (their whole duration) per `unit`
    span."""
    got = _inside(unit, name)
    if not got or not got[0]:
        return None
    recs, n = got
    return 1e3 * sum(r["total_s"] for r in recs) / n


def count_per_unit(unit, name, key):
    """The sum of the `key` counts of the `name` spans per `unit` span."""
    got = _inside(unit, name)
    if not got or not any(key in r["counts"] for r in got[0]):
        return None
    recs, n = got
    return sum(r["counts"].get(key, 0) for r in recs) / n


def idle_share(view, unit, name):
    """Share of the traced window, in %, that falls in idle gaps that began
    inside a `name` span (as its innermost span)."""
    if _inside(unit, name) is None or view.summary.window_s <= 0:
        return None
    idle = sum(s for k, s in view.summary.gaps.items() if k.split(" | ")[0] == name)
    return 100.0 * idle / view.summary.window_s
