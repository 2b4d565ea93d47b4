"""utils/graphs.py's capture policy on the CPU: the key sequences of the GPU
tests (tests/test_torch_gpu.py's replayed frames and train steps) played
through `Policy` with plain objects as graphs, and the launch counters that
a capture takes back and a replay adds (kernels/__init__.py)."""

import pytest

from plenoctree_tpu_torch import kernels
from plenoctree_tpu_torch.kernels import fused_mlp
from plenoctree_tpu_torch.kernels import tile_composite as K
from plenoctree_tpu_torch.utils.graphs import Policy

CAP, REP = {"captures": 1}, {"replays": 1}


class _Span:
    """What Policy.attempt counts on: a traced span's `count`."""

    def __init__(self):
        self.counts = {}

    def count(self, **counts):
        self.counts.update(counts)


# (keep, the attempts' keys, each attempt's counts, graphs held after each)
CASES = {
    # A renderer (one graph): 8 orbit frames under caps A, a far pose whose
    # attempt under A replays and grows the caps, its re-render under B
    # (never seen: eager, A's graph let go), then 4 more frames under B.
    "renderer_orbit_then_regrowth": (
        1, "AAAAAAAA" "A" "B" "BBBB",
        [{}, CAP] + [REP] * 6 + [REP] + [{}] + [CAP] + [REP] * 3,
        [0] + [1] * 8 + [0] + [1] * 4),
    # A viewer whose focal changes every frame: nothing captured or held.
    "renderer_focal_never_comes_back": (1, "ABCD", [{}] * 4, [0] * 4),
    # A key captures only after an eager attempt just before it under it.
    "renderer_key_between": (1, "AAABAA", [{}, CAP, REP, {}, {}, CAP], [0, 1, 1, 0, 0, 1]),
    # A train step (two graphs): full batch x 3, half x 3, full again.
    "engine_half_batch_after_full": (
        2, "FFF" "HHH" "F", [{}, CAP, REP, {}, CAP, REP, REP], [0, 1, 1, 1, 2, 2, 2]),
    # A state restored before the fourth step: new moments, a new key.
    "engine_restore_between_steps": (
        2, "FFF" "RRR", [{}, CAP, REP, {}, CAP, REP], [0, 1, 1, 1, 2, 2]),
    # Two held and a third key: the least recently used goes at once.
    "third_key_lets_one_go": (
        2, "AABBCCA", [{}, CAP, {}, CAP, {}, CAP, {}], [0, 1, 1, 2, 1, 2, 1]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_policy_captures_and_replays_as_the_callers_count(case):
    keep, keys, want_counts, want_held = CASES[case]
    policy = Policy(keep)
    counts, held, captured = [], [], []
    for key in keys:
        span = _Span()
        graph = policy.attempt(key, lambda: captured.append(key) or object(), span)
        counts.append(span.counts)
        held.append(len(policy.graphs))
        if span.counts:  # a replay or a capture: the key's graph, the last used
            assert graph is policy.graphs[key] and next(reversed(policy.graphs)) == key
        else:
            assert graph is None and key not in policy.graphs
    assert counts == want_counts
    assert held == want_held
    assert captured == [k for k, c in zip(keys, counts) if c == CAP]


def test_the_launch_counters_move_together():
    """kernels.add_launch_counts moves the counters launch_counts reads, the
    modules' own: back and forth by one delta they end where they began."""
    before = kernels.launch_counts()
    assert ("fused_mlp", "fwd_launches") in before and ("tile_composite", "launches") in before
    delta = {k: i + 1 for i, k in enumerate(before)}
    kernels.add_launch_counts(delta)
    try:
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in before} == delta
        assert K.launches == before[("tile_composite", "launches")] + delta[
            ("tile_composite", "launches")]
        assert fused_mlp.fwd_launches == before[("fused_mlp", "fwd_launches")] + delta[
            ("fused_mlp", "fwd_launches")]
    finally:
        kernels.add_launch_counts({k: -d for k, d in delta.items()})
    assert kernels.launch_counts() == before
