"""Capture and replay of the port's CUDA graphs, on one CUDA device.

The served frame (octree/tile_render.py) and the train step (engine.py)
capture their device work as CUDA graphs once it comes back under one key
and replay it after, bitwise the eager work. What that takes is here:

  * `Policy`: which attempt captures, replays or runs eagerly, by the
    caller's key (what the captured work depends on besides the values a
    replay copies in). Pure Python; the caller makes the graphs it holds.
  * `Pinned`: host values a replay copies in (a frame's pose, a step's
    Adam scalars) through a pinned buffer.
  * `Phases`: the captured work, one graph per phase in one memory pool,
    each replayed in a span of its phase's name. A replay counts what the
    capture recorded: the spans with counts that the capture opened (the
    trunk's `nerf.trunk` rows), re-emitted in the phase's span, or added to
    it where the span is the phase's own (`tile.composite`'s `reg_basis`),
    and the kernel launches, which the capture takes back from kernels/'s
    counters (a capture launches nothing) and every replay adds again.

The caller decides whether graphs are used at all: the CPU, a mesh, a
process group and a model axis hold no Policy and run eagerly.
"""

import collections

import torch

from plenoctree_tpu_torch import kernels
from plenoctree_tpu_torch.utils import tracing


class Policy:
    """Which attempts capture, replay or run eagerly, by key.

    An attempt under a key that holds a graph replays it, and the key
    becomes the most recently used. Under any other key, when `keep` graphs
    are held, the least recently used one goes (its graphs and memory pool
    are freed); then the attempt captures if its key was the key of one of
    the last `keep` eager attempts, and otherwise runs eagerly and is
    recorded as one. So only a key that comes back pays for a capture, and
    the eager attempt before a capture is its warm-up: it builds what the
    work builds lazily (kernel libraries, constants, workspaces)."""

    def __init__(self, keep):
        self.keep = keep
        self.graphs = collections.OrderedDict()  # key -> graph, the last used last
        self._eager = collections.deque(maxlen=keep)  # the last eager attempts' keys

    def attempt(self, key, capture, span):
        """The graph an attempt under `key` replays, counted on `span` (a
        tracing span) as `replays`; or the one capture() makes now, held
        under key and counted as `captures`; or None: run eagerly."""
        if key in self.graphs:
            self.graphs.move_to_end(key)
            span.count(replays=1)
            return self.graphs[key]
        if len(self.graphs) >= self.keep:
            self.graphs.popitem(last=False)
        if key not in self._eager:
            self._eager.append(key)
            return None
        span.count(captures=1)
        graph = self.graphs[key] = capture()
        return graph


class Pinned:
    """Host f32 values a replay reads: a pinned buffer, its device twin
    `dev` (what the captured work reads) and the event that guards
    rewriting the pinned one."""

    def __init__(self, shape, device):
        self.host = torch.zeros(shape, dtype=torch.float32, pin_memory=True)
        self.dev = torch.zeros(shape, dtype=torch.float32, device=device)
        self.copied = torch.cuda.Event()

    def put(self, values):
        """Enqueue the copy of `values` into `dev` on the device's current
        stream. Waits first until the device has begun the last put's copy:
        the host runs at most one replay ahead."""
        self.copied.synchronize()
        self.host.numpy()[...] = values
        self.dev.copy_(self.host, non_blocking=True)
        self.copied.record(torch.cuda.current_stream(self.dev.device))


class Phases:
    """Work on one CUDA device captured as CUDA graphs, one per phase, in one
    memory pool; see the module docstring.

    `phases` is [(span name, fn) or (span name, fn, hook)]: fn(*the outputs
    of the phases before it) -> its outputs, kept in `outs` as the static
    buffers every replay rewrites; hook(span, its outputs), where given,
    adds counts to the phase's span on a traced replay. `generators` (those
    the first phase draws from) are registered with its graph, so that a
    replay draws what the eager work draws from their state. Capture only
    after the work ran eagerly on the device: a capture runs nothing. The
    fns are not kept, so the graphs hold no reference to their caller."""

    def __init__(self, device, phases, generators=()):
        self.device, self.outs, self.spans = device, [], []
        self.graphs = [torch.cuda.CUDAGraph() for _ in phases]
        for g in generators:
            self.graphs[0].register_generator_state(g)
        before = kernels.launch_counts()
        with torch.cuda.device(device):
            pool = torch.cuda.graph_pool_handle()
            for graph, (name, fn, *hook) in zip(self.graphs, phases):
                with tracing.tape() as tape, torch.cuda.graph(graph, pool=pool):
                    self.outs.append(fn(*self.outs))
                self.spans.append((name, [(n, c) for n, c in tape if c], hook))
        self.launches = {k: n - before[k] for k, n in kernels.launch_counts().items()}
        kernels.add_launch_counts({k: -d for k, d in self.launches.items()})

    def replay(self):
        """Enqueue every phase, each in its span; returns `outs`."""
        with torch.cuda.device(self.device):
            for graph, (name, spans, hook), out in zip(self.graphs, self.spans, self.outs):
                with tracing.span(name) as s:
                    graph.replay()
                    if s:
                        for child, counts in spans:
                            if child == name:
                                s.count(**counts)
                                continue
                            with tracing.span(child, **counts):
                                pass
                        for h in hook:
                            h(s, out)
        kernels.add_launch_counts(self.launches)
        return self.outs
