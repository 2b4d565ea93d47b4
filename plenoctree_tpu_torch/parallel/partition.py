"""Tensor parallelism over the mesh's "model" axis: the port's counterpart
of plenoctree_tpu/parallel/partition.py.

The rule is the JAX package's: every Dense `kernel` [in, out] whose `out`
divides by the model-axis size is column-sharded (each rank of a model
group keeps `out / model` columns), and its `bias` likewise; everything
else (narrow heads, the SG head's parameters) is replicated. Specs are
tuples that compare equal to the JAX PartitionSpecs: (None, "model") for a
kernel, ("model",) for a bias, () for a replicated leaf.

Where JAX's GSPMD inserts the collectives, the port writes them:

  * plain path: a column-parallel linear on the rank's slice, then an
    all-gather of the output columns over the model group at every layer
    boundary (so the skip concat and the heads see whole activations). Its
    backward hands each rank its own columns of the output gradient; the
    input gradient, a sum over the model group's columns, is completed by
    an all-reduce where the input enters (`_CopyIn`);
  * fused path (--use_pallas): GSPMD does not partition a Pallas call, so
    the kernels see whole weights; the port gathers a trunk's weight
    columns the same way, in one all-reduce per call, and runs the fused
    kernels unchanged, each rank keeping its own columns of the weight
    gradients;
  * the weight decay sums the squares of every rank's columns over the
    model group.

Every rank of a model group computes the same whole activations, losses and
replicated gradients, so a sharded leaf's gradient is the matching columns
of the one-process gradient (to the order of its sums), and the data-axis
average then runs per slice (engine.make_train_step). A gather is
mesh.all_gather: an all-reduce of a zero-filled buffer (exact), which gloo
runs on CUDA tensors.
"""

import collections
import time

import torch
from torch import nn

from plenoctree_tpu_torch.parallel.mesh import MODEL_AXIS, all_gather, all_reduce_sum
from plenoctree_tpu_torch.utils.checkpoints import TrainState


def _spec_for(name, shape, model_size):
    if len(shape) >= 1 and shape[-1] % model_size == 0 and shape[-1] >= model_size:
        if name == "kernel" and len(shape) == 2:
            return (None, MODEL_AXIS)
        if name == "bias" and len(shape) == 1:
            return (MODEL_AXIS,)
    return ()


def param_specs(params, model_size):
    """The spec of every leaf of a params tree: a nested flax dict
    (`MLP_0/Dense_i/kernel`) or a flat state dict (`MLP_0.Dense_i.kernel`),
    given back in the same structure."""

    def walk(name, tree):
        if isinstance(tree, dict):
            return {k: walk(k, v) for k, v in tree.items()}
        return _spec_for(name.split(".")[-1], tuple(tree.shape), model_size)

    return walk("", params)


def shard_leaf(t, spec, index, size):
    """Model rank `index`'s slice of a whole leaf (the last axis, where the
    spec shards it)."""
    if not spec:
        return t
    k = t.shape[-1] // size
    return t[..., index * k : (index + 1) * k]


def shard_variables(params, layout):
    """{name: this rank's slice} of a flat {name: whole tensor} dict."""
    specs = param_specs(params, layout.model)
    return {k: shard_leaf(v, specs[k], layout.model_index, layout.model) for k, v in params.items()}


class _Timed:
    """The collectives' time per training step (CUDA events on a GPU, the
    host clock on the CPU)."""

    def __init__(self):
        self.pending = []
        self.steps = collections.deque(maxlen=1000)

    def run(self, fn, x):
        if x.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(x)
            end.record()
            self.pending.append(lambda: start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn(x)
            self.pending.append((time.perf_counter() - t0) * 1e3)
        return out

    def end_step(self):
        pending, self.pending = self.pending, []
        self.steps.append(pending)

    def median_ms(self):
        if not self.steps:
            return None
        per_step = sorted(sum(t() if callable(t) else t for t in s) for s in self.steps)
        return float(per_step[len(per_step) // 2])


class ModelParallel:
    """A rank's place in its model group, attached to a sharded model as
    `model.tp` and to each sharded Dense as `dense.tp`."""

    def __init__(self, layout, sharded, full_numel):
        self.group = layout.model_group
        self.index = layout.model_index
        self.size = layout.model
        self.sharded = frozenset(sharded)  # names of the sharded leaves
        self.full_numel = full_numel  # the one-process parameter count
        self.timer = _Timed()

    def _all_reduce(self, x):
        return self.timer.run(lambda t: all_reduce_sum(t, self.group), x)

    def own_columns(self, x):
        k = x.shape[-1] // self.size
        return x[..., self.index * k : (self.index + 1) * k].contiguous()

    def gather_all(self, xs):
        """[..., k] slices -> [..., size * k] whole tensors, in model-rank
        order, on every rank, through one all-reduce of one flat bucket;
        each rank gets its own columns of a whole tensor's gradient."""
        return _GatherMany.apply(self, *xs)

    def gather(self, x):
        return self.gather_all([x])[0]

    def copy_in(self, x):
        """Identity; the gradient is summed over the model group."""
        return _CopyIn.apply(x, self)

    def weight_l2(self, params):
        """The one-process weight decay term: the squares of every leaf
        (the sharded ones summed over the model group) over the one-process
        parameter count."""
        rep = sum(torch.sum(p**2) for k, p in params.items() if k not in self.sharded)
        shard = sum(torch.sum(p**2) for k, p in params.items() if k in self.sharded)
        return (rep + _SumOver.apply(shard, self)) / float(self.full_numel)


class _GatherMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, *xs):
        ctx.tp = tp
        return tuple(all_gather(xs, -1, tp.group, reduce=tp._all_reduce))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *[ctx.tp.own_columns(g) for g in gs])


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._all_reduce(g.contiguous()), None


class _SumOver(torch.autograd.Function):
    """The sum of a per-rank scalar over the model group; its gradient is 1
    on every rank (each rank's loss holds the whole sum)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp._all_reduce(x.reshape(1)).reshape(())

    @staticmethod
    def backward(ctx, g):
        return g, None


def shard_model_(model, layout):
    """Shard `model`'s Dense layers in place over the layout's model axis
    (each sharded kernel and bias becomes this rank's column slice, a new
    nn.Parameter) and attach the ModelParallel as `model.tp`. Returns the
    model."""
    params = dict(model.named_parameters())
    specs = param_specs(params, layout.model)
    full_numel = sum(p.numel() for p in params.values())
    sharded = [k for k, s in specs.items() if s]
    tp = ModelParallel(layout, sharded, full_numel)
    for name in sharded:
        module_name, attr = name.rsplit(".", 1)
        dense = model.get_submodule(module_name)
        piece = shard_leaf(params[name].detach(), specs[name], tp.index, tp.size)
        setattr(dense, attr, nn.Parameter(piece.clone()))
        dense.tp = tp
    model.tp = tp
    return model


def shard_train_state(state, model, layout):
    """Shard `model` (shard_model_) and give back its TrainState: the
    params are the model's (slices where sharded) and Adam's mu / nu this
    rank's slices of `state`'s; step and count are kept."""
    shard_model_(model, layout)

    def cut(tree):
        return {k: v.clone() for k, v in shard_variables(tree, layout).items()}

    opt = dict(state.opt_state, mu=cut(state.opt_state["mu"]), nu=cut(state.opt_state["nu"]))
    return TrainState(step=state.step, params=dict(model.named_parameters()), opt_state=opt)


@torch.no_grad()
def gather_tree(tree, tp):
    """{name: whole tensor} from this rank's {name: slice}, through one
    collective that every rank of the model group calls."""
    names = [k for k in tree if k in tp.sharded]
    whole = dict(zip(names, tp.gather_all([tree[k].detach() for k in names]))) if names else {}
    return {k: whole.get(k, v.detach()) for k, v in tree.items()}


def gather_train_state(state, tp):
    """The one-process TrainState (whole params, mu and nu) of a sharded
    one, on every rank of the model group: what a checkpoint holds."""
    opt = dict(state.opt_state, mu=gather_tree(state.opt_state["mu"], tp),
               nu=gather_tree(state.opt_state["nu"], tp))
    return TrainState(step=state.step, params=gather_tree(state.params, tp), opt_state=opt)
