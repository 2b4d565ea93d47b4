"""Train state, Adam, and checkpoints in the JAX package's msgpack format.

Port of plenoctree_tpu/utils/checkpoints.py. A checkpoint is one file
`checkpoint_<step>` in the train dir holding flax's state dict of the JAX
TrainState:

  {'step': int32, 'variables': {'params': {'MLP_0': {'Dense_i': {'kernel',
   'bias'}}, ...}}, 'opt_state': {'0': {'count': int32, 'mu': <params>,
   'nu': <params>}, '1': {}}}

(optax.adam(1.0)'s state is (ScaleByAdamState, EmptyState)). Files written
here restore with the JAX package's `restore_checkpoint`. What the JAX
package writes restores here in both of flax's forms, so neither side needs
the other's stack: a legacy msgpack file, through utils/msgpack_lite.py,
and the orbax `checkpoint_<step>/` directory that flax writes by default
(`flax_use_orbax_checkpointing`), through utils/ocdbt.py. Original
JaxNeRF / NeRF-SH checkpoints ({'optimizer': {'target', 'state'}}, in
either form) import as the JAX package imports them: their params and
step, with a fresh Adam.

Under tensor parallelism (parallel/partition.py) a checkpoint keeps this
one-process layout: the train CLI gathers every sharded leaf of the
params and of mu / nu on every rank (partition.gather_train_state) and
rank 0 writes it here; a restore reads whole leaves, which
partition.shard_train_state then cuts.

Adam equals optax.adam(1.0) (b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
bias-corrected) with the step's lr multiplied in afterwards, as the JAX
train step does. The port updates parameters and moments in place.
"""

import dataclasses
import os
import re

import numpy as np
import torch

from plenoctree_tpu_torch.models.params import params_from_flax, params_to_flax
from plenoctree_tpu_torch.utils import msgpack_lite, ocdbt

B1, B2, EPS = 0.9, 0.999, 1e-8
_PREFIX = "checkpoint_"


@dataclasses.dataclass
class TrainState:
    """step (int), params (name -> the model's nn.Parameter, names as in its
    state_dict) and opt_state {'count': int, 'mu': {name: tensor}, 'nu': ...}."""

    step: int
    params: dict
    opt_state: dict


def create_train_state(model):
    params = dict(model.named_parameters())
    zeros = lambda: {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                     for k, p in params.items()}
    return TrainState(step=0, params=params, opt_state={"count": 0, "mu": zeros(), "nu": zeros()})


def _bias_corrections(count):
    """(1 - b1^count, 1 - b2^count), in f32 arithmetic."""
    f32 = np.float32
    return f32(1) - f32(B1) ** f32(count), f32(1) - f32(B2) ** f32(count)


@torch.no_grad()
def adam_update(state, grads, lr):
    """One optax.adam(1.0) step scaled by lr, applied in place:
    p += lr * -(mu_hat / (sqrt(nu_hat) + eps))."""
    opt = state.opt_state
    count = opt["count"] + 1
    bc1, bc2 = map(float, _bias_corrections(count))
    lr = float(np.float32(lr))
    for k, p in state.params.items():
        g = grads[k]
        mu, nu = opt["mu"][k], opt["nu"][k]
        mu.mul_(B1).add_(g * (1 - B1))
        nu.mul_(B2).add_(g.square() * (1 - B2))
        u = (mu / bc1) / ((nu / bc2).sqrt() + EPS)
        p.add_(u * -1.0 * lr)
    opt["count"] = count


def adam_scalars(count, lr):
    """The host scalars of the Adam step that takes the count to `count`,
    as `adam_apply` reads them: f32 [1 / (1 - b1^count), 1 / (1 - b2^count),
    lr]."""
    bc1, bc2 = _bias_corrections(count)
    f32 = np.float32
    return np.array([f32(1) / bc1, f32(1) / bc2, f32(lr)], np.float32)


@torch.no_grad()
def adam_apply(params, grads, mu, nu, scalars):
    """adam_update's arithmetic with the step's scalars read from the device
    (`scalars`: adam_scalars' three values in a device tensor), so that a
    captured CUDA graph can replay it; the count is the caller's to
    advance. On a CUDA device it is bitwise adam_update: ATen divides a
    tensor by a host scalar there as a product with the scalar's f32
    reciprocal, which is what mu_hat and nu_hat take here."""
    inv_bc1, inv_bc2, lr = scalars.unbind()
    for k, p in params.items():
        g = grads[k]
        m, v = mu[k], nu[k]
        m.mul_(B1).add_(g * (1 - B1))
        v.mul_(B2).add_(g.square() * (1 - B2))
        u = (m * inv_bc1) / ((v * inv_bc2).sqrt() + EPS)
        p.add_(u * -1.0 * lr)


def _to_tree(state):
    params = params_to_flax(state.params)
    opt = state.opt_state
    return {
        "step": np.asarray(state.step, np.int32),
        "variables": {"params": params},
        "opt_state": {
            "0": {
                "count": np.asarray(opt["count"], np.int32),
                "mu": params_to_flax(opt["mu"]),
                "nu": params_to_flax(opt["nu"]),
            },
            "1": {},
        },
    }


def save_checkpoint(train_dir, state, step, keep=200):
    """Write `checkpoint_<step>` (atomically) and keep the newest `keep`."""
    os.makedirs(train_dir, exist_ok=True)
    path = os.path.join(train_dir, f"{_PREFIX}{int(step)}")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_lite.packb(_to_tree(state)))
    os.replace(tmp, path)
    for old in _checkpoints(train_dir)[:-keep]:
        os.remove(old)
    return path


def _checkpoints(train_dir):
    """checkpoint_<int> paths in train_dir (files or orbax directories; an
    unfinished orbax save, `checkpoint_<int>.orbax-checkpoint-tmp-<t>`, is
    not one), oldest first."""
    if train_dir is None or not os.path.isdir(train_dir):
        return []
    found = []
    for name in os.listdir(train_dir):
        m = re.fullmatch(_PREFIX + r"(\d+)", name)
        if m:
            found.append((int(m.group(1)), os.path.join(train_dir, name)))
    return [p for _, p in sorted(found)]


def read_checkpoint(path):
    """The raw state dict of one checkpoint (nested dicts of numpy): an
    orbax directory or a msgpack file; both give the same dict for the
    same state."""
    if os.path.isdir(path):
        return ocdbt.read_pytree(path)
    with open(path, "rb") as f:
        return msgpack_lite.unpackb(f.read())


def _copy_into(dst, src, what):
    if set(dst) != set(src):
        missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        raise ValueError(f"{what}: checkpoint keys differ (missing {missing}, extra {extra})")
    with torch.no_grad():
        for k, t in dst.items():
            v = src[k]
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{what} {k}: shape {tuple(v.shape)} != {tuple(t.shape)}")
            t.copy_(v.to(t.dtype))


def restore_checkpoint(train_dir, state):
    """Restore the newest checkpoint of train_dir into `state` (in place) and
    return it; an empty or missing dir returns `state` unchanged."""
    paths = _checkpoints(train_dir)
    if not paths:
        return state
    raw = read_checkpoint(paths[-1])
    if "optimizer" in raw and "target" in raw["optimizer"]:
        # An original JaxNeRF / NeRF-SH tree: its target (with or without a
        # `params` level) re-rooted, Adam started afresh
        # (plenoctree_tpu/utils/checkpoints.py::restore_checkpoint).
        _copy_into(state.params, params_from_flax(raw["optimizer"]["target"]), "params")
        for m in ("mu", "nu"):
            with torch.no_grad():
                for t in state.opt_state[m].values():
                    t.zero_()
        state.opt_state["count"] = 0
        state.step = int(np.asarray(raw["optimizer"].get("state", {}).get("step", 0)))
        return state
    _copy_into(state.params, params_from_flax(raw["variables"]["params"]), "params")
    adam = raw["opt_state"]["0"]
    for m in ("mu", "nu"):
        _copy_into(state.opt_state[m], params_from_flax(adam[m]), m)
    state.opt_state["count"] = int(np.asarray(adam["count"]))
    state.step = int(np.asarray(raw["step"]))
    return state
