"""Devices and process groups: the port's counterpart of
plenoctree_tpu/parallel/mesh.py.

The JAX package runs one program over a `jax.sharding.Mesh` whose "data"
axis shards each batch (GSPMD inserts the gradient psum). The port runs
data parallelism in the PyTorch way:

  * training: one process per device (`python -m torch.distributed.run`),
    the ray batch split across the ranks (`shard_batch`), the parameters
    broadcast from rank 0 (`broadcast_params_`) and the gradients averaged
    by one all-reduce over a flat bucket (`all_reduce_mean_`);
  * inference: one process over a list of devices (`make_mesh`), each chunk
    edge-padded to the device count (`pad_to_multiple`), split, and each
    slice run on a model replica of its device (engine.render_image,
    engine.eval_points, TileRenderer(mesh=...)).

The group code uses `broadcast` and `all_reduce` only: gloo handles CUDA
tensors for those two collectives, so two ranks may share one card
(`--dist_backend gloo`), which NCCL refuses.

Not ported (ROADMAP.md A9): tensor parallelism over the "model" axis
(plenoctree_tpu/parallel/partition.py); a model size above 1 raises.
"""

import dataclasses
import datetime
import os

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A list of devices shaped (data, model); the port shards the data axis
    only, so `model` is 1."""

    devices: tuple
    data: int
    model: int = 1

    @property
    def shape(self):
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def __len__(self):
        return len(self.devices)


def parse_mesh_shape(mesh_shape, n):
    """[data, model] from a mesh shape (None, "", (), an iterable of up to two
    ints or a comma string) over n devices: empty means (n, 1); one -1 is
    inferred, as in the JAX make_mesh. Raises ValueError when the shape does
    not cover n devices, NotImplementedError for a model axis above 1."""
    if isinstance(mesh_shape, str):
        mesh_shape = [int(x) for x in mesh_shape.split(",") if x.strip()]
    shape = list(mesh_shape or (n,))
    if not 1 <= len(shape) <= 2:
        raise ValueError(f"mesh_shape {shape}: at most two axes (data, model)")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = n // known
    if int(np.prod(shape)) != n or min(shape) < 1:
        raise ValueError(f"mesh_shape {shape} does not cover {n} devices")
    if len(shape) == 2 and shape[1] > 1:
        raise NotImplementedError(
            f"mesh_shape {shape}: tensor parallelism over the 'model' axis is not "
            "ported; see ROADMAP.md A9"
        )
    return shape[0], 1


def visible_devices():
    """Every visible CUDA device, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(mesh_shape=None, devices=None):
    """A Mesh over `devices` (default: every visible CUDA device), shaped by
    mesh_shape as parse_mesh_shape reads it. A device may be listed more
    than once (two slices on one card)."""
    if devices is None:
        devices = visible_devices()
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=")
    devices = tuple(torch.device(d) for d in devices)
    data, model = parse_mesh_shape(mesh_shape, len(devices))
    return Mesh(devices, data, model)


def cli_devices(cfg, device, devices=None):
    """The devices a CLI runs inference on: `devices` when the caller hands
    a list in, else every visible CUDA device for --device cuda (no index),
    else the one named device; shaped by --mesh_shape (a shape that does
    not cover them raises)."""
    if devices is None:
        device = torch.device(device)
        devices = visible_devices() if device.type == "cuda" and device.index is None else []
        devices = devices or [device]
    return list(make_mesh(getattr(cfg, "mesh_shape", ""), devices).devices)


def pad_to_multiple(x, multiple, axis=0):
    """Edge-pad x (numpy or torch) along `axis` to a multiple of `multiple`:
    (padded, pad amount)."""
    size = x.shape[axis]
    pad = -size % multiple
    if pad == 0:
        return x, 0
    if isinstance(x, torch.Tensor):
        edge = x.narrow(axis, size - 1, 1)
        reps = [1] * x.ndim
        reps[axis] = pad
        return torch.cat([x, edge.repeat(*reps)], dim=axis), pad
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, mode="edge"), pad


# -- process groups ----------------------------------------------------------


def default_group():
    """The default process group where one is initialised, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def world():
    """(rank, world size) of the default process group; (0, 1) without one."""
    import torch.distributed as dist

    if default_group() is not None:
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _backend_for(device, backend):
    if backend is None:
        return "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"--dist_backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"--dist_backend nccl needs a CUDA device, got {device}")
    return backend


def init_distributed(backend=None, device=None, timeout_s=1800):
    """Join the process group that `python -m torch.distributed.run` set up
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); returns
    (rank, world, device). Without WORLD_SIZE, or at WORLD_SIZE 1 without
    MASTER_ADDR, it is a no-op: (0, 1, device). Under torchrun a world of
    one still makes its group of one, so the same all-reduce runs (on one
    card, through NCCL). `device` None or "cuda" (no index) means
    cuda:LOCAL_RANK; a named device (cpu, cuda:N) is used by every rank.
    The backend is nccl for a CUDA device unless `backend` says gloo, and
    gloo for the CPU; nothing falls back from one to the other."""
    import torch.distributed as dist

    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False")
    if world_size < 1 or (world_size == 1 and "MASTER_ADDR" not in os.environ):
        return 0, 1, device
    shared = device.type != "cuda" or device.index is not None
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local)
    backend = _backend_for(device, backend)
    if backend == "nccl" and shared and world_size > 1:
        raise ValueError(
            f"--device {device} puts every rank on one card, which NCCL refuses; "
            "use --dist_backend gloo (or --device cuda for cuda:LOCAL_RANK)"
        )
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return rank, world_size, device


def shard_batch(batch, rank, world_size, keep=("sp_points",)):
    """This rank's rows of a global batch: rows [rank * n / world, (rank + 1)
    * n / world) of every array (numpy or torch) in a dict / namedtuple
    tree, except under the keys in `keep` (replicated: the sparsity points
    of a handed-in `draws`). Raises when n does not divide."""

    def take(x):
        n = x.shape[0]
        if n % world_size:
            raise ValueError(f"a batch of {n} rows does not divide over {world_size} ranks")
        k = n // world_size
        return x[rank * k : (rank + 1) * k]

    def walk(node):
        if isinstance(node, dict):
            return {k: (v if k in keep else walk(v)) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[walk(v) for v in node])
        return take(node)

    return walk(batch)


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _unflat_(flat, tensors):
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off : off + n].view_as(t).to(t.dtype))
            off += n


def all_reduce_mean_(tensors, group=None):
    """Average `tensors` (a list, in a fixed order) over the group in place,
    through one all-reduce of one flat f32 bucket; returns the list."""
    import torch.distributed as dist

    tensors = list(tensors)
    flat = _flat(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    _unflat_(flat, tensors)
    return tensors


def broadcast_(tensors, src=0, group=None):
    """Overwrite `tensors` with rank src's, through one broadcast of a flat
    bucket."""
    import torch.distributed as dist

    tensors = list(tensors)
    flat = _flat(tensors)
    dist.broadcast(flat, src=src, group=group)
    _unflat_(flat, tensors)
    return tensors


def broadcast_params_(model, src=0, group=None):
    """Every rank takes rank src's parameters (in named_parameters order)."""
    return broadcast_([p for _, p in model.named_parameters()], src, group)
