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

  * inference across processes: each rank renders its contiguous share of
    every chunk over its own devices, and the shares are gathered in rank
    order (`all_gather_rows`), as the JAX package's process_allgather;
  * tensor parallelism over the "model" axis (parallel/partition.py): the
    world laid out row-major over (data, model) as JAX lays out its mesh,
    with a process subgroup per model index along "data" and one per data
    index along "model" (`init_groups`, `layout`).

The group code uses `broadcast` and `all_reduce` only: gloo handles CUDA
tensors for those two collectives, so two ranks may share one card
(`--dist_backend gloo`), which NCCL refuses. A gather (`all_gather`, for
the inference rows and the model axis's columns alike) is an all-reduce of
a zero-filled buffer into which each rank writes its own rows or columns:
adding zeros is exact (a -0 comes back as +0).
"""

import contextlib
import dataclasses
import datetime
import os

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A list of devices shaped (data, model). Inference splits its batches
    over every device in the list, so a model axis holds replicas there, as
    in the JAX inference CLIs; training shards parameters over "model"
    across ranks (`Layout`)."""

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
    not cover n devices."""
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
    return shape[0], (shape[1] if len(shape) == 2 else 1)


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
    not cover them raises). Under a process group of several ranks a rank
    runs on `devices`, else on its one `device`, and --mesh_shape must
    cover the ranks' devices together."""
    if world()[1] > 1:
        devices = list(devices or [device])
        parse_mesh_shape(getattr(cfg, "mesh_shape", ""), world()[1] * len(devices))
        return [torch.device(d) for d in devices]
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


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in a world laid out row-major over (data, model):
    rank = data_index * model + model_index, as JAX lays out a (data,
    model) mesh over its devices. `data_group` joins the ranks of one model
    index (the gradient all-reduce), `model_group` the ranks of one data
    index (the tensor-parallel gathers); a group is None where its axis has
    one rank."""

    rank: int
    world: int
    data: int
    model: int
    data_group: object = None
    model_group: object = None

    @property
    def data_index(self):
        return self.rank // self.model

    @property
    def model_index(self):
        return self.rank % self.model


_LAYOUT = None  # set by init_groups


def init_groups(mesh_shape=None):
    """Lay the default process group's ranks out over (data, model) as
    parse_mesh_shape reads mesh_shape (empty: every rank on "data") and make
    the subgroups: one along "data" per model index, one along "model" per
    data index. Every rank must call it, in the same order as its other
    collectives. Returns the Layout, which `layout()` returns from then on."""
    import torch.distributed as dist

    global _LAYOUT
    rank, world_size = world()
    data, model = parse_mesh_shape(mesh_shape, world_size)
    data_group = model_group = None
    if default_group() is not None:
        if model == 1:
            data_group = default_group()
        else:
            for m in range(model):  # every rank makes every group, in one order
                g = dist.new_group([d * model + m for d in range(data)])
                if rank % model == m and data > 1:
                    data_group = g
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)])
                if rank // model == d:
                    model_group = g
    _LAYOUT = Layout(rank, world_size, data, model, data_group, model_group)
    return _LAYOUT


def layout():
    """The Layout of init_groups; without it, every rank of the default group
    (if any) on the data axis."""
    if _LAYOUT is not None and default_group() is not None:
        return _LAYOUT
    rank, world_size = world()
    return Layout(rank, world_size, world_size, 1, default_group(), None)


def data_world():
    """(data index, data size): which share of a global batch this rank
    takes, and of how many (ranks of one data index take the same rows)."""
    lay = layout()
    return lay.data_index, lay.data


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


def add_dist_backend_flag(parser):
    """--dist_backend, the CLIs' process-group backend under torchrun."""
    parser.add_argument(
        "--dist_backend", default="", choices=["", "nccl", "gloo"],
        help="process-group backend under torch.distributed.run (empty: nccl on CUDA "
             "devices, gloo on the CPU; several ranks on one GPU need gloo)",
    )


@contextlib.contextmanager
def cli_group(backend, device):
    """The process group of an inference CLI, as (rank, world, device): the
    default group where the caller made one (it stays), else the one
    `python -m torch.distributed.run` set up (init_distributed), which is
    left through a barrier and destroyed on exit; (0, 1, device) without
    either."""
    import torch.distributed as dist

    if default_group() is not None:
        yield (*world(), torch.device(device))
        return
    rank, world_size, device = init_distributed(backend or None, device)
    made = default_group() is not None
    try:
        yield rank, world_size, device
        if made:
            dist.barrier()
    finally:
        if made:
            dist.destroy_process_group()


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


def all_reduce_sum(x, group=None):
    """x summed over the group: a new tensor in x's dtype (bf16 / f16 summed
    in f32), through one all-reduce, which gloo runs on CUDA tensors too."""
    import torch.distributed as dist

    wide = x.dtype in (torch.bfloat16, torch.float16)
    buf = x.float() if wide else x.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.dtype)


def all_gather(xs, dim=0, group=None, reduce=None):
    """Each of this rank's tensors xs (alike in shape on every rank) -> the
    group's, concatenated along `dim` in rank order, on every rank: one
    all-reduce of a flat zero-filled bucket holding this rank's slices
    (exact, apart from -0 becoming +0). `reduce(flat)` runs that
    all-reduce (default: all_reduce_sum over the group)."""
    import torch.distributed as dist

    rank, n = dist.get_rank(group), dist.get_world_size(group)
    parts = []
    for x in xs:
        k = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * k
        buf = x.new_zeros(shape)
        buf.narrow(dim, rank * k, k).copy_(x)
        parts.append(buf)
    flat = torch.cat([b.reshape(-1) for b in parts])
    flat = reduce(flat) if reduce is not None else all_reduce_sum(flat, group)
    out, off = [], 0
    for b in parts:
        out.append(flat[off : off + b.numel()].view_as(b))
        off += b.numel()
    return out


def all_gather_rows(x, group=None):
    """The group's x (each rank's [k, ...] tensor, k alike on every rank)
    stacked in rank order, [world * k, ...], on x's device (all_gather)."""
    return all_gather([x], 0, group)[0]


def broadcast_params_(model, src=0, group=None):
    """Every rank takes rank src's parameters (in named_parameters order)."""
    return broadcast_([p for _, p in model.named_parameters()], src, group)
