"""Run a function on the ranks of a local process group, and the checks
that the tests and chip_smoke.py run on it: the train step (data and
tensor parallel), inference and the inference CLIs across ranks.

`run_ranks("pkg.module:function", world, kwargs)` starts `world` Python
processes, joins them into one process group through a FileStore in a
fresh temporary directory (no port to collide on), calls
`function(rank, world, **kwargs)` in each and returns the ranks' return
values. A rank that fails, or a group that outlives `timeout` seconds,
kills every rank and raises with the failing rank's log.

`train_steps(rank, world, ...)` runs N steps of engine.make_train_step on
this rank's rows of the same global batches (and handed-in draws), the
gradients averaged over the group, and returns what a comparison needs:
the stats, the gradients given to Adam, and the parameters and Adam
moments after each step.
"""

import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(target, world, kwargs=None, backend="gloo", timeout=120, threads=None):
    """[function(rank, world, **kwargs) for every rank], each rank in its own
    process, joined by a `backend` process group."""
    with tempfile.TemporaryDirectory(prefix="pn_ranks_") as tmp:
        with open(os.path.join(tmp, "kwargs.pkl"), "wb") as f:
            pickle.dump(kwargs or {}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
        env.setdefault("OMP_NUM_THREADS", str(threads or max(1, (os.cpu_count() or 2) // world)))
        procs = []
        for rank in range(world):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "plenoctree_tpu_torch.parallel.ranks", target, tmp,
                 str(rank), str(world), backend, str(timeout)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
            ), log))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p, _ in procs):
                failed = [r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)]
                if failed:
                    time.sleep(1.0)  # let the ranks that the failure broke exit too
                    failed = [r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)]
                    raise RuntimeError(f"ranks {failed} failed:\n"
                                       + "\n".join(_tail(tmp, r) for r in failed))
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks did not finish in {timeout} s:\n"
                                       + "\n".join(_tail(tmp, r) for r in range(world)))
                time.sleep(0.05)
            failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
            if failed:
                raise RuntimeError(f"ranks {failed} failed:\n"
                                   + "\n".join(_tail(tmp, r) for r in failed))
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _tail(tmp, rank, n=4000):
    with open(os.path.join(tmp, f"rank{rank}.log")) as f:
        return f"--- rank {rank} ---\n" + f.read()[-n:]


def _child(target, tmp, rank, world, backend, timeout):
    import datetime
    import importlib

    import torch.distributed as dist

    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    with open(os.path.join(tmp, "kwargs.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "store"), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout),
    )
    try:
        result = fn(rank, world, **kwargs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def groups(rank, world, mesh_shape):
    """mesh.init_groups(mesh_shape) on this rank: (data index, model index,
    the ranks of its data-axis group, the ranks of its model-axis group),
    each group's ranks found by an all-reduce of one-hot rank vectors."""
    import torch.distributed as dist

    from plenoctree_tpu_torch.parallel import mesh as mesh_lib

    lay = mesh_lib.init_groups(mesh_shape)
    members = []
    for g in (lay.data_group, lay.model_group):
        if g is None:
            members.append([rank])
            continue
        hot = torch.zeros(world)
        hot[rank] = 1.0
        dist.all_reduce(hot, group=g)
        members.append([int(r) for r in torch.nonzero(hot)[:, 0]])
    return lay.data_index, lay.model_index, members[0], members[1]


def collectives(rank, world):
    """all_reduce_mean_ of rank-dependent tensors, then broadcast_params_ of
    a Linear whose parameters are rank + 7 from rank 1: what this rank
    holds after each (the collectives' own check)."""
    from plenoctree_tpu_torch.parallel import mesh as mesh_lib

    a = [torch.full((3,), float(rank)), torch.arange(4.0).reshape(2, 2) * (rank + 1)]
    mesh_lib.all_reduce_mean_(a)
    model = torch.nn.Linear(2, 3)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(rank + 7.0)
    mesh_lib.broadcast_params_(model, src=1)
    return [t.numpy() for t in a], [p.detach().numpy() for p in model.parameters()]


# -- inference across ranks ---------------------------------------------------


def inference(rank, world, cfg, params, rays, points, chunk, points_chunk, device="cpu"):
    """engine.render_image of `rays` ([H, W, 3] arrays) at `chunk` and
    engine.eval_points of the fine trunk's (rgb, sigma) at `points` [N, 3]
    at `points_chunk`, on this rank's share of every chunk over the default
    process group: what every rank gets back (numpy)."""
    from plenoctree_tpu_torch import engine
    from plenoctree_tpu_torch.data.rays import Rays
    from plenoctree_tpu_torch.models.nerf import NerfModel
    from plenoctree_tpu_torch.octree.extract import make_points_fn
    from plenoctree_tpu_torch.utils import config as config_lib

    device = torch.device(device)
    model = NerfModel(config_lib.default_config(**cfg))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    model.to(device).eval()
    image = engine.render_image(model, Rays(*rays), chunk=chunk, device=device)
    pts = torch.as_tensor(points).to(device)
    with torch.no_grad():
        rgb, sigma = engine.eval_points(make_points_fn(model, device), pts, points_chunk)
    return [np.asarray(x) for x in image] + [rgb.cpu().numpy(), sigma.cpu().numpy()]


def cli(rank, world, module, argv, devices=None):
    """main(argv) of plenoctree_tpu_torch.cli.<module> on this rank (each
    '{rank}' in an argument becomes the rank, so that each rank may have a
    train dir of its own, as hosts have disks of their own); returns what
    main returns, with tensors as numpy."""
    import importlib

    main = importlib.import_module(f"plenoctree_tpu_torch.cli.{module}").main
    out = main([a.replace("{rank}", str(rank)) for a in argv], devices=devices)
    if isinstance(out, dict):
        out = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}
    return out


# -- the train-step checks ----------------------------------------------------


def _numpy(tensors):
    return {k: t.detach().float().cpu().numpy().copy() for k, t in tensors.items()}


def _to_device(tree, device):
    from plenoctree_tpu_torch.data.rays import Rays

    def move(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    if tree is None:
        return None
    out = {}
    for k, v in tree.items():
        out[k] = Rays(*[move(r) for r in v]) if isinstance(v, tuple) else move(v)
    return out


def train_steps(rank, world, cfg, params, batches, draws=None, opt_state=None, device="cpu",
                launches=False, mesh_shape=None):
    """Steps of engine.make_train_step on this rank's rows of each global
    batch (and of each handed-in draws dict; its 'sp_points' go to every
    rank whole), from `params` ({name: array}, the model's state_dict names)
    and, where given, `opt_state` ({'count', 'mu', 'nu'}); where a default
    process group exists (run_ranks makes one, of one rank too) the
    gradients are averaged over it. With `mesh_shape` (data, model) the
    ranks are laid out over both axes (mesh.init_groups): the batch is split
    over "data", the Dense layers sharded over "model"
    (partition.shard_train_state) and the gradients averaged over the
    data-axis group.

    Returns {'stats': [per step {name: float}], 'grads': [per step {name:
    array}] (what Adam was given), 'params' / 'mu' / 'nu': [before the first
    step, then after each]}, whole tensors under tensor parallelism too,
    and, with `launches`, the fused trunk kernels' launch counts, the
    all-reduce's and the model axis's collectives' ms per step."""
    from plenoctree_tpu_torch import engine
    from plenoctree_tpu_torch.models.nerf import NerfModel
    from plenoctree_tpu_torch.parallel import mesh as mesh_lib
    from plenoctree_tpu_torch.parallel import partition
    from plenoctree_tpu_torch.utils import checkpoints as ckpt_utils
    from plenoctree_tpu_torch.utils import config as config_lib

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tcfg = config_lib.default_config(**cfg)
    model = NerfModel(tcfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    model.to(device)
    state = ckpt_utils.create_train_state(model)
    if opt_state is not None:
        with torch.no_grad():
            for m in ("mu", "nu"):
                for k, t in state.opt_state[m].items():
                    t.copy_(torch.as_tensor(opt_state[m][k]))
        state.opt_state["count"] = int(opt_state["count"])
        state.step = int(opt_state["count"])
    if mesh_shape is None:
        group, share, shares = mesh_lib.default_group(), rank, world
    else:
        lay = mesh_lib.init_groups(mesh_shape)
        group, share, shares = lay.data_group, lay.data_index, lay.data
        if lay.model > 1:
            state = partition.shard_train_state(state, model, lay)
    tp = getattr(model, "tp", None)
    whole = (lambda t: t) if tp is None else (lambda t: partition.gather_tree(t, tp))
    step_fn = engine.make_train_step(model, tcfg, group)

    seen = []
    real_update = ckpt_utils.adam_update

    def spy(st, grads, lr):
        seen.append(_numpy(whole(grads)))
        real_update(st, grads, lr)

    def record(st):
        out["params"].append(_numpy(whole(st.params)))
        out["mu"].append(_numpy(whole(st.opt_state["mu"])))
        out["nu"].append(_numpy(whole(st.opt_state["nu"])))

    out = {"stats": [], "params": [], "mu": [], "nu": []}
    record(state)
    if launches:
        from plenoctree_tpu_torch.kernels import fused_mlp

        fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
    ckpt_utils.adam_update = spy
    try:
        for k, batch in enumerate(batches):
            local = _to_device(mesh_lib.shard_batch(batch, share, shares), device)
            d = (None if draws is None
                 else _to_device(mesh_lib.shard_batch(draws[k], share, shares), device))
            state, stats, _ = step_fn(state, local, None, d)
            out["stats"].append({n: float(v) for n, v in zip(engine.Stats._fields, stats)})
            record(state)
    finally:
        ckpt_utils.adam_update = real_update
    out["grads"] = seen
    if launches:
        out["fwd_launches"] = fused_mlp.fwd_launches
        out["bwd_launches"] = fused_mlp.bwd_launches
        out["all_reduce_ms"] = step_fn.all_reduce_ms()
        out["model_collectives_ms"] = step_fn.model_collectives_ms()
    return out


if __name__ == "__main__":
    _target, _tmp, _rank, _world, _backend, _timeout = sys.argv[1:7]
    _child(_target, _tmp, int(_rank), int(_world), _backend, float(_timeout))
