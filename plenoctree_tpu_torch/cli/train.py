"""NeRF-SH training CLI.

Port of plenoctree_tpu/cli/train.py: the training step of engine.py (the
fused trunk kernels with --use_pallas on a GPU), restore on
start, `checkpoint_<step>` files every --save_every steps (the JAX
package's msgpack format), metrics.jsonl (and TensorBoard events where
tensorboardX is importable) every --print_every steps, an in-train render
of one test view with PSNR/SSIM every --render_every steps (PNG under
render/), and timings.txt (step 0 at the start, then each render step;
`python -m plenoctree_tpu_torch.cli.parse_timing` sums it). With
--profile_start_step S, torch.profiler (CPU, and CUDA on a GPU) records
steps S to S + --profile_steps and writes a Chrome trace under
`<train_dir>/profile/`, as the JAX CLI's jax.profiler hooks trace those
steps.

Data parallel under `python -m torch.distributed.run` (the JAX CLI's
jax.distributed run): one process per device, each rank on cuda:LOCAL_RANK
(or every rank on the one --device named, e.g. `--device cuda:0
--dist_backend gloo` or `--device cpu`), taking batch_size // world rays
a step from its own sampler; rank 0's initial or restored parameters are
broadcast, the gradients averaged by one all-reduce a step (engine.py).
Stratified and fine samples are drawn per rank (the JAX CLI's
fold_in(rng, process_index)), the sparsity points alike on every rank.
Rank 0 alone writes metrics, TensorBoard events, timings.txt, checkpoints,
renders and the profiler trace. --mesh_shape D,M (the JAX CLI's data and
model axes) lays the world out row-major over both: the batch splits over
the D data indices, and each model group of M ranks shards the Dense
layers by columns (parallel/partition.py: ranks of one data index take
the same rows and draws). Checkpoints keep the one-process layout: every
rank gathers the columns, rank 0 writes, and renders through a whole copy
of the model. In one process (no group) a model axis is replicated, as the
JAX CLI replicates its state over the mesh; --mesh_shape must then name a
data axis of 1. Each rank ends with one line: its steps, its ms/step after
the first step (renders and saves left out; on ranks other than 0 the
wait for rank 0's renders and saves falls into the next all-reduce), the
all-reduce's median ms/step, the model axis's collectives' ms/step and
its trunk-kernel launches.

Usage:
  python -m plenoctree_tpu_torch.cli.train --config nerf_sh/config/blender \\
      --dataset synthetic --train_dir <dir> --use_pallas --compute_dtype bfloat16 \\
      --batch_size 4096 --image_batching --device cuda
  python -m torch.distributed.run --nproc_per_node 8 -m plenoctree_tpu_torch.cli.train \\
      <the same flags>                    # one rank per GPU, NCCL
  python -m torch.distributed.run --nproc_per_node 8 -m plenoctree_tpu_torch.cli.train \\
      <the same flags> --mesh_shape 4,2   # 4-way data x 2-way tensor parallel
"""

import argparse
import contextlib
import copy
import gc
import os
import time

import numpy as np
import torch
import torch.distributed

from plenoctree_tpu_torch import engine
from plenoctree_tpu_torch import parallel
from plenoctree_tpu_torch.data import get_dataset
from plenoctree_tpu_torch.models.nerf import get_model_state
from plenoctree_tpu_torch.ops.metrics import compute_psnr, compute_ssim
from plenoctree_tpu_torch.utils import checkpoints as ckpt_utils
from plenoctree_tpu_torch.utils import config as config_lib
from plenoctree_tpu_torch.utils import io as io_utils
from plenoctree_tpu_torch.utils.lr import schedule_from_config
from plenoctree_tpu_torch.utils.metrics_writer import MetricsWriter
from plenoctree_tpu_torch.utils.png import write_png


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--synthetic_resolution", type=int, default=64,
        help="image side of the procedural scene (--dataset synthetic)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to train on; 'cuda' raises when there is no GPU (under "
             "torch.distributed.run: cuda:LOCAL_RANK)",
    )
    parallel.mesh.add_dist_backend_flag(parser)
    config_lib.add_flags(parser)
    return parser


SEED = 20200823  # the JAX CLI's PRNGKey seed; init and per-step sampling
SP_SEED = 20200824  # the sparsity points' stream, alike on every rank


def step_seed(seed, step, rank=0):
    """A generator seed for one step (and rank): the step and rank folded
    into `seed`, as jax.random.fold_in folds them into the JAX CLI's key."""
    return int(np.random.SeedSequence([seed, rank, step]).generate_state(1)[0])


class _Profile:
    """torch.profiler over steps [start, start + steps] (the JAX CLI starts
    its trace before step `start` and stops it after step start + steps),
    exported as a Chrome trace into `<train_dir>/profile/`."""

    def __init__(self, cfg, device):
        self.start, self.stop_at = cfg.profile_start_step, cfg.profile_start_step + cfg.profile_steps
        self.dir = os.path.join(cfg.train_dir, "profile")
        self.device = device
        self.prof = None

    def before(self, step):
        if self.start and step == self.start:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()

    def after(self, step, last=False):
        if self.prof is None or not (step == self.stop_at or last):
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"trace_steps_{self.start}_{step}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        print("* Profile written to", path)


def main(argv=None):
    cfg = config_lib.parse_flags(build_parser(), argv)
    if cfg.train_dir is None:
        raise ValueError("train_dir must be set. None set now.")
    if cfg.dataset != "synthetic" and cfg.data_dir is None:
        raise ValueError("data_dir must be set. None set now.")
    rank, world, device = parallel.init_distributed(cfg.dist_backend or None, cfg.device)
    grouped = parallel.mesh.default_group() is not None
    try:
        out = _train(cfg, rank, world, device)
        if grouped:
            torch.distributed.barrier()
        return out
    finally:
        if grouped:
            torch.distributed.destroy_process_group()


def _layout(cfg, world):
    """The ranks over (data, model): init_groups under a group; in one
    process a model axis is replicated, so the data axis must be 1."""
    shape = [int(x) for x in str(cfg.mesh_shape or "").split(",") if x.strip()]
    try:
        if parallel.mesh.default_group() is not None:
            return parallel.mesh.init_groups(cfg.mesh_shape)
        if len(shape) == 2 and shape[0] in (1, -1) and shape[1] >= 1:
            if shape[1] > 1:
                print(f"* --mesh_shape {cfg.mesh_shape} in one process: the model axis "
                      "is replicated")
            return parallel.mesh.layout()
        parallel.mesh.parse_mesh_shape(cfg.mesh_shape, world)
        return parallel.mesh.layout()
    except ValueError as e:
        raise ValueError(
            f"{e}: the train CLI runs one device per rank ({world} here); launch "
            "one process per device with python -m torch.distributed.run"
        ) from None


def _train(cfg, rank, world, device):
    lay = _layout(cfg, world)
    lead = rank == 0
    np.random.seed(20201473 + lay.data_index)
    render_dir = os.path.join(cfg.train_dir, "render")
    if lead:
        os.makedirs(render_dir, exist_ok=True)
        timings = io_utils.TimingsLog(os.path.join(cfg.train_dir, "timings.txt"))
        timings.write(0)

    say = print if lead else (lambda *a, **k: None)  # the JAX CLI's h0print
    say("* Load train data")
    dataset = get_dataset("train", cfg)
    say("* Load test data")
    test_dataset = get_dataset("test", cfg)
    say("* Load model")
    model, state = get_model_state(cfg, seed=SEED, restore=True, device=device)
    group = parallel.mesh.default_group()
    tp = render_model = None
    if group is not None:
        parallel.broadcast_params_(model, 0, group)
        print(f"* Rank {rank} of {world} on {device} "
              f"({torch.distributed.get_backend(group)})", flush=True)
        if lay.model > 1:
            print(f"* Rank {rank}: data {lay.data_index}/{lay.data}, "
                  f"model {lay.model_index}/{lay.model}", flush=True)
            render_model = copy.deepcopy(model) if lead else None
            state = parallel.partition.shard_train_state(state, model, lay)
            tp = model.tp
    init_step = state.step + 1
    train_step = engine.make_train_step(model, cfg, lay.data_group)
    lr_fn = schedule_from_config(cfg)
    gen = torch.Generator(device=device)
    sp_gen = torch.Generator(device=device)
    profiler = _Profile(cfg, device) if lead else None
    if cfg.use_pallas and device.type == "cuda":
        from plenoctree_tpu_torch.kernels import fused_mlp

        launches0 = (fused_mlp.fwd_launches, fused_mlp.bwd_launches)

    with (MetricsWriter(cfg.train_dir) if lead else contextlib.nullcontext()) as writer:
        gc.disable()
        stats_trace = []
        t_loop_start = time.time()
        t_train, t_aside = None, 0.0  # from the end of the first step; renders and saves
        batches = engine.device_batches(dataset, device)
        for step in range(init_step, cfg.max_steps + 1):
            # Resume-stable, like fold_in(rng, step); per rank like the JAX
            # CLI's fold_in(rng, process_index), the sparsity points alike.
            gen.manual_seed(step_seed(SEED, step, lay.data_index))
            sp_gen.manual_seed(step_seed(SP_SEED, step))
            if lead:
                profiler.before(step)
            state, stats, _ = train_step(state, next(batches), gen, sp_generator=sp_gen)
            if t_train is None:  # the first step pays the warm-ups
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t_train = time.time()
            if step % cfg.gc_every == 0:
                gc.collect()
            rendering = cfg.render_every > 0 and step % cfg.render_every == 0
            # Under tensor parallelism every rank gathers the columns that
            # rank 0 saves and renders with.
            whole = (parallel.partition.gather_train_state(state, tp)
                     if tp is not None and (step % cfg.save_every == 0 or rendering) else state)
            if not lead:
                continue
            profiler.after(step)
            stats_trace.append(stats)

            if step % cfg.print_every == 0:
                trace = torch.stack([torch.stack(list(s)) for s in stats_trace]).cpu().numpy()
                last = dict(zip(engine.Stats._fields, trace[-1]))
                avg_loss, avg_psnr = float(trace[:, 0].mean()), float(trace[:, 1].mean())
                stats_trace = []
                lr = lr_fn(step)
                writer.scalar("train_loss", last["loss"], step)
                writer.scalar("train_psnr", last["psnr"], step)
                writer.scalar("train_loss_coarse", last["loss_c"], step)
                writer.scalar("train_psnr_coarse", last["psnr_c"], step)
                if cfg.sparsity_weight > 0.0:
                    writer.scalar("train_sparse_loss", last["loss_sp"], step)
                writer.scalar("weight_l2", last["weight_l2"], step)
                writer.scalar("train_avg_loss", avg_loss, step)
                writer.scalar("train_avg_psnr", avg_psnr, step)
                writer.scalar("learning_rate", lr, step)
                steps_per_sec = cfg.print_every / (time.time() - t_loop_start)
                t_loop_start = time.time()
                rays_per_sec = cfg.batch_size * steps_per_sec
                writer.scalar("train_steps_per_sec", steps_per_sec, step)
                writer.scalar("train_rays_per_sec", rays_per_sec, step)
                precision = int(np.ceil(np.log10(cfg.max_steps))) + 1
                print(
                    ("{:" + "{:d}".format(precision) + "d}").format(step)
                    + f"/{cfg.max_steps:d}: i_loss={float(last['loss']):0.4f}, "
                    + f"avg_loss={avg_loss:0.4f}, weight_l2={float(last['weight_l2']):0.2e}, "
                    + f"lr={lr:0.2e}, {rays_per_sec:0.0f} rays/sec",
                    flush=True,
                )
            t_aside_start = time.time()
            if step % cfg.save_every == 0:
                print("* Saving")
                ckpt_utils.save_checkpoint(cfg.train_dir, whole, step)

            if rendering:
                print("\n* Rendering")
                t_eval_start = time.time()
                test_case = next(test_dataset)
                if render_model is not None:
                    with torch.no_grad():
                        for k, p in render_model.named_parameters():
                            p.copy_(whole.params[k])
                pred_color, pred_disp, pred_acc = engine.render_image(
                    model if render_model is None else render_model, test_case["rays"],
                    chunk=cfg.chunk, device=device,
                    randomized=cfg.randomized, generator=gen,
                    normalize_disp=cfg.dataset == "llff", group=None,
                )
                gt = test_case["pixels"]
                psnr = float(compute_psnr(float(np.mean((pred_color - gt) ** 2))))
                ssim = float(compute_ssim(
                    torch.from_numpy(pred_color), torch.from_numpy(gt.astype(np.float32)), 1.0,
                ))
                eval_time = time.time() - t_eval_start
                num_rays = int(np.prod(test_case["rays"].directions.shape[:-1]))
                writer.scalar("test_rays_per_sec", num_rays / eval_time, step)
                writer.scalar("test_psnr", psnr, step)
                writer.scalar("test_ssim", ssim, step)
                timings.write(step)
                print(f"Eval {step}: {eval_time:0.3f}s., PSNR {psnr:0.2f}, SSIM {ssim:0.4f}")
                vis = np.hstack([
                    gt, pred_color, np.repeat(pred_disp, 3, -1), np.repeat(pred_acc, 3, -1),
                ])
                vis = (np.clip(vis, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                write_png(os.path.join(render_dir, "{:010}.png".format(step)), vis)
                t_loop_start += time.time() - t_eval_start
            t_aside += time.time() - t_aside_start
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        n_steps = cfg.max_steps + 1 - init_step
        ms_step = (time.time() - (t_train or time.time()) - t_aside) * 1e3 / max(n_steps - 1, 1)
        if lead:
            profiler.after(cfg.max_steps, last=True)
        gc.enable()
    line = f"* rank {rank}/{world}: {n_steps} steps, {ms_step:.3f} ms/step"
    if lay.data_group is not None:
        line += f", all-reduce {train_step.all_reduce_ms() or 0.0:.3f} ms/step"
    if tp is not None:
        line += f", model collectives {train_step.model_collectives_ms() or 0.0:.3f} ms/step"
    if cfg.use_pallas and device.type == "cuda":
        line += (f", trunk launches fwd {fused_mlp.fwd_launches - launches0[0]}"
                 f" bwd {fused_mlp.bwd_launches - launches0[1]}")
    print(line, flush=True)
    last = cfg.max_steps % cfg.save_every != 0
    whole = parallel.partition.gather_train_state(state, tp) if tp is not None and last else state
    if lead:
        timings.close()
        if last:
            ckpt_utils.save_checkpoint(cfg.train_dir, whole, cfg.max_steps)
    return model, state


if __name__ == "__main__":
    main()
