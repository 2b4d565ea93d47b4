"""NeRF-SH training CLI.

Port of plenoctree_tpu/cli/train.py for one device: the training step of
engine.py (the fused trunk kernels with --use_pallas on a GPU), restore on
start, `checkpoint_<step>` files every --save_every steps (the JAX
package's msgpack format), metrics.jsonl (and TensorBoard events where
tensorboardX is importable) every --print_every steps, an in-train render
of one test view with PSNR/SSIM every --render_every steps (PNG under
render/), and timings.txt (step 0 at the start, then each render step;
`python -m plenoctree_tpu_torch.cli.parse_timing` sums it). With
--profile_start_step S, torch.profiler (CPU, and CUDA on a GPU) records
steps S to S + --profile_steps and writes a Chrome trace under
`<train_dir>/profile/`, as the JAX CLI's jax.profiler hooks trace those
steps. Not ported: jax.distributed / multi-host and the multi-host RNG
fold (ROADMAP.md A8).

Usage:
  python -m plenoctree_tpu_torch.cli.train --config nerf_sh/config/blender \\
      --dataset synthetic --train_dir <dir> --use_pallas --compute_dtype bfloat16 \\
      --batch_size 4096 --image_batching --device cuda
"""

import argparse
import gc
import os
import time

import numpy as np
import torch

from plenoctree_tpu_torch import engine
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
        help="torch device to train on; 'cuda' raises when there is no GPU",
    )
    config_lib.add_flags(parser)
    return parser


SEED = 20200823  # the JAX CLI's PRNGKey seed; init and per-step sampling


def _device(name):
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False")
    return dev


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
    device = _device(cfg.device)
    np.random.seed(20201473)
    os.makedirs(cfg.train_dir, exist_ok=True)
    render_dir = os.path.join(cfg.train_dir, "render")
    os.makedirs(render_dir, exist_ok=True)
    timings = io_utils.TimingsLog(os.path.join(cfg.train_dir, "timings.txt"))
    timings.write(0)

    print("* Load train data")
    dataset = get_dataset("train", cfg)
    print("* Load test data")
    test_dataset = get_dataset("test", cfg)
    print("* Load model")
    model, state = get_model_state(cfg, seed=SEED, restore=True, device=device)
    init_step = state.step + 1
    train_step = engine.make_train_step(model, cfg)
    lr_fn = schedule_from_config(cfg)
    gen = torch.Generator(device=device)
    profiler = _Profile(cfg, device)

    with MetricsWriter(cfg.train_dir) as writer:
        gc.disable()
        stats_trace = []
        t_loop_start = time.time()
        batches = engine.device_batches(dataset, device)
        for step in range(init_step, cfg.max_steps + 1):
            gen.manual_seed(SEED + step)  # resume-stable, like fold_in(rng, step)
            profiler.before(step)
            state, stats, _ = train_step(state, next(batches), gen)
            profiler.after(step)
            stats_trace.append(stats)
            if step % cfg.gc_every == 0:
                gc.collect()

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
            if step % cfg.save_every == 0:
                print("* Saving")
                ckpt_utils.save_checkpoint(cfg.train_dir, state, step)

            if cfg.render_every > 0 and step % cfg.render_every == 0:
                print("\n* Rendering")
                t_eval_start = time.time()
                test_case = next(test_dataset)
                pred_color, pred_disp, pred_acc = engine.render_image(
                    model, test_case["rays"], chunk=cfg.chunk, device=device,
                    randomized=cfg.randomized, generator=gen,
                    normalize_disp=cfg.dataset == "llff",
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
        profiler.after(cfg.max_steps, last=True)
        gc.enable()
    timings.close()

    if cfg.max_steps % cfg.save_every != 0:
        ckpt_utils.save_checkpoint(cfg.train_dir, state, cfg.max_steps)
    return model, state


if __name__ == "__main__":
    main()
