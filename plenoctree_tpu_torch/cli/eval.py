"""NeRF-SH evaluation CLI: chunked full-image test renders, PSNR/SSIM.

Port of plenoctree_tpu/cli/eval.py: restore the newest checkpoint of
--train_dir, render every --approx_eval_skip-th test view through
engine.render_image (the plain forward, as the JAX package's inference
model; with --device cuda each chunk split over every visible GPU, shaped
by --mesh_shape), print PSNR/SSIM per image and on average, write
`psnr.txt` and `ssim.txt` into the train dir and the `eval_psnr` /
`eval_ssim` scalars into `<train_dir>/eval/metrics.jsonl`, and with
--save_output (the default) `test_preds/{idx:03d}.png` and
`disp_{idx:03d}.png`. With --render_path (LLFF: the spiral, or the circle
when spherified) it renders the path's poses into `path_renders/` and
computes no metrics. LLFF disparities are min-max normalised per image.
Without --eval_once it polls: every 10 s it looks for a newer checkpoint,
and it stops after evaluating one at --max_steps.

Under `python -m torch.distributed.run` (or in a process group its caller
made) every rank renders its share of each chunk on its own device
(cuda:LOCAL_RANK for --device cuda, or the one device named, e.g.
`--device cuda:0 --dist_backend gloo`), the shares are gathered in rank
order (engine.render_image), and rank 0 alone computes the metrics and
writes anything, as the JAX CLI's process 0; --mesh_shape must then cover
the ranks' devices together.

Usage:
  python -m plenoctree_tpu_torch.cli.eval --config nerf_sh/config/blender \\
      --data_dir <scene dir> --train_dir <ckpt dir> --chunk 4096
  python -m torch.distributed.run --nproc_per_node 8 -m plenoctree_tpu_torch.cli.eval \\
      <the same flags>                    # one rank per GPU
"""

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from plenoctree_tpu_torch import engine, parallel
from plenoctree_tpu_torch.data import get_dataset
from plenoctree_tpu_torch.models.nerf import get_model_state
from plenoctree_tpu_torch.ops.metrics import compute_psnr, compute_ssim
from plenoctree_tpu_torch.utils import config as config_lib
from plenoctree_tpu_torch.utils import io as io_utils
from plenoctree_tpu_torch.utils.metrics_writer import MetricsWriter

SEED = 20200823  # the JAX CLI's PRNGKey seed (model init before the restore)
POLL_SECONDS = 10.0


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--synthetic_resolution", type=int, default=64,
        help="image side of the procedural scene (--dataset synthetic)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to render on; 'cuda' raises when there is no GPU",
    )
    parallel.mesh.add_dist_backend_flag(parser)
    config_lib.add_flags(parser)
    return parser


def main(argv=None, devices=None):
    """Returns (average PSNR, average SSIM) of the last checkpoint evaluated
    (NaN with --render_path, which computes no metrics, and on ranks other
    than 0). `devices` overrides the device list the renders are split
    over."""
    cfg = config_lib.parse_flags(build_parser(), argv)
    if cfg.train_dir is None:
        raise ValueError("train_dir must be set. None set now.")
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False")
    with parallel.mesh.cli_group(cfg.dist_backend, device) as (rank, _, device):
        return _evaluate(cfg, parallel.cli_devices(cfg, device, devices), rank == 0)


def _evaluate(cfg, devices, lead):
    device = devices[0]
    dataset = get_dataset("test", cfg)
    out_dir = os.path.join(cfg.train_dir, "path_renders" if cfg.render_path else "test_preds")
    if cfg.save_output and lead:
        os.makedirs(out_dir, exist_ok=True)
    last_step = 0
    avg_psnr = avg_ssim = float("nan")
    eval_dir = os.path.join(cfg.train_dir, "eval")
    with (MetricsWriter(eval_dir) if lead else contextlib.nullcontext()) as writer:
        while True:
            model, state = get_model_state(cfg, seed=SEED, restore=True, device=device)
            step = int(state.step)
            if step <= last_step and not cfg.eval_once:
                time.sleep(POLL_SECONDS)
                continue
            model.eval()
            psnr_values, ssim_values = [], []
            for idx in range(dataset.size):
                case = next(dataset)
                if idx % cfg.approx_eval_skip != 0:
                    continue
                if lead:
                    print(f"Evaluating {idx + 1}/{dataset.size}")
                pred_color, pred_disp, _ = engine.render_image(
                    model, case["rays"], chunk=cfg.chunk, device=device,
                    normalize_disp=cfg.dataset == "llff", devices=devices,
                )
                if not lead:
                    continue
                if not cfg.render_path:
                    gt = case["pixels"]
                    psnr = float(compute_psnr(float(np.mean((pred_color - gt) ** 2))))
                    # On the render device, as the JAX CLI computes it: the CPU's
                    # convolutions sum in an order that follows its thread count.
                    ssim = float(compute_ssim(
                        torch.from_numpy(pred_color).to(device),
                        torch.from_numpy(np.asarray(gt, np.float32)).to(device), 1.0,
                    ))
                    print(f"  PSNR = {psnr:.4f}, SSIM = {ssim:.4f}")
                    psnr_values.append(psnr)
                    ssim_values.append(ssim)
                if cfg.save_output:
                    io_utils.save_img(pred_color, os.path.join(out_dir, f"{idx:03d}.png"))
                    io_utils.save_img(
                        pred_disp[..., 0], os.path.join(out_dir, f"disp_{idx:03d}.png")
                    )
            if lead and not cfg.render_path:
                avg_psnr = float(np.mean(psnr_values))
                avg_ssim = float(np.mean(ssim_values))
                writer.scalar("eval_psnr", avg_psnr, step)
                writer.scalar("eval_ssim", avg_ssim, step)
                with open(os.path.join(cfg.train_dir, "psnr.txt"), "w") as f:
                    f.write(f"{avg_psnr}")
                with open(os.path.join(cfg.train_dir, "ssim.txt"), "w") as f:
                    f.write(f"{avg_ssim}")
                print(f"Average over {len(psnr_values)} images: PSNR {avg_psnr:.4f} "
                      f"SSIM {avg_ssim:.4f}")
            if cfg.eval_once or step >= cfg.max_steps:
                break
            last_step = step
    return avg_psnr, avg_ssim


if __name__ == "__main__":
    main()
