"""Octree evaluation: render all test views, compute PSNR/SSIM/LPIPS.

Port of plenoctree_tpu/octree/evaluate.py (parity: octree/nerf/utils.py
:448-498, eval_octree). Metrics default to the exact march
(`VolumeRenderer`, per-ray hit ordering, svox semantics; NDC for LLFF
configs); `--fast_eval` opts into the tile renderer, the serving path.
LPIPS uses the port's VGG-LPIPS (ops/lpips.py) when its weights file is
available, else NaN. `--fast_eval --shard_devices N` (N > 1) shards the
tile compositing over the first N CUDA devices (TileRenderer(mesh=...));
more than are visible raises.
"""

import numpy as np
import torch

from plenoctree_tpu_torch.octree.renderer import VolumeRenderer, make_ndc_config
from plenoctree_tpu_torch.ops.lpips import get_lpips_fn
from plenoctree_tpu_torch.ops.metrics import compute_psnr, compute_ssim


def eval_octree(tree, dataset, cfg, want_lpips=True, want_frames=False, device="cuda"):
    """Returns (avg_psnr, avg_ssim, avg_lpips, frames)."""
    w, h, focal = dataset.w, dataset.h, dataset.focal
    ndc_config = None
    if cfg.config is not None and "llff" in str(cfg.config) and not cfg.spherify:
        ndc_config = make_ndc_config(w, h, focal)

    if getattr(cfg, "fast_eval", False):
        from plenoctree_tpu_torch.octree.tile_render import TileRenderer

        mesh = None
        nshard = int(getattr(cfg, "shard_devices", 0) or 0)
        if nshard > 1:
            from plenoctree_tpu_torch.parallel import make_mesh

            visible = torch.cuda.device_count()
            if nshard > visible:
                raise ValueError(
                    f"--shard_devices {nshard} but {visible} CUDA devices are visible"
                )
            mesh = make_mesh(devices=[torch.device("cuda", i) for i in range(nshard)])
        thr = 1e-2 if not cfg.no_early_stop else 0.0
        tile_r = TileRenderer(
            tree,
            step_size=cfg.renderer_step_size,
            sigma_thresh=thr,
            stop_thresh=thr,
            ndc=ndc_config,
            mesh=mesh,
            device=device,
        )
        dev = tile_r.device

        def render(c2w):
            return tile_r.render_persp(c2w, h, w, focal)

    else:
        march_r = VolumeRenderer(
            tree,
            step_size=cfg.renderer_step_size,
            ndc=ndc_config,
            max_segments=getattr(cfg, "max_segments", 0) or None,
            device=device,
        )
        dev = march_r.device

        def render(c2w):
            return march_r.render_persp(
                c2w, height=h, width=w, fx=focal, fast=not cfg.no_early_stop
            )

    lpips_fn = get_lpips_fn(dev) if want_lpips else None

    avg_psnr, avg_ssim, avg_lpips = 0.0, 0.0, 0.0
    n_lpips = 0
    out_frames = []
    for idx in range(dataset.size):
        c2w = dataset.camtoworlds[idx]
        im_gt = dataset.images[idx].reshape(h, w, -1)[..., :3]
        im = np.clip(render(c2w), 0.0, 1.0)

        mse = float(((im - im_gt) ** 2).mean())
        avg_psnr += float(compute_psnr(mse))
        avg_ssim += float(
            compute_ssim(
                torch.from_numpy(im).to(dev), torch.from_numpy(im_gt).to(dev), max_val=1.0
            )
        )
        if lpips_fn is not None:
            avg_lpips += lpips_fn(im_gt, im)
            n_lpips += 1
        if want_frames:
            out_frames.append((im * 255).astype(np.uint8))

    avg_psnr /= dataset.size
    avg_ssim /= dataset.size
    avg_lpips = avg_lpips / n_lpips if n_lpips else float("nan")
    return avg_psnr, avg_ssim, avg_lpips, out_frames
