"""Octree evaluation: render all test views, compute PSNR/SSIM/LPIPS.

Port of plenoctree_tpu/octree/evaluate.py, `--fast_eval` branch only: the
views are rendered by the tile renderer (the serving path). The exact-march
renderer behind the JAX default is not ported yet, and without
`--fast_eval` this raises rather than substituting another renderer.
LPIPS reports NaN, as the JAX package does without `$LPIPS_WEIGHTS_NPZ`;
with that variable set this raises, since the VGG port does not exist yet.
"""

import os

import numpy as np
import torch

from plenoctree_tpu_torch.octree.tile_render import TileRenderer
from plenoctree_tpu_torch.ops.metrics import compute_psnr, compute_ssim


def eval_octree(tree, dataset, cfg, want_lpips=True, want_frames=False, device="cuda"):
    """Returns (avg_psnr, avg_ssim, avg_lpips, frames)."""
    w, h, focal = dataset.w, dataset.h, dataset.focal
    if not getattr(cfg, "fast_eval", False):
        raise NotImplementedError(
            "octree evaluation without --fast_eval needs the exact-march "
            "renderer, which is not ported yet (ROADMAP.md); pass --fast_eval "
            "to evaluate with the tile renderer"
        )
    ndc_config = None
    if cfg.config is not None and "llff" in str(cfg.config) and not cfg.spherify:
        ndc_config = {"width": w, "height": h, "focal": focal}
    if int(getattr(cfg, "shard_devices", 0) or 0) > 1:
        raise NotImplementedError(
            "--shard_devices > 1 (multi-device tile serving) is not ported "
            "yet; see ROADMAP.md"
        )
    if want_lpips and os.environ.get("LPIPS_WEIGHTS_NPZ"):
        raise NotImplementedError(
            "LPIPS_WEIGHTS_NPZ is set but the LPIPS (VGG16) metric is not "
            "ported yet (ROADMAP.md); unset it to report LPIPS as NaN"
        )

    fast = not cfg.no_early_stop
    thr = 1e-2 if fast else 0.0
    tile_r = TileRenderer(
        tree,
        step_size=cfg.renderer_step_size,
        sigma_thresh=thr,
        stop_thresh=thr,
        ndc=ndc_config,
        device=device,
    )
    dev = tile_r.device

    avg_psnr, avg_ssim = 0.0, 0.0
    out_frames = []
    for idx in range(dataset.size):
        c2w = dataset.camtoworlds[idx]
        im_gt = dataset.images[idx].reshape(h, w, -1)[..., :3]
        im = tile_r.render_persp(c2w, h, w, focal)
        im = np.clip(im, 0.0, 1.0)

        mse = float(((im - im_gt) ** 2).mean())
        avg_psnr += float(compute_psnr(mse))
        avg_ssim += float(
            compute_ssim(
                torch.from_numpy(im).to(dev), torch.from_numpy(im_gt).to(dev), max_val=1.0
            )
        )
        if want_frames:
            out_frames.append((im * 255).astype(np.uint8))

    avg_psnr /= dataset.size
    avg_ssim /= dataset.size
    return avg_psnr, avg_ssim, float("nan"), out_frames
