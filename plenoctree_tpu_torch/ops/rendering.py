"""Volumetric alpha compositing.

Port of plenoctree_tpu/ops/rendering.py with the same constants: eps 1e-10
in the transmittance product and the disparity guard, and the 1e10 far-cap
distance after the last sample.
"""

import torch


def volumetric_rendering(rgb, sigma, z_vals, dirs, white_bkgd):
    """Composite per-sample colors/densities into per-ray outputs.

    Args:
      rgb: [B, S, 3] activated sample colours.
      sigma: [B, S] (the train path's form) or [B, S, 1] activated densities.
      z_vals: [B, S] sample depths.
      dirs: [B, 3] ray directions (unnormalised).
      white_bkgd: composite onto white.

    Returns:
      comp_rgb [B, 3], disp [B], acc [B], weights [B, S].
    """
    eps = 1e-10
    dists = torch.cat(
        [z_vals[..., 1:] - z_vals[..., :-1], torch.full_like(z_vals[..., :1], 1e10)], dim=-1
    )
    dists = dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    if sigma.dim() == rgb.dim():
        sigma = sigma[..., 0]
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cat(
        [torch.ones_like(alpha[..., :1]), _CumProd.apply(1.0 - alpha[..., :-1] + eps)], dim=-1
    )
    weights = alpha * trans
    comp_rgb = torch.einsum("...s,...sc->...c", weights, rgb)
    depth = torch.sum(weights * z_vals, dim=-1)
    acc = torch.sum(weights, dim=-1)
    inv_eps = 1.0 / eps
    disp = acc / depth
    disp = torch.where(
        (disp > 0) & (disp < inv_eps) & (acc > eps), disp, torch.full_like(disp, inv_eps)
    )
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return comp_rgb, disp, acc, weights


class _CumProd(torch.autograd.Function):
    """torch.cumprod over the last axis, with the backward ATen takes when no
    factor is zero: the reversed cumulative sum of output * grad, over the
    factors; bitwise ATen's gradient there. ATen first tests the factors
    for a zero by copying a flag to the host, which waits for the device
    and cannot be captured in a CUDA graph (engine.py's train step). The
    transmittance's factors 1 - alpha + eps are at least eps (alpha in
    [0, 1]), so the test is left out."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)
