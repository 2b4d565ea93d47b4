"""Sinusoidal positional encoding.

Port of plenoctree_tpu/ops/posenc.py: the input followed by sin features
at scales 2^[min_deg, max_deg), cos written as a phase-shifted sin, in the
blocked [sin..., cos...] order or the legacy interleaved one.
"""

import functools
import math

import torch


def posenc(x, min_deg, max_deg, legacy_posenc_order=False):
    """[..., D] -> [..., D + 2*D*(max_deg - min_deg)] encoded features, input first."""
    if min_deg == max_deg:
        return x
    xb = x[..., None, :] * _scales(min_deg, max_deg, x.dtype, x.device)[:, None]  # [..., F, D]
    half_pi = 0.5 * math.pi
    if legacy_posenc_order:
        four_feat = torch.sin(torch.stack([xb, xb + half_pi], dim=-2))
        four_feat = four_feat.reshape(x.shape[:-1] + (-1,))
    else:
        flat = xb.reshape(x.shape[:-1] + (-1,))
        four_feat = torch.sin(torch.cat([flat, flat + half_pi], dim=-1))
    return torch.cat([x, four_feat], dim=-1)


@functools.lru_cache(maxsize=None)
def _scales(min_deg, max_deg, dtype, device):
    """2^[min_deg, max_deg) on `device`, made once per (degrees, dtype,
    device): a copy from the host to a GPU waits for the device, and cannot
    run inside a captured CUDA graph (engine.py's train step)."""
    return torch.tensor([2.0**i for i in range(min_deg, max_deg)], dtype=dtype, device=device)
