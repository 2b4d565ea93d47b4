"""Render options and the per-ray colour basis.

Port of plenoctree_tpu/octree/renderer.py::RenderOptions and _ray_basis.
The exact-march renderer (`VolumeRenderer`, `render_rays`) is not ported
yet (ROADMAP.md).
"""

from dataclasses import dataclass

import torch

from plenoctree_tpu_torch.ops.sh import sh_basis


@dataclass(frozen=True)
class RenderOptions:
    """Parity: svox RenderOptions (octree/extraction.py:184-188)."""

    step_size: float = 1e-4
    background_brightness: float = 1.0
    stop_thresh: float = 0.0  # transmittance early-stop (fast mode: 1e-2)
    sigma_thresh: float = 0.0  # skip leaves with sigma below (fast: 1e-2)
    max_segments: int = 256  # scan length bound (training path)


def _ray_basis(fmt, basis_dim, viewdirs, extra_data):
    """Per-ray color basis [R, basis_dim] from world view directions.

    SH: the real SH basis; SG: exp(lambda * (mu . d - 1)) from the tree's
    extra_data [K, 4] = (lambda, mu xyz); RGBA: ones. The SG cosine is an
    explicit f32 sum (the JAX einsum runs at precision="highest").
    """
    if fmt == "SH":
        deg = int(round(basis_dim**0.5)) - 1
        return sh_basis(deg, viewdirs)
    if fmt == "SG":
        sg_lambda = extra_data[:, 0]
        sg_mu = extra_data[:, 1:4]
        cosine = (
            sg_mu[None, :, 0] * viewdirs[:, None, 0]
            + sg_mu[None, :, 1] * viewdirs[:, None, 1]
            + sg_mu[None, :, 2] * viewdirs[:, None, 2]
        )
        return torch.exp(sg_lambda[None, :] * (cosine - 1.0))
    return torch.ones(viewdirs.shape[:-1] + (1,), dtype=viewdirs.dtype, device=viewdirs.device)
