"""Spherical gaussians with learnable sharpness and lobe directions.

Port of plenoctree_tpu/ops/sg.py: output = (1/N) * sum_i coeffs_i *
exp(lambda_i * (mu_i . d - 1)), with lambda made positive by softplus and
lobe directions optionally in spherical (theta, phi) form. The products
are full f32 (TF32 is off package-wide), as the JAX package's
precision="highest".
"""

import torch
import torch.nn.functional as F


def spher2cart(r, theta, phi):
    """Spherical (r, theta, phi) -> Cartesian [..., 3]."""
    sin_t = torch.sin(theta)
    return torch.stack(
        [r * sin_t * torch.cos(phi), r * sin_t * torch.sin(phi), r * torch.cos(theta)], dim=-1
    )


def eval_sg(sg_lambda, sg_mu, sg_coeffs, dirs):
    """Evaluate spherical gaussians at unit directions.

    Args:
      sg_lambda: [N] or [..., N] raw lobe sharpness (softplus applied here).
      sg_mu: [N, 2|3] or [..., N, 2|3] lobe directions; 2 = (theta, phi).
      sg_coeffs: [..., C, N] lobe amplitudes per channel.
      dirs: [..., 3] unit directions.

    Returns:
      [..., C] decoded channel values.
    """
    sg_lambda = F.softplus(sg_lambda)
    if sg_mu.shape[-1] == 2:
        sg_mu = spher2cart(1.0, sg_mu[..., 0], sg_mu[..., 1])
    cosine = torch.einsum("...ij,...j->...i", sg_mu, dirs)
    basis = torch.exp(sg_lambda * (cosine - 1.0))
    out = torch.einsum("...ck,...k->...c", sg_coeffs, basis)
    return out / sg_lambda.shape[-1]


def euler2mat(angle):
    """Euler angles [..., 3] (x, y, z, radians) -> rotation matrices [..., 3, 3]."""
    x, y, z = angle[..., 0], angle[..., 1], angle[..., 2]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    zero, one = torch.zeros_like(z), torch.ones_like(z)

    def mat(*rows):  # stacked along the last axis twice, as the reference does
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-1)

    zmat = mat((cz, -sz, zero), (sz, cz, zero), (zero, zero, one))
    ymat = mat((cy, zero, sy), (zero, one, zero), (-sy, zero, cy))
    xmat = mat((one, zero, zero), (zero, cx, -sx), (zero, sx, cx))
    return torch.einsum("...ij,...jk,...kq->...iq", xmat, ymat, zmat)
