"""Real spherical-harmonic basis evaluation, degrees 0..4.

Port of plenoctree_tpu/ops/sh.py: the same constants and the same
expression order, so a basis computed here and one computed by the JAX
package agree to f32 rounding.
"""

import torch

SH_C0 = 0.28209479177387814  # 1/(2 sqrt(pi))
SH_C1 = 0.4886025119029199  # sqrt(3)/(2 sqrt(pi))
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def sh_basis(deg, dirs):
    """Evaluate the real SH basis at unit directions.

    Args:
      deg: int in [0, 4], max SH degree.
      dirs: [..., 3] unit direction vectors.

    Returns:
      [..., (deg+1)**2] basis values b such that color = sum_k coeff_k * b_k.
    """
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {deg}")
    x = dirs[..., 0]
    y = dirs[..., 1]
    z = dirs[..., 2]
    one = torch.ones_like(x)
    out = [SH_C0 * one]
    if deg >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if deg >= 3:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if deg >= 4:
        out += [
            SH_C4[0] * xy * (xx - yy),
            SH_C4[1] * yz * (3.0 * xx - yy),
            SH_C4[2] * xy * (7.0 * zz - 1.0),
            SH_C4[3] * yz * (7.0 * zz - 3.0),
            SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            SH_C4[5] * xz * (7.0 * zz - 3.0),
            SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            SH_C4[7] * xz * (xx - 3.0 * yy),
            SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(deg, sh, dirs):
    """Evaluate SH-coefficient colors at unit directions.

    Args:
      deg: int in [0, 4].
      sh: [..., C, (deg+1)**2] SH coefficients.
      dirs: [..., 3] unit directions, broadcastable against sh's batch dims.

    Returns:
      [..., C] decoded channel values, contracted in full f32 (the JAX
      default precision="highest"; TF32 is off package-wide).
    """
    k = (deg + 1) ** 2
    if sh.shape[-1] != k:
        raise ValueError(f"expected {k} SH coeffs for deg {deg}, got {sh.shape[-1]}")
    basis = sh_basis(deg, dirs)
    return torch.einsum("...ck,...k->...c", sh, basis)
