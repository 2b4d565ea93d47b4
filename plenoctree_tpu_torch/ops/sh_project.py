"""Monte-Carlo spherical-harmonic projection of view-dependent functions.

Port of plenoctree_tpu/ops/sh_project.py: project a per-point directional
radiance function onto the SH basis (ops/sh.py::sh_basis, the basis the
renderers decode with) by uniform sphere sampling, or by least squares.
The directions come from an explicit numpy Generator, drawn as the JAX
package draws them, so both packages project against the same directions.
The function's values may be torch tensors (on any device) or numpy; the
projection runs where they are and returns tensors there.
"""

import numpy as np
import torch

from plenoctree_tpu_torch.ops.sh import sh_basis


def spherical_uniform_dirs(sample_count, rng):
    """[S, 3] f32 uniform directions on the sphere (area-preserving map);
    draws 2 * S uniforms from the numpy Generator `rng`."""
    u1 = rng.random(sample_count)
    u2 = rng.random(sample_count)
    theta = np.arccos(2.0 * u1 - 1.0)
    phi = 2.0 * np.pi * u2
    sin_t = np.sin(theta)
    return np.stack(
        [sin_t * np.cos(phi), sin_t * np.sin(phi), np.cos(theta)], axis=-1
    ).astype(np.float32)


def _values_and_basis(order, spherical_fn, sample_count, rng):
    dirs = spherical_uniform_dirs(sample_count, rng)
    values, sigma = spherical_fn(dirs)
    values = torch.as_tensor(values, dtype=torch.float32)
    basis = sh_basis(order, torch.from_numpy(dirs).to(values.device))  # [S, K]
    return values, sigma, basis


def project_function_nerf(order, spherical_fn, sample_count, rng):
    """Monte-Carlo projection of a batched directional function onto SH.

    spherical_fn: dirs [S, 3] (numpy) -> (values [P, S, C], sigma);
    returns (coeffs [P, C, (order + 1)^2] f32, sigma passed through): the
    sphere integral estimated as 4 pi / S * sum_s f(d_s) Y_k(d_s)."""
    values, sigma, basis = _values_and_basis(order, spherical_fn, sample_count, rng)
    coeffs = torch.einsum("psc,sk->pck", values, basis) * (4.0 * np.pi / sample_count)
    return coeffs, sigma


def project_function_nerf_sparse(order, spherical_fn, sample_count, rng):
    """The least-squares variant: solve basis @ coeffs = values (more
    accurate for few samples); same arguments and result layout. Solved in
    float64 on the host, as numpy's lstsq in the JAX package."""
    values, sigma, basis = _values_and_basis(order, spherical_fn, sample_count, rng)
    p, s, c = values.shape
    v = values.cpu().numpy().transpose(1, 0, 2).reshape(s, p * c)
    sol, *_ = np.linalg.lstsq(basis.cpu().numpy(), v, rcond=None)
    coeffs = sol.reshape(-1, p, c).transpose(1, 2, 0)  # [P, C, K]
    return torch.from_numpy(np.ascontiguousarray(coeffs, np.float32)).to(values.device), sigma
