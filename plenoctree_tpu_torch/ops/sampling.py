"""Ray sampling: stratified coarse samples and inverse-CDF fine resampling.

Port of plenoctree_tpu/ops/sampling.py. Every random draw can be handed in
ready-made (`t_rand`, `u`, `noise`), so a test can feed the JAX package and
the port the same numbers; otherwise it comes from the given
`torch.Generator` (on the tensors' device).

The randomized (training) fine samples are sorted uniforms built without a
sort, from normalised cumulative sums of exponentials, as in the JAX
package. The JAX package merges them with the coarse depths by rank
arithmetic (`_merge_sorted`, a TPU-friendly formulation); the port sorts
the concatenation, which gives identical values. Eval calls keep the
reference-exact sort of the concatenation.
"""

import torch


def cast_rays(z_vals, origins, directions):
    """Point positions [..., S, 3] from per-ray z values [..., S]."""
    return origins[..., None, :] + z_vals[..., None] * directions[..., None, :]


def _uniform(shape, like, generator):
    return torch.rand(shape, dtype=like.dtype, device=like.device, generator=generator)


def sample_along_rays(origins, directions, num_samples, near, far, randomized, lindisp,
                      generator=None, t_rand=None):
    """Stratified samples: (z_vals [B, S], points [B, S, 3]). `t_rand` [B, S]
    is the uniform draw of the randomized case."""
    batch_size = origins.shape[0]
    t_vals = torch.linspace(0.0, 1.0, num_samples, dtype=origins.dtype, device=origins.device)
    if lindisp:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    if randomized:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        if t_rand is None:
            t_rand = _uniform((batch_size, num_samples), origins, generator)
        z_vals = lower + (upper - lower) * t_rand
    else:
        z_vals = z_vals[None].expand(batch_size, num_samples)
    return z_vals, cast_rays(z_vals, origins, directions)


def _inverse_cdf(bins, weights, u):
    """Invert the piecewise-constant CDF over `bins` at positions `u`."""
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], -1)

    # x0 = value at the last edge with cdf <= u, x1 = at the first edge after.
    mask = u[..., None, :] >= cdf[..., :, None]  # [B, edges, samples]

    def find_interval(x):
        x0 = torch.amax(torch.where(mask, x[..., None], x[..., :1, None]), dim=-2)
        x1 = torch.amin(torch.where(~mask, x[..., None], x[..., -1:, None]), dim=-2)
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0), 0.0, 1.0)
    return (bins_g0 + t * (bins_g1 - bins_g0)).detach()


def piecewise_constant_pdf(bins, weights, num_samples, randomized, generator=None, u=None):
    """[B, num_samples] samples of the piecewise-constant distribution over
    `bins` (i.i.d. uniforms `u` when randomized, a linspace otherwise)."""
    shape = weights.shape[:-1] + (num_samples,)
    if randomized:
        if u is None:
            u = _uniform(shape, weights, generator)
    else:
        eps32 = torch.finfo(torch.float32).eps
        u = torch.linspace(0.0, 1.0 - eps32, num_samples, dtype=weights.dtype,
                           device=weights.device).expand(shape)
    return _inverse_cdf(bins, weights, u)


def _sorted_uniform(shape, like, generator=None, u=None):
    """Sorted U(0,1) order statistics without a sort: normalised cumulative
    sums of i.i.d. exponentials. `u` [..., n + 1] is the uniform draw."""
    if u is None:
        u = _uniform(shape[:-1] + (shape[-1] + 1,), like, generator)
    e = -torch.log1p(-u)
    s = torch.cumsum(e, dim=-1)
    return s[..., :-1] / torch.clamp(s[..., -1:], min=1e-12)


def sample_pdf(bins, weights, origins, directions, z_vals, num_samples, randomized,
               generator=None, u=None):
    """Fine samples merged with the coarse z_vals: (z_vals [B, Sc + Sf],
    points [B, Sc + Sf, 3]). Randomized: `u` [B, Sf + 1] is the uniform draw
    behind the sorted uniforms."""
    if randomized:
        us = _sorted_uniform(weights.shape[:-1] + (num_samples,), weights, generator, u)
        z_samples = _inverse_cdf(bins, weights, us)
    else:
        z_samples = piecewise_constant_pdf(bins, weights, num_samples, False)
    z_vals = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
    return z_vals, cast_rays(z_vals, origins, directions)


def add_gaussian_noise(raw, noise_std, randomized, generator=None, noise=None):
    """Additive density noise (training only); `noise` is the N(0, 1) draw."""
    if (noise_std is not None) and noise_std > 0 and randomized:
        if noise is None:
            noise = torch.randn(raw.shape, dtype=raw.dtype, device=raw.device,
                                generator=generator)
        return raw + noise * noise_std
    return raw
