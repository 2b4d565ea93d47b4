"""Coarse + fine NeRF with an SH or SG colour head.

Port of plenoctree_tpu/models/nerf.py for the SH and SG heads without view
conditioning (the blender configs, nerf_sh/config/misc/sg): stratified
coarse samples -> posenc -> MLP_0 -> SH / SG decode -> compositing ->
inverse-CDF fine resampling -> MLP_1 -> compositing. Submodules are named
MLP_0 / MLP_1 and the SG head's global parameters sg_lambda [N] and
sg_mu_spher [N, 2] (theta, phi) sit at the top level, so the state_dict
keys are flax's parameter paths (models/params.py).

With use_pallas the trunks run through the fused kernels, and, as in the
JAX package, two opt-in switches move more into them:
PN_POSENC_IN_KERNEL=1 (the kernels encode the raw points: training,
sparsity points and extraction's queries) and PN_SH_IN_KERNEL=1 (the
training forward's SH decode in the head's epilogue, against a basis
computed once per ray).

With the SG head (sg_dim > 0) the trunk emits 3 * sg_dim amplitudes and
the fused kernels run it unchanged (1 + 3 * sg_dim head columns); the
in-kernel decode is SH only, as in the JAX package.

Not ported yet, raising NotImplementedError that names ROADMAP.md:
use_viewdirs (the view-conditioned branch).

Random draws come from an explicit torch.Generator, or ready-made through
`draws` (keys 't_rand' [B, Sc], 'noise_c' [B, Sc], 'u' [B, Sf + 1],
'noise_f' [B, Sc + Sf]) so tests can feed both packages the same numbers.
"""

import os

import numpy as np
import torch
from torch import nn

from plenoctree_tpu_torch.models.mlp import TrunkMLP
from plenoctree_tpu_torch.models.params import (
    init_sg_params, init_trunk_params, params_from_flax,
)
from plenoctree_tpu_torch.ops import sampling as ops_sampling
from plenoctree_tpu_torch.ops.posenc import posenc
from plenoctree_tpu_torch.ops.rendering import volumetric_rendering
from plenoctree_tpu_torch.ops.sg import eval_sg
from plenoctree_tpu_torch.ops.sh import eval_sh, sh_basis

_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid}


def _activation(name, role):
    if str(name) not in _ACTIVATIONS:
        raise NotImplementedError(
            f"{role} `{name}` is not ported (ROADMAP.md); ported: {sorted(_ACTIVATIONS)}"
        )
    return _ACTIVATIONS[str(name)]


def _dtype(name):
    return torch.bfloat16 if str(name) == "bfloat16" else torch.float32


class NerfModel(nn.Module):
    """NeRF with a coarse (MLP_0) and a fine (MLP_1) trunk."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.use_viewdirs:
            raise NotImplementedError("use_viewdirs is not ported yet (ROADMAP.md)")
        if cfg.sh_deg >= 0 and cfg.sg_dim > 0:
            raise ValueError("You can only use up to one of: SH, SG or use_viewdirs.")
        if str(cfg.net_activation) != "relu":
            raise NotImplementedError("only the relu trunk is ported (ROADMAP.md)")
        self.num_coarse_samples = cfg.num_coarse_samples
        self.num_fine_samples = cfg.num_fine_samples
        self.sh_deg = cfg.sh_deg
        self.sg_dim = cfg.sg_dim
        self.near, self.far = cfg.near, cfg.far
        self.noise_std = cfg.noise_std
        self.white_bkgd = cfg.white_bkgd
        self.min_deg_point, self.max_deg_point = cfg.min_deg_point, cfg.max_deg_point
        self.lindisp = cfg.lindisp
        self.legacy_posenc_order = cfg.legacy_posenc_order
        self.rgb_activation = _activation(cfg.rgb_activation, "rgb_activation")
        self.sigma_activation = _activation(cfg.sigma_activation, "sigma_activation")
        self.compute_dtype = _dtype(getattr(cfg, "compute_dtype", "float32"))
        self.use_pallas = bool(getattr(cfg, "use_pallas", False))
        num_rgb = cfg.num_rgb_channels
        if cfg.sh_deg >= 0:
            num_rgb *= (cfg.sh_deg + 1) ** 2
        elif cfg.sg_dim > 0:
            num_rgb *= cfg.sg_dim
            # Filled by construct_nerf (init_sg_params) or a checkpoint.
            self.sg_lambda = nn.Parameter(torch.zeros(cfg.sg_dim))
            self.sg_mu_spher = nn.Parameter(torch.zeros(cfg.sg_dim, 2))
        self.d_in = 3 + (6 * (cfg.max_deg_point - cfg.min_deg_point)
                         if cfg.min_deg_point != cfg.max_deg_point else 0)
        mlp_kwargs = dict(
            d_in=self.d_in, net_depth=cfg.net_depth, net_width=cfg.net_width,
            skip_layer=cfg.skip_layer, num_rgb_channels=num_rgb,
            num_sigma_channels=cfg.num_sigma_channels, compute_dtype=self.compute_dtype,
        )
        self.MLP_0 = TrunkMLP(**mlp_kwargs)
        # Like the flax model's params, MLP_1 exists only with a fine pass.
        self.MLP_1 = TrunkMLP(**mlp_kwargs) if cfg.num_fine_samples > 0 else None

    def _use_fused(self, use_pallas=None):
        use = self.use_pallas if use_pallas is None else use_pallas
        return use and not self.legacy_posenc_order

    def _query_mlp(self, mlp, samples, fused, basis=None):
        """posenc + trunk on [B, S, 3] samples (the fused kernels when on).

        basis (fused path only): the per-ray SH basis [B, K]; the kernel
        then decodes the colour head in its epilogue and raw_rgb comes back
        as [B, S, C] (callers skip _decode_color). With PN_POSENC_IN_KERNEL=1
        the kernels encode the raw points themselves.
        """
        b, s = samples.shape[0], samples.shape[1]
        if not fused:
            return mlp(posenc(samples, self.min_deg_point, self.max_deg_point,
                              self.legacy_posenc_order))
        basis_rows = None
        if basis is not None:
            k = basis.shape[-1]
            basis_rows = basis[:, None, :].expand(b, s, k).reshape(-1, k)
        pe = None
        if (self.min_deg_point < self.max_deg_point
                and os.environ.get("PN_POSENC_IN_KERNEL", "0") == "1"):
            pe = (self.min_deg_point, self.max_deg_point)
            mlp_in = samples.reshape(-1, samples.shape[-1])
        else:
            enc = posenc(samples, self.min_deg_point, self.max_deg_point,
                         self.legacy_posenc_order)
            mlp_in = enc.reshape(-1, enc.shape[-1])
        raw_rgb, raw_sigma = mlp.fused_enc(mlp_in, basis=basis_rows, posenc=pe)
        return raw_rgb.reshape(b, s, -1), raw_sigma.reshape(b, s, -1)

    def _decode_color(self, raw_rgb, viewdirs):
        """SH / SG decode of [B, S, C*K] coefficients against viewdirs [B, 1, 3]."""
        if self.sg_dim > 0:
            coeffs = raw_rgb.reshape(raw_rgb.shape[:-1] + (-1, self.sg_dim))
            return eval_sg(self.sg_lambda, self.sg_mu_spher, coeffs, viewdirs)
        if self.sh_deg < 0:
            return raw_rgb
        k = (self.sh_deg + 1) ** 2
        if (
            self.compute_dtype == torch.bfloat16
            and raw_rgb.dim() == 3
            and viewdirs.dim() == 3
            and viewdirs.shape[1] == 1
        ):
            # The JAX package's flat train-path decode: a product with the
            # channel-tiled basis, then a [C*K, C] block-indicator matmul.
            nc = raw_rgb.shape[-1] // k
            basis = sh_basis(self.sh_deg, viewdirs[:, 0, :])  # [B, K]
            prod = raw_rgb * basis.repeat(1, nc)[:, None, :]
            j = torch.arange(nc * k, device=raw_rgb.device) // k
            sel = (j[:, None] == torch.arange(nc, device=raw_rgb.device)[None, :]).to(
                raw_rgb.dtype
            )
            return prod @ sel
        return eval_sh(self.sh_deg, raw_rgb.reshape(raw_rgb.shape[:-1] + (-1, k)), viewdirs)

    def eval_points_raw(self, points, coarse=False, use_pallas=None):
        """Raw trunk outputs at points [N, 3]: (raw_rgb [N, C*K], raw_sigma [N, 1])."""
        mlp = self.MLP_0 if (coarse or self.num_fine_samples <= 0) else self.MLP_1
        raw_rgb, raw_sigma = self._query_mlp(mlp, points[None], self._use_fused(use_pallas))
        return raw_rgb[0], raw_sigma[0]

    def forward(self, rays, randomized, generator=None, draws=None, use_pallas=None):
        """Render a batch of rays [B, 3]: [(rgb_c, disp_c, acc_c), (rgb, disp, acc)]."""
        d = draws or {}
        fused = self._use_fused(use_pallas)
        z_vals, samples = ops_sampling.sample_along_rays(
            rays.origins, rays.directions, self.num_coarse_samples, self.near, self.far,
            randomized, self.lindisp, generator, d.get("t_rand"),
        )
        viewdirs = rays.viewdirs[:, None]
        # In-kernel SH decode (opt-in, PN_SH_IN_KERNEL=1): the basis is per
        # ray, computed once here and contracted in the head's epilogue.
        decode_fused = (fused and self.sh_deg >= 0
                        and os.environ.get("PN_SH_IN_KERNEL", "0") == "1")
        basis = sh_basis(self.sh_deg, rays.viewdirs) if decode_fused else None
        ret = []
        weights = None
        for level, mlp in enumerate((self.MLP_0, self.MLP_1)):
            if level == 1:
                if self.num_fine_samples <= 0:
                    break
                z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
                z_vals, samples = ops_sampling.sample_pdf(
                    z_vals_mid, weights[..., 1:-1], rays.origins, rays.directions, z_vals,
                    self.num_fine_samples, randomized, generator, d.get("u"),
                )
            raw_rgb, raw_sigma = self._query_mlp(mlp, samples, fused, basis)
            if raw_sigma.shape[-1] == 1:
                raw_sigma = raw_sigma[..., 0]  # the [B, S] sigma form
            raw_sigma = ops_sampling.add_gaussian_noise(
                raw_sigma, self.noise_std, randomized, generator,
                d.get("noise_c" if level == 0 else "noise_f"),
            )
            if not decode_fused:
                raw_rgb = self._decode_color(raw_rgb, viewdirs)
            rgb = self.rgb_activation(raw_rgb)
            sigma = self.sigma_activation(raw_sigma)
            comp_rgb, disp, acc, weights = volumetric_rendering(
                rgb, sigma, z_vals, rays.directions, white_bkgd=self.white_bkgd
            )
            ret.append((comp_rgb, disp, acc))
        return ret


def construct_nerf(cfg, seed=0):
    """A NerfModel from a config namespace, with flax's init (glorot-uniform
    kernels, zero biases) drawn from numpy's generator at `seed`, and the SG
    head's parameters from init_sg_params (drawn after the trunks')."""
    model = NerfModel(cfg)
    rng = np.random.default_rng(seed)
    tree = {}
    for name in ("MLP_0", "MLP_1"):
        mlp = getattr(model, name)
        if mlp is None:
            continue
        tree[name] = init_trunk_params(
            rng, mlp.d_in, mlp.net_depth, mlp.net_width, mlp.skip_layer,
            mlp.num_sigma_channels, mlp.num_rgb_channels,
        )
    if cfg.sg_dim > 0:
        tree.update(init_sg_params(rng, cfg.sg_dim))
    model.load_state_dict(params_from_flax(tree))
    return model


def get_model(cfg, seed=0):
    if cfg.model != "nerf":
        raise NotImplementedError(f"model {cfg.model!r} is not ported (ROADMAP.md)")
    return construct_nerf(cfg, seed)


def get_model_state(cfg, seed=0, restore=True, device="cpu"):
    """(model on `device`, TrainState), restoring the newest checkpoint of
    cfg.train_dir when asked."""
    from plenoctree_tpu_torch.utils import checkpoints as ckpt_utils

    model = get_model(cfg, seed).to(device)
    state = ckpt_utils.create_train_state(model)
    if restore:
        state = ckpt_utils.restore_checkpoint(cfg.train_dir, state)
    return model, state
