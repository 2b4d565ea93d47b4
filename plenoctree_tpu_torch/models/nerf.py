"""Coarse + fine NeRF with an SH, SG or view-conditioned colour head.

Port of plenoctree_tpu/models/nerf.py: stratified coarse samples -> posenc
-> MLP_0 -> SH / SG decode -> compositing -> inverse-CDF fine resampling ->
MLP_1 -> compositing. Submodules are named MLP_0 / MLP_1 and the SG head's
global parameters sg_lambda [N] and sg_mu_spher [N, 2] (theta, phi) sit at
the top level, so the state_dict keys are flax's parameter paths
(models/params.py).

With use_viewdirs (nerf_sh/config/misc/og_nerf, proj) the trunks carry the
view-conditioned branch: the ray's view direction, encoded to deg_view,
joins each sample's bottleneck, and the rgb head gives colour directly. It
runs on the plain path only, as in the JAX package (its _use_fused excludes
use_viewdirs). The JAX model refuses sh_deg >= 0 together with
use_viewdirs, so it cannot build nerf_sh/config/misc/proj.yaml (use_viewdirs
with sh_deg 4), the config of extraction by SH projection; here sh_deg of a
use_viewdirs model is the projection's target degree and does not shape
the model (octree/extract.py). SG with use_viewdirs raises, as in JAX.

Activations are named as flax.linen names them (`activation_by_name`);
a name without an exact counterpart here raises.

With use_pallas the trunks run through the fused kernels, and, as in the
JAX package, two opt-in switches move more into them:
PN_POSENC_IN_KERNEL=1 (the kernels encode the raw points: training,
sparsity points and extraction's queries) and PN_SH_IN_KERNEL=1 (the
training forward's SH decode in the head's epilogue, against a basis
computed once per ray).

With the SG head (sg_dim > 0) the trunk emits 3 * sg_dim amplitudes and
the fused kernels run it unchanged (1 + 3 * sg_dim head columns); the
in-kernel decode is SH only, as in the JAX package.

The fused kernels apply ReLU between layers whatever net_activation says
(the JAX kernel's quirk: its _use_fused does not look at the activation, so
a non-relu trunk trains as relu there and evaluates with its own
activation); the port refuses use_pallas with a non-relu trunk.

Random draws come from an explicit torch.Generator, or ready-made through
`draws` (keys 't_rand' [B, Sc], 'noise_c' [B, Sc], 'u' [B, Sf + 1],
'noise_f' [B, Sc + Sf]) so tests can feed both packages the same numbers.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from plenoctree_tpu_torch.models.mlp import TrunkMLP
from plenoctree_tpu_torch.models.params import (
    init_mlp_params, init_sg_params, params_from_flax,
)
from plenoctree_tpu_torch.ops import sampling as ops_sampling
from plenoctree_tpu_torch.ops.posenc import posenc
from plenoctree_tpu_torch.ops.rendering import volumetric_rendering
from plenoctree_tpu_torch.ops.sg import eval_sg
from plenoctree_tpu_torch.ops.sh import eval_sh, sh_basis
from plenoctree_tpu_torch.utils import tracing

# flax.linen's element-wise activations, by name, with their defaults:
# gelu is the tanh approximation there (approximate=True), leaky_relu's
# slope 0.01, elu's and celu's alpha 1, softplus log(1 + e^x) exactly.
_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "celu": F.celu,
    "selu": F.selu,
    "leaky_relu": F.leaky_relu,
    "silu": F.silu,
    "swish": F.silu,
    "relu6": F.relu6,
    "hard_sigmoid": F.hardsigmoid,
    "hard_silu": F.hardswish,
    "hard_swish": F.hardswish,
    "hard_tanh": F.hardtanh,
    "soft_sign": F.softsign,
    "log_sigmoid": F.logsigmoid,
}


def activation_by_name(name):
    """flax.linen's activation of that name (the JAX package's
    getattr(flax.linen, name)); a name without a counterpart here raises."""
    if str(name) not in _ACTIVATIONS:
        raise ValueError(
            f"activation `{name}` has no counterpart in the port; known: {sorted(_ACTIVATIONS)}"
        )
    return _ACTIVATIONS[str(name)]


def _check_activations(rgb_activation, sigma_activation, cfg):
    """The JAX construct_nerf's probe over a huge dynamic range: colours in
    [0, 1], densities >= 0."""
    x = torch.exp(torch.linspace(-90, 90, 1024))
    x = torch.cat([-x.flip(0), x])
    rgb = rgb_activation(x)
    if (rgb < 0).any() or (rgb > 1).any():
        raise NotImplementedError(
            f"rgb_activation `{cfg.rgb_activation}` produces colors outside [0, 1]"
        )
    if (sigma_activation(x) < 0).any():
        raise NotImplementedError(
            f"sigma_activation `{cfg.sigma_activation}` produces negative densities"
        )


def _dtype(name):
    return torch.bfloat16 if str(name) == "bfloat16" else torch.float32


class NerfModel(nn.Module):
    """NeRF with a coarse (MLP_0) and a fine (MLP_1) trunk."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.sg_dim > 0 and (cfg.sh_deg >= 0 or cfg.use_viewdirs):
            raise ValueError("You can only use up to one of: SH, SG or use_viewdirs.")
        self.use_viewdirs = bool(cfg.use_viewdirs)
        self.deg_view = cfg.deg_view
        self.net_activation_name = str(cfg.net_activation)
        self.net_activation = activation_by_name(cfg.net_activation)
        self.num_coarse_samples = cfg.num_coarse_samples
        self.num_fine_samples = cfg.num_fine_samples
        # A use_viewdirs model decodes no SH: sh_deg names the projection's
        # degree at extraction only.
        self.sh_deg = -1 if self.use_viewdirs else cfg.sh_deg
        self.sg_dim = cfg.sg_dim
        self.near, self.far = cfg.near, cfg.far
        self.noise_std = cfg.noise_std
        self.white_bkgd = cfg.white_bkgd
        self.min_deg_point, self.max_deg_point = cfg.min_deg_point, cfg.max_deg_point
        self.lindisp = cfg.lindisp
        self.legacy_posenc_order = cfg.legacy_posenc_order
        self.rgb_activation = activation_by_name(cfg.rgb_activation)
        self.sigma_activation = activation_by_name(cfg.sigma_activation)
        _check_activations(self.rgb_activation, self.sigma_activation, cfg)
        self.compute_dtype = _dtype(getattr(cfg, "compute_dtype", "float32"))
        self.use_pallas = bool(getattr(cfg, "use_pallas", False))
        self._use_fused()  # refuses --use_pallas with a non-relu trunk up front
        num_rgb = cfg.num_rgb_channels
        if self.sh_deg >= 0:
            num_rgb *= (cfg.sh_deg + 1) ** 2
        elif cfg.sg_dim > 0:
            num_rgb *= cfg.sg_dim
            # Filled by construct_nerf (init_sg_params) or a checkpoint.
            self.sg_lambda = nn.Parameter(torch.zeros(cfg.sg_dim))
            self.sg_mu_spher = nn.Parameter(torch.zeros(cfg.sg_dim, 2))
        self.d_in = 3 + (6 * (cfg.max_deg_point - cfg.min_deg_point)
                         if cfg.min_deg_point != cfg.max_deg_point else 0)
        # posenc of the view directions: [x, sin/cos at deg_view octaves].
        self.d_view = 3 + 6 * cfg.deg_view
        mlp_kwargs = dict(
            d_in=self.d_in, net_depth=cfg.net_depth, net_width=cfg.net_width,
            skip_layer=cfg.skip_layer, num_rgb_channels=num_rgb,
            num_sigma_channels=cfg.num_sigma_channels, compute_dtype=self.compute_dtype,
            condition=self.use_viewdirs, d_condition=self.d_view if self.use_viewdirs else 0,
            net_depth_condition=cfg.net_depth_condition,
            net_width_condition=cfg.net_width_condition, activation=self.net_activation,
        )
        self.MLP_0 = TrunkMLP(**mlp_kwargs)
        # Like the flax model's params, MLP_1 exists only with a fine pass.
        self.MLP_1 = TrunkMLP(**mlp_kwargs) if cfg.num_fine_samples > 0 else None

    def _use_fused(self, use_pallas=None):
        use = self.use_pallas if use_pallas is None else use_pallas
        fused = use and not self.legacy_posenc_order and not self.use_viewdirs
        if fused and self.net_activation_name != "relu":
            raise ValueError(
                f"--use_pallas with net_activation `{self.net_activation_name}`: the fused "
                "trunk kernels apply ReLU between layers (as the JAX package's kernel does, "
                "which trains such a trunk as ReLU); use the plain path or a relu trunk"
            )
        return fused

    def _encode_viewdirs(self, viewdirs):
        """[..., 3] unit view directions -> [..., d_view] (posenc to deg_view)."""
        return posenc(viewdirs, 0, self.deg_view, self.legacy_posenc_order)

    def _query_mlp(self, mlp, samples, fused, basis=None, viewdirs_enc=None):
        """posenc + trunk on [B, S, 3] samples (the fused kernels when on).

        basis (fused path only): the per-ray SH basis [B, K]; the kernel
        then decodes the colour head in its epilogue and raw_rgb comes back
        as [B, S, C] (callers skip _decode_color). With PN_POSENC_IN_KERNEL=1
        the kernels encode the raw points themselves. Traced as `nerf.trunk`,
        counting the B * S rows handed to the trunk.
        """
        b, s = samples.shape[0], samples.shape[1]
        with tracing.span("nerf.trunk", rows=b * s):
            if not fused:
                return mlp(posenc(samples, self.min_deg_point, self.max_deg_point,
                                  self.legacy_posenc_order), viewdirs_enc)
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

    def eval_points_raw(self, points, coarse=False, use_pallas=None, viewdirs=None):
        """Raw trunk outputs at points [N, 3]: (raw_rgb [N, C*K], raw_sigma
        [N, 1]). A use_viewdirs model takes each point's view direction
        [N, 3]; without them it is queried at zero directions, which is all
        a sigma query needs (sigma does not depend on the view; the JAX
        package's eval_points_raw cannot run this case)."""
        mlp = self.MLP_0 if (coarse or self.num_fine_samples <= 0) else self.MLP_1
        if self.use_viewdirs:
            if viewdirs is None:
                viewdirs = torch.zeros_like(points)
            raw_rgb, raw_sigma = self._query_mlp(
                mlp, points[:, None], False, viewdirs_enc=self._encode_viewdirs(viewdirs)
            )
            return raw_rgb[:, 0], raw_sigma[:, 0]
        raw_rgb, raw_sigma = self._query_mlp(mlp, points[None], self._use_fused(use_pallas))
        return raw_rgb[0], raw_sigma[0]

    def eval_points_cross(self, points, viewdirs, coarse=False):
        """Every point [P, 3] against every direction [D, 3] (use_viewdirs
        models; SH projection at extraction): (raw_rgb [P, D, 3], raw_sigma
        [P, 1]), the trunk once per point."""
        if not self.use_viewdirs:
            raise ValueError("eval_points_cross needs a use_viewdirs model")
        mlp = self.MLP_0 if (coarse or self.num_fine_samples <= 0) else self.MLP_1
        enc = posenc(points, self.min_deg_point, self.max_deg_point, self.legacy_posenc_order)
        return mlp.cross(enc, self._encode_viewdirs(viewdirs))

    def forward(self, rays, randomized, generator=None, draws=None, use_pallas=None):
        """Render a batch of rays [B, 3]: [(rgb_c, disp_c, acc_c), (rgb, disp, acc)].
        Each level (sampling, trunk, decode, compositing) is traced as
        `nerf.coarse` / `nerf.fine`."""
        d = draws or {}
        fused = self._use_fused(use_pallas)
        viewdirs = rays.viewdirs[:, None]
        viewdirs_enc = self._encode_viewdirs(rays.viewdirs) if self.use_viewdirs else None
        # In-kernel SH decode (opt-in, PN_SH_IN_KERNEL=1): the basis is per
        # ray, computed once here and contracted in the head's epilogue.
        decode_fused = (fused and self.sh_deg >= 0
                        and os.environ.get("PN_SH_IN_KERNEL", "0") == "1")
        basis = sh_basis(self.sh_deg, rays.viewdirs) if decode_fused else None
        ret = []
        weights = None
        for level, mlp in enumerate((self.MLP_0, self.MLP_1)):
            if level == 1 and self.num_fine_samples <= 0:
                break
            with tracing.span("nerf.fine" if level else "nerf.coarse"):
                if level == 0:
                    z_vals, samples = ops_sampling.sample_along_rays(
                        rays.origins, rays.directions, self.num_coarse_samples, self.near,
                        self.far, randomized, self.lindisp, generator, d.get("t_rand"),
                    )
                else:
                    z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
                    z_vals, samples = ops_sampling.sample_pdf(
                        z_vals_mid, weights[..., 1:-1], rays.origins, rays.directions, z_vals,
                        self.num_fine_samples, randomized, generator, d.get("u"),
                    )
                raw_rgb, raw_sigma = self._query_mlp(mlp, samples, fused, basis, viewdirs_enc)
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
        tree[name] = init_mlp_params(rng, mlp)
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
