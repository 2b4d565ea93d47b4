"""The NeRF trunk MLP as an nn.Module.

Port of plenoctree_tpu/models/mlp.py: `net_depth` x `net_width` layers with
a skip concat [h, x] after layer i when i % skip == 0 and i > 0, a sigma
head, and either an rgb head straight off the trunk (SH / SG heads) or,
with `condition`, the view-conditioned branch: a bottleneck Dense, the
encoded view direction concatenated to it, `net_depth_condition` layers of
`net_width_condition`, then the rgb head. Layers are `Dense_0 .. Dense_n`
in call order (trunk, sigma, [bottleneck, condition layers,] rgb), as flax
names them, and store flax's layouts (kernel [in, out], bias [out]), so
`MLP_k.Dense_i.kernel` is flax's `MLP_k/Dense_i/kernel` unchanged
(models/params.py). `activation` is the trunk's and the condition layers'
nonlinearity (models/nerf.py::activation_by_name).

Two forwards, as in the JAX package:
  * `forward` (the flax `__call__`; `cross` evaluates every point against
    every direction): plain PyTorch. compute_dtype bfloat16 casts inputs,
    kernels and biases to bf16 as flax's nn.Dense(dtype=bfloat16) does
    (bf16 products and bias adds); float32 is full f32. Every render and
    eval uses it, and every model with the view-conditioned branch.
  * `fused_enc`: the training path with use_pallas (no view branch); packs
    the layers as pack_params_traced does ([W_sigma | W_rgb] head concat as
    a differentiable torch op) and calls the fused trunk kernels
    (kernels/fused_mlp.py), whose gradients flow back to every Dense.
"""

import torch
from torch import nn

from plenoctree_tpu_torch.kernels import fused_mlp


class Dense(nn.Module):
    """flax nn.Dense with its parameter layout: y = x @ kernel + bias.

    Sharded over a model axis (parallel/partition.py sets `tp`), kernel and
    bias hold this rank's output columns: the forward computes them and
    gathers the whole output (TrunkMLP.flat_weights gathers the whole
    weights instead, for the fused kernels)."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.tp = None

    def forward(self, x, dtype=torch.float32):
        if self.tp is not None:
            x = self.tp.copy_in(x)
        if dtype == torch.float32:
            y = x.float() @ self.kernel + self.bias
        else:
            y = torch.matmul(x.to(dtype), self.kernel.to(dtype)) + self.bias.to(dtype)
        return y if self.tp is None else self.tp.gather(y)


class TrunkMLP(nn.Module):
    """Trunk + sigma head + (optional) view-conditioned branch + rgb head.

    With condition=True, d_condition is the width of the encoded view
    direction the branch concatenates to the bottleneck."""

    def __init__(self, d_in, net_depth=8, net_width=256, skip_layer=4, num_rgb_channels=3,
                 num_sigma_channels=1, condition=False, compute_dtype=torch.float32,
                 d_condition=0, net_depth_condition=1, net_width_condition=128,
                 activation=torch.relu):
        super().__init__()
        if condition and d_condition <= 0:
            raise ValueError("the view-conditioned branch needs d_condition > 0")
        self.d_in = d_in
        self.net_depth = net_depth
        self.net_width = net_width
        self.skip_layer = skip_layer
        self.num_rgb_channels = num_rgb_channels
        self.num_sigma_channels = num_sigma_channels
        self.condition = bool(condition)
        self.compute_dtype = compute_dtype
        self.activation = activation
        names = iter(f"Dense_{i}" for i in range(net_depth + net_depth_condition + 3))

        def dense(k, n):
            name = next(names)
            setattr(self, name, Dense(k, n))
            return name

        k = d_in
        self.trunk_names = []
        for i in range(net_depth):
            self.trunk_names.append(dense(k, net_width))
            k = net_width + d_in if (i % skip_layer == 0 and i > 0) else net_width
        self.sigma_name = dense(k, num_sigma_channels)
        self.cond_names = []
        if self.condition:
            self.bottleneck_name = dense(k, net_width)
            k = net_width + d_condition
            for _ in range(net_depth_condition):
                self.cond_names.append(dense(k, net_width_condition))
                k = net_width_condition
        self.rgb_name = dense(k, num_rgb_channels)

    def layers(self):
        """Every Dense in call order (trunk, sigma, [bottleneck, condition
        layers,] rgb)."""
        names = self.trunk_names + [self.sigma_name]
        if self.condition:
            names += [self.bottleneck_name] + self.cond_names
        return [getattr(self, n) for n in names + [self.rgb_name]]

    def _trunk(self, x):
        """[rows, F] -> trunk features [rows, W (+ F after a final skip)]."""
        dt = self.compute_dtype
        inputs = x
        for i, name in enumerate(self.trunk_names):
            x = self.activation(getattr(self, name)(x, dt))
            if i % self.skip_layer == 0 and i > 0:
                x = torch.cat([x, inputs], dim=-1)
        return x

    def _condition_branch(self, bottleneck, condition):
        x = torch.cat([bottleneck, condition], dim=-1)
        for name in self.cond_names:
            x = self.activation(getattr(self, name)(x, self.compute_dtype))
        return x

    def forward(self, x, condition=None):
        """[B, S, F] encoded points (and, with the view branch, [B, F_view]
        encoded view directions shared by a ray's samples) ->
        (raw_rgb [B, S, C], raw_sigma [B, S, 1]) f32."""
        num_samples = x.shape[1]
        dt = self.compute_dtype
        x = self._trunk(x.reshape(-1, x.shape[-1]).to(dt))
        raw_sigma = getattr(self, self.sigma_name)(x, dt).float()
        if condition is not None:
            b = getattr(self, self.bottleneck_name)(x, dt)
            cond = condition[:, None, :].to(dt).expand(-1, num_samples, -1)
            x = self._condition_branch(b, cond.reshape(-1, condition.shape[-1]))
        raw_rgb = getattr(self, self.rgb_name)(x, dt).float()
        return (
            raw_rgb.reshape(-1, num_samples, self.num_rgb_channels),
            raw_sigma.reshape(-1, num_samples, self.num_sigma_channels),
        )

    def cross(self, x, condition):
        """Every point against every direction (the view branch only): x
        [P, F] encoded points, condition [D, F_view] encoded directions ->
        (raw_rgb [P, D, C], raw_sigma [P, 1]) f32. The trunk runs once per
        point; only the condition branch runs per (point, direction)."""
        dt = self.compute_dtype
        x = self._trunk(x.to(dt))
        raw_sigma = getattr(self, self.sigma_name)(x, dt).float()
        b = getattr(self, self.bottleneck_name)(x, dt)
        p, d = b.shape[0], condition.shape[0]
        bb = b[:, None, :].expand(p, d, b.shape[-1]).reshape(p * d, -1)
        cc = condition[None].to(dt).expand(p, d, condition.shape[-1]).reshape(p * d, -1)
        out = self._condition_branch(bb, cc)
        raw_rgb = getattr(self, self.rgb_name)(out, dt).float().reshape(p, d, -1)
        return raw_rgb, raw_sigma

    def flat_weights(self, posenc=None, sh_dim=0):
        """(flat_w, meta) of the fused kernels, built from the parameters with
        differentiable ops; meta as pack_params_traced(..., posenc, sh_dim)."""
        if self.condition:
            raise ValueError("the fused trunk kernels have no view-conditioned branch")
        layers = self.layers()
        depth = self.net_depth
        kernels, biases = [l.kernel for l in layers], [l.bias for l in layers]
        sharded = [i for i, l in enumerate(layers) if l.tp is not None]
        if sharded:  # whole weights from a model axis, in one collective
            whole = layers[sharded[0]].tp.gather_all(
                [kernels[i] for i in sharded] + [biases[i] for i in sharded])
            for j, i in enumerate(sharded):
                kernels[i], biases[i] = whole[j], whole[len(sharded) + j]
        flat = []
        for k, b in zip(kernels[:depth], biases[:depth]):
            flat += [k, b.reshape(1, -1)]
        flat.append(torch.cat(kernels[depth : depth + 2], dim=1))
        flat.append(torch.cat(biases[depth : depth + 2]).reshape(1, -1))
        meta = dict(
            depth=depth, d_in=self.d_in, width=self.net_width,
            d_out=self.num_sigma_channels + self.num_rgb_channels,
            skip_layer=self.skip_layer, posenc=posenc, x_dim=3 if posenc else self.d_in,
            n_sigma=self.num_sigma_channels, sh_dim=sh_dim,
        )
        return flat, meta

    def fused_enc(self, x, basis=None, posenc=None):
        """Fused kernel path, as the flax TrunkMLP.fused_enc.

        x: [N, d_in] encoded points, or with `posenc` = (min_deg, max_deg)
        the raw [N, 3] points, encoded inside the kernel. basis: optional
        per-row SH basis [N, K]; the head's C*K coefficients are then
        contracted against it in the kernel's epilogue and raw_rgb comes
        back decoded, [N, C]. Returns (raw_rgb, raw_sigma [N, n_sigma]) f32;
        gradients reach the weights, not x or the basis.
        """
        sh_dim = 0 if basis is None else basis.shape[-1]
        flat, meta = self.flat_weights(posenc, sh_dim)
        if basis is not None:
            basis = basis.float()
        raw_sigma, raw_rgb = fused_mlp.FusedTrunkFn.apply(meta, x, basis, *flat)
        return raw_rgb, raw_sigma
