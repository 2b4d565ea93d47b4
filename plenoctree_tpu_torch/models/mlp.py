"""The NeRF trunk MLP as an nn.Module.

Port of plenoctree_tpu/models/mlp.py for the SH/SG trunk (no view branch):
`net_depth` x `net_width` ReLU layers with a skip concat [h, x] after layer
i when i % skip == 0 and i > 0, a sigma head and an rgb head. Layers are
`Dense_0 .. Dense_{depth+1}` in call order and store flax's layouts (kernel
[in, out], bias [out]), so `MLP_k.Dense_i.kernel` is flax's
`MLP_k/Dense_i/kernel` unchanged (models/params.py).

Two forwards, as in the JAX package:
  * `forward` (the flax `__call__`): plain PyTorch. compute_dtype bfloat16
    casts inputs, kernels and biases to bf16 as flax's
    nn.Dense(dtype=bfloat16) does (bf16 products and bias adds); float32 is
    full f32. Every render and eval uses it.
  * `fused_enc`: the training path with use_pallas; packs the layers as
    pack_params_traced does ([W_sigma | W_rgb] head concat as a
    differentiable torch op) and calls the fused trunk kernels
    (kernels/fused_mlp.py), whose gradients flow back to every Dense.
"""

import torch
from torch import nn

from plenoctree_tpu_torch.kernels import fused_mlp


class Dense(nn.Module):
    """flax nn.Dense with its parameter layout: y = x @ kernel + bias."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x, dtype=torch.float32):
        if dtype == torch.float32:
            return x.float() @ self.kernel + self.bias
        return torch.matmul(x.to(dtype), self.kernel.to(dtype)) + self.bias.to(dtype)


class TrunkMLP(nn.Module):
    """Trunk + sigma head + rgb head (no view-conditioned branch)."""

    def __init__(self, d_in, net_depth=8, net_width=256, skip_layer=4, num_rgb_channels=3,
                 num_sigma_channels=1, condition=False, compute_dtype=torch.float32):
        super().__init__()
        if condition:
            raise NotImplementedError(
                "the view-conditioned branch (use_viewdirs) is not ported yet (ROADMAP.md)"
            )
        self.d_in = d_in
        self.net_depth = net_depth
        self.net_width = net_width
        self.skip_layer = skip_layer
        self.num_rgb_channels = num_rgb_channels
        self.num_sigma_channels = num_sigma_channels
        self.compute_dtype = compute_dtype
        k = d_in
        for i in range(net_depth):
            setattr(self, f"Dense_{i}", Dense(k, net_width))
            k = net_width + d_in if (i % skip_layer == 0 and i > 0) else net_width
        setattr(self, f"Dense_{net_depth}", Dense(k, num_sigma_channels))
        setattr(self, f"Dense_{net_depth + 1}", Dense(k, num_rgb_channels))

    def layers(self):
        """Dense_0 .. Dense_{depth+1} in call order (trunk, sigma, rgb)."""
        return [getattr(self, f"Dense_{i}") for i in range(self.net_depth + 2)]

    def forward(self, x):
        """[B, S, F] encoded points -> (raw_rgb [B, S, C], raw_sigma [B, S, 1]) f32."""
        num_samples = x.shape[1]
        dt = self.compute_dtype
        x = x.reshape(-1, x.shape[-1]).to(dt)
        inputs = x
        layers = self.layers()
        for i in range(self.net_depth):
            x = torch.relu(layers[i](x, dt))
            if i % self.skip_layer == 0 and i > 0:
                x = torch.cat([x, inputs], dim=-1)
        raw_sigma = layers[self.net_depth](x, dt).float()
        raw_rgb = layers[self.net_depth + 1](x, dt).float()
        return (
            raw_rgb.reshape(-1, num_samples, self.num_rgb_channels),
            raw_sigma.reshape(-1, num_samples, self.num_sigma_channels),
        )

    def flat_weights(self, posenc=None, sh_dim=0):
        """(flat_w, meta) of the fused kernels, built from the parameters with
        differentiable ops; meta as pack_params_traced(..., posenc, sh_dim)."""
        layers = self.layers()
        depth = self.net_depth
        flat = []
        for layer in layers[:depth]:
            flat += [layer.kernel, layer.bias.reshape(1, -1)]
        sig, rgb = layers[depth], layers[depth + 1]
        flat.append(torch.cat([sig.kernel, rgb.kernel], dim=1))
        flat.append(torch.cat([sig.bias, rgb.bias]).reshape(1, -1))
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
