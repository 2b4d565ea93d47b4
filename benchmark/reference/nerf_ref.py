"""Plain reference of the NeRF-SH training step, in float32 PyTorch.

It imports nothing of the program. Given the same initial parameters (a
dict name -> tensor, kernels [in, out] as flax lays them out), the same
batches and the same random draws, it takes the steps of JaxNeRF's
training loss with PlenOctrees' SH head and sparsity loss, and Adam:

  * coarse samples: stratified in [near, far], jittered by t_rand [B, Sc];
  * fine samples: the coarse weights' piecewise-constant pdf inverted at
    sorted uniforms, which are the normalised cumulative sums of the
    exponentials -log(1 - u) of u [B, Sf + 1] (equal in distribution to
    JaxNeRF's sorted i.i.d. uniforms), merged with the coarse depths;
  * each trunk: posenc to max_deg_point octaves, depth x width ReLU
    layers with [h, x] concatenated after layer i when i % skip == 0 and
    i > 0, a sigma head, an rgb head of 3 (sh_deg + 1)^2 coefficients; the
    colour sigmoid(SH basis . coefficients), sigma relu;
  * alpha compositing with eps 1e-10 and a 1e10 last interval, onto white;
  * loss = fine MSE + coarse MSE + sparsity_weight * (1 - exp(-length *
    relu(sigma))).mean() at draws['sp_points'] through the fine trunk;
  * Adam (b1 0.9, b2 0.999, eps 1e-8) at the log-linear learning rate of
    the step.

Every matrix product runs in float32 with TF32 off, unless `quant` names a
lower precision for its operands (the control: 'fp8' computes every
product, forward and backward, from float8 operands with per-tensor scales).
"""

import math

import numpy as np
import torch

from benchmark.reference.octree_ref import sh_basis

B1, B2, EPS = 0.9, 0.999, 1e-8


def _fp8(x, dtype=torch.float8_e4m3fn):
    """x rounded to float8 under a per-tensor scale (amax to the format's
    largest finite value), back in float32."""
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with the operands of every product in float8, as an FP8
    training step computes them: e4m3 activations and weights in the
    forward, e5m2 cotangents in the backward (per-tensor scales)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        return qg @ qb.T, qa.T @ qg


def _mm(a, b, quant):
    if quant == "fp8":
        return _Fp8MatMul.apply(a, b)
    return a @ b


def posenc(x, max_deg):
    scales = torch.tensor([2.0 ** i for i in range(max_deg)], dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi], -1))], -1)


def trunk(p, prefix, x, cfg, quant):
    """(raw_rgb [N, C], raw_sigma [N]) of trunk `prefix` at encoded x [N, F]."""
    depth, skip = cfg["net_depth"], cfg["skip_layer"]
    inputs, h = x, x
    for i in range(depth):
        h = torch.relu(_mm(h, p[f"{prefix}.Dense_{i}.kernel"], quant)
                       + p[f"{prefix}.Dense_{i}.bias"])
        if i % skip == 0 and i > 0:
            h = torch.cat([h, inputs], -1)
    sigma = _mm(h, p[f"{prefix}.Dense_{depth}.kernel"], quant) + p[f"{prefix}.Dense_{depth}.bias"]
    rgb = (_mm(h, p[f"{prefix}.Dense_{depth + 1}.kernel"], quant)
           + p[f"{prefix}.Dense_{depth + 1}.bias"])
    return rgb, sigma[:, 0]


def composite(rgb, sigma, z, dirs):
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
    dists = dists * dirs.norm(dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cat([torch.ones_like(alpha[:, :1]),
                       torch.cumprod(1.0 - alpha[:, :-1] + 1e-10, -1)], -1)
    w = alpha * trans
    comp = (w[..., None] * rgb).sum(1)
    return comp + (1.0 - w.sum(-1))[:, None], w


def inverse_cdf(bins, weights, u):
    eps = 1e-5
    wsum = weights.sum(-1, keepdim=True)
    pad = torch.clamp(eps - wsum, min=0.0)
    weights = weights + pad / weights.shape[-1]
    wsum = wsum + pad
    pdf = weights / wsum
    cdf = torch.clamp(torch.cumsum(pdf[:, :-1], -1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf, torch.ones_like(cdf[:, :1])], -1)
    idx = torch.searchsorted(cdf, u, right=True)
    below = (idx - 1).clamp(0, cdf.shape[-1] - 1)
    above = idx.clamp(0, cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    t = torch.clamp(torch.nan_to_num((u - c0) / (c1 - c0), nan=0.0), 0.0, 1.0)
    return (b0 + t * (b1 - b0)).detach()


def render_loss(p, batch, draws, cfg, quant=None):
    """(total loss, parts) of one batch."""
    o, d, vd = batch["origins"], batch["directions"], batch["viewdirs"]
    pixels = batch["pixels"][:, :3]
    nc_ = cfg["num_coarse_samples"]
    near, far, deg = cfg["near"], cfg["far"], cfg["max_deg_point"]
    k = (cfg["sh_deg"] + 1) ** 2
    basis = sh_basis(cfg["sh_deg"], vd)
    tv = torch.linspace(0.0, 1.0, nc_, device=o.device)
    z = near * (1.0 - tv) + far * tv
    mids = 0.5 * (z[1:] + z[:-1])
    upper = torch.cat([mids, z[-1:]])
    lower = torch.cat([z[:1], mids])
    z = lower + (upper - lower) * draws["t_rand"]
    out = []
    w = None
    for level, prefix in enumerate(("MLP_0", "MLP_1")):
        if level == 1:
            zm = 0.5 * (z[:, 1:] + z[:, :-1])
            e = -torch.log1p(-draws["u"])
            s = torch.cumsum(e, -1)
            us = s[:, :-1] / torch.clamp(s[:, -1:], min=1e-12)
            zs = inverse_cdf(zm, w[:, 1:-1].detach(), us)
            z = torch.sort(torch.cat([z, zs], -1), -1).values
        pts = o[:, None, :] + z[..., None] * d[:, None, :]
        raw_rgb, raw_sigma = trunk(p, prefix, posenc(pts, deg).reshape(-1, 3 + 6 * deg), cfg,
                                   quant)
        n, s_ = pts.shape[0], pts.shape[1]
        coef = raw_rgb.reshape(n, s_, 3, k)
        rgb = torch.sigmoid((coef * basis[:, None, None, :]).sum(-1))
        comp, w = composite(rgb, torch.relu(raw_sigma.reshape(n, s_)), z, d)
        out.append(comp)
    loss_c = ((out[0] - pixels) ** 2).mean()
    loss_f = ((out[1] - pixels) ** 2).mean()
    _, sp_sigma = trunk(p, "MLP_1", posenc(draws["sp_points"], deg), cfg, quant)
    loss_sp = cfg["sparsity_weight"] * (
        1.0 - torch.exp(-cfg["sparsity_length"] * torch.relu(sp_sigma)).mean())
    return loss_f + loss_c + loss_sp, (loss_f, loss_c, loss_sp)


def learning_rate(step, cfg):
    f32 = np.float32
    t = np.clip(f32(step) / f32(cfg["max_steps"]), 0, 1)
    return float(f32(np.exp(f32(np.log(cfg["lr_init"])) * (1 - t)
                            + f32(np.log(cfg["lr_final"])) * t)))


def train_steps(params, batches, draws, cfg, quant=None):
    """Adam steps from `params` over the given batches and draws. Returns
    (losses [steps], first gradients {name: tensor}, parameters after)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        p = {k: v.detach().clone().float().requires_grad_(True) for k, v in params.items()}
        mu = {k: torch.zeros_like(v) for k, v in p.items()}
        nu = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, first = [], None
        for step, (batch, dr) in enumerate(zip(batches, draws)):
            loss, _ = render_loss(p, batch, dr, cfg, quant)
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(p, grads)}
            count = step + 1
            lr = learning_rate(step, cfg)
            with torch.no_grad():
                for (k, v), g in zip(p.items(), grads):
                    mu[k].mul_(B1).add_(g * (1 - B1))
                    nu[k].mul_(B2).add_(g.square() * (1 - B2))
                    u = (mu[k] / (1 - B1 ** count)) / ((nu[k] / (1 - B2 ** count)).sqrt() + EPS)
                    v.add_(u * -lr)
        return losses, first, {k: v.detach() for k, v in p.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
