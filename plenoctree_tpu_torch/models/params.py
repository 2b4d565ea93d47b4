"""Weights carried across between the flax parameter tree and the port.

The port's modules keep flax's names and layouts: `MLP_k.Dense_i.kernel`
is flax's `MLP_k/Dense_i/kernel`, an [in, out] matrix (not transposed), and
the SG head's `sg_lambda` / `sg_mu_spher` sit at the top level in both, so
both directions are a renaming. Pure numpy and torch: no flax import.
"""

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


def params_from_flax(tree):
    """Nested {'MLP_0': {'Dense_i': {'kernel', 'bias'}}, ...} of arrays (a
    flax `params` collection; a leading 'params' level is accepted) -> a
    state_dict of f32 tensors keyed 'MLP_0.Dense_i.kernel'."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in _flatten(tree).items()
    }


def params_to_flax(module_or_state):
    """The inverse of params_from_flax: an nn.Module (or a state_dict / dict of
    named tensors) -> the nested flax params dict of numpy arrays."""
    if isinstance(module_or_state, torch.nn.Module):
        module_or_state = module_or_state.state_dict()
    tree = {}
    for name, t in module_or_state.items():
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.detach().cpu().numpy()
    return tree


def glorot_uniform(rng, fan_in, fan_out):
    """flax's default Dense kernel init (variance_scaling 1, fan_avg, uniform)."""
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)


def init_trunk_params(rng, d_in, depth, width, skip, n_sigma, n_rgb, bias_std=0.0):
    """Seeded flax-layout params of one trunk (no view branch): Dense_0 ..
    Dense_{depth-1}, the sigma head Dense_{depth} and the rgb head
    Dense_{depth+1}; glorot-uniform kernels, biases N(0, bias_std) (flax
    initialises them to 0)."""
    params = {}
    k = d_in
    for i in range(depth):
        params[f"Dense_{i}"] = {
            "kernel": glorot_uniform(rng, k, width),
            "bias": (rng.normal(0.0, bias_std, width) if bias_std else np.zeros(width)).astype(
                np.float32
            ),
        }
        k = width + d_in if (i % skip == 0 and i > 0) else width
    for j, n in enumerate((n_sigma, n_rgb)):
        params[f"Dense_{depth + j}"] = {
            "kernel": glorot_uniform(rng, k, n),
            "bias": (rng.normal(0.0, bias_std, n) if bias_std else np.zeros(n)).astype(
                np.float32
            ),
        }
    return params


def init_mlp_params(rng, mlp):
    """Seeded flax-layout params of a TrunkMLP, the view-conditioned branch
    included: every Dense_i in call order gets a glorot-uniform kernel drawn
    from `rng` and a zero bias (flax's init; for a trunk without the branch
    the draws of init_trunk_params)."""
    return {
        f"Dense_{i}": {
            "kernel": glorot_uniform(rng, *layer.kernel.shape),
            "bias": np.zeros(layer.bias.shape[0], np.float32),
        }
        for i, layer in enumerate(mlp.layers())
    }


def init_sg_params(rng, n):
    """The SG head's global parameters, seeded: sg_lambda = 1 [n] and
    sg_mu_spher [n, 2] = (theta, phi) uniform in [0, pi) x [0, 2 pi), as
    the JAX model initialises them. The JAX model draws them from a fixed
    jax.random.PRNGKey(0), whose stream numpy cannot reproduce, so the two
    packages start from other lobe directions; a checkpoint carries either
    side's values across (utils/checkpoints.py)."""
    theta = rng.random((n, 1)) * np.pi
    phi = rng.random((n, 1)) * 2.0 * np.pi
    return {
        "sg_lambda": np.ones(n, np.float32),
        "sg_mu_spher": np.concatenate([theta, phi], axis=-1).astype(np.float32),
    }


def trunk_weights(params, skip_layer, device=None, posenc=None, sh_dim=0):
    """A trunk's flax params -> (flat_w, meta) of the fused kernels (f32,
    detached), packed by TrunkMLP.flat_weights as the model packs them (with
    the kernels' in-kernel posenc / SH decode variants when asked)."""
    from plenoctree_tpu_torch.models.mlp import TrunkMLP

    names = sorted(params, key=lambda k: int(k.split("_")[1]))
    depth = len(names) - 2
    k0 = np.asarray(params[names[0]]["kernel"])
    n_sigma = np.asarray(params[names[depth]]["kernel"]).shape[1]
    n_rgb = np.asarray(params[names[depth + 1]]["kernel"]).shape[1]
    mlp = TrunkMLP(k0.shape[0], depth, k0.shape[1], skip_layer, n_rgb, n_sigma)
    mlp.load_state_dict(params_from_flax(params))
    flat, meta = mlp.flat_weights(posenc, sh_dim)
    return [t.detach() if device is None else t.detach().to(device) for t in flat], meta
