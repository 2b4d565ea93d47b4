"""The fused trunk's plain PyTorch versions against the JAX package's Pallas
kernels, run interpreted on the CPU as tests/test_kernels.py runs them.

Depth 6, width 64, skip 4 (layer 5 reads [h, x]), d_in 63 (posenc 0..10),
head 1 + 12 (SH degree 1), 1,500 rows: a ragged tail against both the
JAX 1024-row tile and the CUDA 64-row tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from plenoctree_tpu.kernels import fused_mlp as jfk
from plenoctree_tpu.models.mlp import TrunkMLP as JaxTrunkMLP
from plenoctree_tpu_torch.kernels import fused_mlp as tfk
from plenoctree_tpu_torch.models.mlp import TrunkMLP
from plenoctree_tpu_torch.models.params import (
    init_trunk_params,
    params_from_flax,
    params_to_flax,
    trunk_weights,
)

DEPTH, WIDTH, SKIP, D_IN, N_RGB, ROWS = 6, 64, 4, 63, 12, 1500
# Plain version vs the interpreted Pallas kernel: the same bf16 rounding
# points, f32 sums in another order. Measured on this CPU: forward 8.3e-4
# max abs (a bf16 activation rounding the other way near a boundary),
# per-layer grads 2.7e-4 max relative; the bounds leave headroom for the
# seed and the BLAS.
FWD_ATOL = 5e-3
GRAD_RTOL = 2e-3


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    params = init_trunk_params(rng, D_IN, DEPTH, WIDTH, SKIP, 1, N_RGB, bias_std=0.05)
    x = rng.normal(size=(ROWS, D_IN)).astype(np.float32)
    gs = rng.normal(size=(ROWS, 1)).astype(np.float32)
    gr = rng.normal(size=(ROWS, N_RGB)).astype(np.float32)
    flat, meta = jfk.pack_params(params, skip_layer=SKIP)
    fused = jfk.make_fused_trunk(meta)
    js, jr = fused(flat, jnp.asarray(x))

    def loss(fw):
        s, r = fused(fw, jnp.asarray(x))
        return jnp.vdot(s, gs) + jnp.vdot(r, gr)

    jg = jax.grad(loss)(tuple(flat))
    return dict(
        params=params, x=x, gs=gs, gr=gr, meta=trunk_weights(params, SKIP)[1],
        jax_out=(np.asarray(js), np.asarray(jr)), jax_grads=[np.asarray(g) for g in jg],
    )


def _flat(case):
    return trunk_weights(case["params"], SKIP)[0]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def test_meta_matches_jax_packing(case):
    _, meta = jfk.pack_params(case["params"], skip_layer=SKIP)
    assert case["meta"] == meta


def test_reference_forward_matches_pallas(case):
    flat = _flat(case)
    s, r = tfk.fused_trunk_reference(flat, torch.from_numpy(case["x"]), case["meta"])
    js, jr = case["jax_out"]
    assert s.shape == js.shape and r.shape == jr.shape
    assert np.abs(s.numpy() - js).max() <= FWD_ATOL
    assert np.abs(r.numpy() - jr).max() <= FWD_ATOL


def test_reference_backward_matches_pallas(case):
    flat = _flat(case)
    grads = tfk.fused_trunk_bwd_reference(
        flat, torch.from_numpy(case["x"]), torch.from_numpy(case["gs"]),
        torch.from_numpy(case["gr"]), case["meta"],
    )
    assert len(grads) == len(case["jax_grads"])
    for i, (g, jg) in enumerate(zip(grads, case["jax_grads"])):
        assert tuple(g.shape) == jg.shape, i
        assert _rel(g.numpy(), jg) <= GRAD_RTOL, i


def test_wrapper_runs_plain_version_on_cpu(case):
    flat = _flat(case)
    x = torch.from_numpy(case["x"])
    before = (tfk.fwd_launches, tfk.bwd_launches)
    s, r = tfk.fused_trunk(flat, x, case["meta"])
    rs, rr = tfk.fused_trunk_reference(flat, x, case["meta"])
    assert torch.equal(s, rs) and torch.equal(r, rr)
    g = tfk.fused_trunk_bwd(flat, x, torch.from_numpy(case["gs"]), torch.from_numpy(case["gr"]),
                            case["meta"])
    assert len(g) == len(flat)
    assert (tfk.fwd_launches, tfk.bwd_launches) == before  # no kernel on the CPU


def test_autograd_function_matches_backward_reference(case):
    flat = [t.requires_grad_() for t in _flat(case)]
    x = torch.from_numpy(case["x"]).requires_grad_()
    s, r = tfk.FusedTrunkFn.apply(case["meta"], x, *flat)
    (s * torch.from_numpy(case["gs"])).sum().add((r * torch.from_numpy(case["gr"])).sum()).backward()
    ref = tfk.fused_trunk_bwd_reference(
        [t.detach() for t in flat], x.detach(), torch.from_numpy(case["gs"]),
        torch.from_numpy(case["gr"]), case["meta"],
    )
    assert all(torch.equal(t.grad, g) for t, g in zip(flat, ref))
    assert x.grad is None  # positions get no gradient, as in the JAX package


@pytest.mark.parametrize("bad", [{"posenc": (0, 10)}, {"sh_dim": 4}])
def test_unported_variants_raise(case, bad):
    flat = _flat(case)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfk.fused_trunk(flat, torch.from_numpy(case["x"]), dict(case["meta"], **bad))


def test_wrapper_rejects_bad_dtypes(case):
    flat = _flat(case)
    x = torch.from_numpy(case["x"])
    with pytest.raises(TypeError):
        tfk.fused_trunk(flat, x.double(), case["meta"])
    with pytest.raises(TypeError):
        tfk.fused_trunk([t.bfloat16() for t in flat], x, case["meta"])
    with pytest.raises(ValueError):
        tfk.fused_trunk(flat, x[:, :10], case["meta"])


def test_packed_layout_round_trips(case):
    """The kernels' packed layout (K padded to 16, h rows then x rows, head
    N padded) holds every weight once, where _unpack_grads reads it."""
    flat = _flat(case)
    w_pack, b_pack = tfk._pack(flat, case["meta"])
    layers, xp, np_, w_total, b_total = tfk._layout(case["meta"])
    assert (xp, np_) == (64, 16) and w_pack.numel() == w_total and b_pack.numel() == b_total
    back = tfk._unpack_grads(w_pack.float(), b_pack, flat, case["meta"])
    for a, b in zip(back, flat):
        assert torch.equal(a, b.bfloat16().float() if a.shape[0] > 1 else b)
    assert float(w_pack.float().abs().sum()) == pytest.approx(
        sum(float(t.bfloat16().float().abs().sum()) for t in flat[::2]), rel=1e-6
    )


def test_trunk_fused_enc_grads_split_like_flax(case):
    """TrunkMLP.fused_enc (port, from params_from_flax) against flax's
    fused_enc (Pallas, interpreted): outputs, and gradients that split the
    [W_sigma | W_rgb] head back onto Dense_6 and Dense_7."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(300, D_IN)).astype(np.float32)
    gt = rng.normal(size=(300, 1 + N_RGB)).astype(np.float32)
    jmlp = JaxTrunkMLP(net_depth=DEPTH, net_width=WIDTH, skip_layer=SKIP,
                       num_rgb_channels=N_RGB, condition=False,
                       compute_dtype=jnp.bfloat16, use_pallas=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, case["params"])

    def jloss(p):
        rgb, sigma = jmlp.apply({"params": p}, jnp.asarray(x), method=jmlp.fused_enc)
        return jnp.vdot(jnp.concatenate([sigma, rgb], -1), gt)

    jgrad = jax.grad(jloss)(jparams)
    tmlp = TrunkMLP(D_IN, DEPTH, WIDTH, SKIP, N_RGB, compute_dtype=torch.bfloat16)
    tmlp.load_state_dict(params_from_flax(case["params"]))
    rgb, sigma = tmlp.fused_enc(torch.from_numpy(x))
    torch.vdot(torch.cat([sigma, rgb], -1).reshape(-1), torch.from_numpy(gt).reshape(-1)).backward()
    got = params_to_flax({k: p.grad for k, p in tmlp.named_parameters()})
    for name in case["params"]:
        for leaf in ("kernel", "bias"):
            assert _rel(got[name][leaf], np.asarray(jgrad[name][leaf])) <= GRAD_RTOL, (name, leaf)


def test_params_round_trip_through_flax_layout(case):
    tmlp = TrunkMLP(D_IN, DEPTH, WIDTH, SKIP, N_RGB)
    tmlp.load_state_dict(params_from_flax(case["params"]))
    back = params_to_flax(tmlp)
    assert sorted(back) == sorted(case["params"])
    for name, leaves in case["params"].items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(back[name][leaf], v)
    # flax's own init builds the same tree shapes as the port's module
    jmlp = JaxTrunkMLP(net_depth=DEPTH, net_width=WIDTH, skip_layer=SKIP,
                       num_rgb_channels=N_RGB, condition=False)
    jv = jmlp.init(random.PRNGKey(0), jnp.zeros((1, 1, D_IN)))["params"]
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jv)
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), back)
