"""The port's NeRF-SH training slice against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages; random draws
are made once (with jax.random, as the JAX functions draw them) and handed
to the port. Small sizes: depth 6, width 64, skip 4 (layer 5 reads
[h, x]), posenc 0..10 (d_in 63), SH degree 1, 8 + 8 samples, 64 rays.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from jax import random

from plenoctree_tpu import engine as jengine
from plenoctree_tpu.models import construct_nerf as jax_construct_nerf
from plenoctree_tpu.models.mlp import TrunkMLP as JaxTrunkMLP
from plenoctree_tpu.ops import sampling as jsampling
from plenoctree_tpu.ops.posenc import posenc as jposenc
from plenoctree_tpu.ops.rendering import volumetric_rendering as jrender
from plenoctree_tpu.types import Rays as JaxRays
from plenoctree_tpu.utils import checkpoints as jckpt
from plenoctree_tpu.utils import config as jconfig
from plenoctree_tpu.utils import lr as jlr
from plenoctree_tpu_torch import engine
from plenoctree_tpu_torch.data.rays import Rays
from plenoctree_tpu_torch.models.mlp import TrunkMLP
from plenoctree_tpu_torch.models.nerf import NerfModel
from plenoctree_tpu_torch.models.params import init_trunk_params, params_from_flax, params_to_flax
from plenoctree_tpu_torch.ops import sampling
from plenoctree_tpu_torch.ops.posenc import posenc
from plenoctree_tpu_torch.ops.rendering import volumetric_rendering
from plenoctree_tpu_torch.utils import checkpoints as ckpt
from plenoctree_tpu_torch.utils import config as tconfig
from plenoctree_tpu_torch.utils import lr as tlr
from plenoctree_tpu_torch.utils import msgpack_lite

BASE = dict(
    net_depth=6, net_width=64, skip_layer=4, sh_deg=1, use_viewdirs=False,
    num_coarse_samples=8, num_fine_samples=8, batch_size=64, sparsity_npoints=500,
    randomized=False, weight_decay_mult=0.1, max_steps=1000,
)
B = 64
TOL = dict(atol=1e-6, rtol=1e-6)  # f32 ops on both sides
# The inverse CDF sums and cumsums the bin weights; XLA and PyTorch add in
# other orders, so a cdf edge moves by an ulp and a fine sample by a few
# (measured 7.2e-6 on depths in [2, 6]).
PDF_TOL = dict(atol=1e-5, rtol=1e-5)
F32_TOL = dict(atol=1e-5, rtol=1e-5)  # whole f32 models / losses
BF16_TOL = dict(atol=3e-2, rtol=3e-2)  # bf16 paths (as tests/test_kernels.py:209)
# Loss gradients, per-leaf max relative error, against JAX's loss_fn run
# op-by-op (jax.disable_jit: no cross-op fusion, like eager PyTorch; the
# far-cap compositing gradient is ill-conditioned enough that JAX's own
# jitted and op-by-op gradients of the coarse loss differ by 3.3%).
# Both sides evaluate MLP_1 at JAX's fine depths (see _fine_depths).
# Measured: f32 2.1e-5 (MLP_0), 5.5e-7 (MLP_1); fused trunk 8.4e-4 (MLP_0),
# 3.1e-6 (MLP_1) (single bf16 roundings, see test_torch_fused_mlp.py).
F32_GRAD_RTOL = 1e-4
FUSED_GRAD_RTOL = 1e-2
# The port's own fine depths against JAX's: the inverse CDF divides by a
# bin's cdf step, so where a bin holds little weight an f32 rounding of the
# coarse weights moves a depth (in [2, 6]) by far more than an ulp.
# Measured 1.4e-4 (f32) and 7.1e-3 (bf16 trunk, whose coarse weights
# differ by bf16 roundings).
FINE_Z_ATOL = {"float32": 1e-3, "bfloat16": 3e-2}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rays(seed, n=B):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(size=(n, 3)) * 0.3 - o / 4.0
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return [a.astype(np.float32) for a in (o, d, v)]


def _tree(seed, depth=6, width=64, n_rgb=12):
    rng = np.random.default_rng(seed)
    return {
        name: init_trunk_params(rng, 63, depth, width, 4, 1, n_rgb, bias_std=0.05)
        for name in ("MLP_0", "MLP_1")
    }


def _models(dtype="float32", use_pallas=False, **over):
    kw = dict(BASE, compute_dtype=dtype, use_pallas=use_pallas, **over)
    jcfg = jconfig.default_config(**kw)
    tcfg = tconfig.default_config(**kw)
    jmodel, _ = jax_construct_nerf(random.PRNGKey(0), jcfg)
    tmodel = NerfModel(tcfg)
    return jcfg, jmodel, tcfg, tmodel


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("legacy", [False, True])
def test_posenc(legacy):
    x = np.random.default_rng(0).uniform(-2, 2, (5, 7, 3)).astype(np.float32)
    got = posenc(_t(x), 0, 10, legacy).numpy()
    want = np.asarray(jposenc(jnp.asarray(x), 0, 10, legacy))
    assert got.shape == want.shape == (5, 7, 63)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("white_bkgd,sigma_3d", [(True, False), (False, True)])
def test_volumetric_rendering(white_bkgd, sigma_3d):
    rng = np.random.default_rng(1)
    rgb = rng.uniform(size=(B, 16, 3)).astype(np.float32)
    sigma = rng.exponential(2.0, size=(B, 16) + ((1,) if sigma_3d else ())).astype(np.float32)
    sigma[:4] = 0.0  # empty rays exercise the disparity guard
    z = np.sort(rng.uniform(2, 6, (B, 16)), -1).astype(np.float32)
    dirs = rng.normal(size=(B, 3)).astype(np.float32)
    got = volumetric_rendering(_t(rgb), _t(sigma), _t(z), _t(dirs), white_bkgd)
    want = jrender(*map(jnp.asarray, (rgb, sigma, z, dirs)), white_bkgd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("randomized,lindisp", [(False, False), (True, False), (True, True)])
def test_sample_along_rays(randomized, lindisp):
    o, d, _ = _rays(2)
    key = random.PRNGKey(3)
    jz, jp = jsampling.sample_along_rays(key, jnp.asarray(o), jnp.asarray(d), 16, 2.0, 6.0,
                                         randomized, lindisp)
    t_rand = np.asarray(random.uniform(key, (B, 16)))
    tz, tp = sampling.sample_along_rays(_t(o), _t(d), 16, 2.0, 6.0, randomized, lindisp,
                                        t_rand=_t(t_rand))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def _pdf_inputs():
    rng = np.random.default_rng(4)
    z = np.sort(rng.uniform(2, 6, (B, 16)), -1).astype(np.float32)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    w = rng.exponential(size=(B, 14)).astype(np.float32)
    w[:3] = 0.0  # all-zero weights take the eps padding
    return z, bins, w


@pytest.mark.parametrize("randomized", [False, True])
def test_sample_pdf(randomized):
    z, bins, w = _pdf_inputs()
    o, d, _ = _rays(5)
    key = random.PRNGKey(6)
    jz, jp = jsampling.sample_pdf(key, *map(jnp.asarray, (bins, w, o, d, z)), 16, randomized)
    u = np.asarray(random.uniform(key, (B, 17)))  # _sorted_uniform's draw
    tz, tp = sampling.sample_pdf(*map(_t, (bins, w, o, d, z)), 16, randomized, u=_t(u))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **PDF_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **PDF_TOL)


@pytest.mark.parametrize("randomized", [False, True])
def test_piecewise_constant_pdf(randomized):
    _, bins, w = _pdf_inputs()
    key = random.PRNGKey(7)
    want = jsampling.piecewise_constant_pdf(key, jnp.asarray(bins), jnp.asarray(w), 24, randomized)
    u = np.asarray(random.uniform(key, (B, 24)))
    got = sampling.piecewise_constant_pdf(_t(bins), _t(w), 24, randomized, u=_t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PDF_TOL)


def test_add_gaussian_noise():
    raw = np.random.default_rng(8).normal(size=(B, 16)).astype(np.float32)
    key = random.PRNGKey(9)
    want = jsampling.add_gaussian_noise(key, jnp.asarray(raw), 0.3, True)
    noise = np.asarray(random.normal(key, raw.shape, dtype=jnp.float32))
    got = sampling.add_gaussian_noise(_t(raw), 0.3, True, noise=_t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(sampling.add_gaussian_noise(_t(raw), 0.3, False), _t(raw))


@pytest.mark.parametrize("delay", [0, 250])
def test_lr_schedule(delay):
    kw = dict(lr_init=5e-4, lr_final=5e-6, max_steps=1000, lr_delay_steps=delay,
              lr_delay_mult=0.01)
    for step in (0, 1, 17, 250, 999, 1000, 5000):
        want = float(jlr.learning_rate_decay(jnp.int32(step), **kw))
        assert tlr.learning_rate_decay(step, **kw) == pytest.approx(want, rel=1e-6, abs=1e-12)
    assert tlr.learning_rate_decay(0, 5e-4, 5e-6, 1000) == pytest.approx(5e-4, rel=1e-6)


# ---------------------------------------------------------------- models


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunk_forward(dtype):
    params = _tree(10)["MLP_0"]
    x = np.random.default_rng(11).normal(size=(4, 16, 63)).astype(np.float32)
    jmlp = JaxTrunkMLP(net_depth=6, net_width=64, skip_layer=4, num_rgb_channels=12,
                       condition=False,
                       compute_dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jr, js = jmlp.apply({"params": params}, jnp.asarray(x))
    tmlp = TrunkMLP(63, 6, 64, 4, 12, compute_dtype=getattr(torch, dtype))
    tmlp.load_state_dict(params_from_flax(params))
    tr, ts = tmlp(_t(x))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(jr), **tol)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nerf_call(dtype, monkeypatch):
    _, jmodel, _, tmodel = _models(dtype)
    tree = _tree(12)
    tmodel.load_state_dict(params_from_flax(tree))
    depths = _fine_depths(monkeypatch)
    o, d, v = _rays(13)
    jret = jmodel.apply({"params": tree}, random.PRNGKey(1), random.PRNGKey(2),
                        JaxRays(*map(jnp.asarray, (o, d, v))), False)
    with torch.no_grad():
        tret = tmodel(Rays(_t(o), _t(d), _t(v)), False)
    assert len(tret) == len(jret) == 2
    np.testing.assert_allclose(depths["port"], depths["jax"], atol=FINE_Z_ATOL[dtype], rtol=0)
    for (trgb, _, tacc), (jrgb, _, jacc) in zip(tret, jret):
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), **tol)
        # The last sample's alpha is 1 - exp(-sigma * 1e10): a near-zero
        # sigma that differs by f32 rounding moves acc (measured 1.7e-5).
        acc_tol = dict(atol=max(tol["atol"], 1e-4), rtol=tol["rtol"])
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), **acc_tol)


def test_unported_heads_raise():
    """Every head is ported now: the view-conditioned one builds with its
    branch (Dense_0 .. Dense_9: 6 trunk, sigma, bottleneck, one condition
    layer, rgb; its parity is tests/test_torch_viewdirs.py), and so does the
    SG head (tests/test_torch_sg.py); SH and SG together, and SG with view
    directions, are refused, as the JAX package asserts."""
    model = NerfModel(tconfig.default_config(**dict(BASE, use_viewdirs=True, sh_deg=-1)))
    assert sorted(params_to_flax(model)["MLP_1"], key=lambda k: int(k[6:])) == [
        f"Dense_{i}" for i in range(10)]
    assert model.MLP_0.Dense_7.kernel.shape == (64, 64)  # the bottleneck
    assert model.MLP_0.Dense_8.kernel.shape == (64 + 27, 128)  # [bottleneck, posenc(dir)]
    with pytest.raises(ValueError, match="up to one of"):
        NerfModel(tconfig.default_config(**dict(BASE, use_viewdirs=True, sg_dim=4, sh_deg=-1)))
    model = NerfModel(tconfig.default_config(**dict(BASE, sg_dim=4, sh_deg=-1)))
    assert model.sg_mu_spher.shape == (4, 2)
    with pytest.raises(ValueError, match="up to one of"):
        NerfModel(tconfig.default_config(**dict(BASE, sg_dim=4)))


# ---------------------------------------------------------------- loss, Adam


def _jax_state(tree):
    return jckpt.create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, tree)})


def _fine_depths(monkeypatch):
    """Record the fine depths of JAX's model and hand the same depths to the
    port's model; returns {'jax': ..., 'port': ...} (the port's own depths,
    before they are replaced). The inverse CDF is ill-conditioned (see
    FINE_Z_ATOL), so without this the two MLP_1 gradients would compare
    trunks evaluated at other points."""
    seen = {}
    jax_sample_pdf, port_sample_pdf = jsampling.sample_pdf, sampling.sample_pdf

    def jax_side(*args, **kwargs):
        z_vals, points = jax_sample_pdf(*args, **kwargs)
        seen["jax"] = np.asarray(z_vals)
        return z_vals, points

    def port_side(bins, weights, origins, directions, z_vals, *args, **kwargs):
        own, _ = port_sample_pdf(bins, weights, origins, directions, z_vals, *args, **kwargs)
        seen["port"] = own.detach().numpy()
        z = torch.from_numpy(seen["jax"].copy())
        return z, sampling.cast_rays(z, origins, directions)

    monkeypatch.setattr(jsampling, "sample_pdf", jax_side)
    monkeypatch.setattr(sampling, "sample_pdf", port_side)
    return seen


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("num_fine", [0, 8])
def test_loss_and_grads_match_jax_loss_fn(use_pallas, num_fine, monkeypatch):
    """JAX's real loss_fn, inside its train step run op-by-op, from a fresh
    Adam state leaves mu = (1 - b1) * grad; the port's loss_and_grads must
    match those gradients and the stats. The sparsity points are JAX's own
    key_2 draw (fold_in(rng, step) -> split(., 3)[2]); the fine level runs
    at JAX's fine depths (_fine_depths)."""
    _check_loss_and_grads(use_pallas, num_fine, monkeypatch)


@pytest.mark.parametrize("switches", [("PN_POSENC_IN_KERNEL",), ("PN_SH_IN_KERNEL",),
                                      ("PN_POSENC_IN_KERNEL", "PN_SH_IN_KERNEL")])
def test_loss_and_grads_match_jax_with_kernel_variants(switches, monkeypatch):
    """The same training step with the fused kernels' in-kernel posenc and/or
    SH decode switched on in both packages (the training configuration is
    both): the model's dispatch sends raw points and a per-ray basis into
    the kernels, skips the separate decode, and the sparsity points go
    through eval_points_raw's in-kernel posenc. Measured against JAX: stats
    within the default fused path's bounds, gradients 8.4e-4 max relative."""
    from plenoctree_tpu_torch.kernels import fused_mlp

    for var in switches:
        monkeypatch.setenv(var, "1")
    metas = []
    plain = fused_mlp.fused_trunk_reference

    def spy(flat_w, x, meta, basis=None):
        metas.append((meta, tuple(x.shape), basis is not None))
        return plain(flat_w, x, meta, basis)

    monkeypatch.setattr(fused_mlp, "fused_trunk_reference", spy)
    _check_loss_and_grads(True, 8, monkeypatch)
    # coarse, fine and the sparsity points went through the kernels' path
    assert len(metas) == 3
    for meta, x_shape, has_basis in metas:
        assert bool(meta["posenc"]) == ("PN_POSENC_IN_KERNEL" in switches)
        assert x_shape[1] == (3 if meta["posenc"] else 63)
        assert has_basis == bool(meta["sh_dim"])
    assert sum(h for _, _, h in metas) == (2 if "PN_SH_IN_KERNEL" in switches else 0)


def _check_loss_and_grads(use_pallas, num_fine, monkeypatch):
    dtype = "bfloat16" if use_pallas else "float32"
    jcfg, jmodel, tcfg, tmodel = _models(dtype, use_pallas, num_fine_samples=num_fine)
    tree = _tree(14)
    if num_fine == 0:
        tree = {"MLP_0": tree["MLP_0"]}  # flax makes no MLP_1 without a fine pass
    tmodel.load_state_dict(params_from_flax(tree))
    depths = _fine_depths(monkeypatch)
    o, d, v = _rays(15)
    pixels = np.random.default_rng(16).uniform(size=(B, 3)).astype(np.float32)
    rng = random.PRNGKey(17)
    step = jengine.make_train_step(jmodel, jcfg, donate=False)
    with jax.disable_jit():
        new_state, jstats, _ = step(
            _jax_state(tree), {"rays": JaxRays(*map(jnp.asarray, (o, d, v))),
                               "pixels": jnp.asarray(pixels)}, rng,
        )
    key_2 = random.split(random.fold_in(rng, 0), 3)[2]
    sp = np.asarray(random.uniform(key_2, (jcfg.sparsity_npoints, 3),
                                   minval=-jcfg.sparsity_radius, maxval=jcfg.sparsity_radius))
    stats, grads = engine.loss_and_grads(
        tmodel, {"rays": Rays(_t(o), _t(d), _t(v)), "pixels": _t(pixels)}, tcfg,
        draws={"sp_points": _t(sp)},
    )
    if num_fine:
        assert depths["port"].shape == depths["jax"].shape == (B, 8 + num_fine)
        np.testing.assert_allclose(depths["port"], depths["jax"], atol=FINE_Z_ATOL[dtype], rtol=0)
    if not use_pallas:
        stat_tol = F32_TOL
    else:  # measured 1.1e-5 (coarse only), 8.0e-5 (loss_sp through MLP_1's kernel)
        stat_tol = dict(atol=0, rtol=1e-4 if not num_fine else 5e-4)
    for name in engine.Stats._fields:
        np.testing.assert_allclose(float(getattr(stats, name)), float(getattr(jstats, name)),
                                   err_msg=name, **stat_tol)
    jgrads = params_to_flax(params_from_flax(new_state.opt_state[0].mu))
    got = params_to_flax(grads)
    assert sorted(got) == sorted(jgrads)
    bound = FUSED_GRAD_RTOL if use_pallas else F32_GRAD_RTOL
    for mlp in jgrads:
        for layer, leaves in jgrads[mlp].items():
            for leaf, mu in leaves.items():
                err = _rel(got[mlp][layer][leaf], mu / np.float32(1 - 0.9))
                assert err <= bound, (mlp, layer, leaf, err)


def _optax_steps(params, grad_list, lr_fn):
    tx = optax.adam(1.0)
    opt = tx.init(params)
    for step, g in enumerate(grad_list):
        updates, opt = tx.update(g, opt, params)
        lr = lr_fn(jnp.int32(step))
        updates = jax.tree_util.tree_map(lambda u: u * lr, updates)
        params = optax.apply_updates(params, updates)
    return params, opt


def test_adam_matches_optax_three_steps():
    _, _, tcfg, tmodel = _models()
    tree = _tree(18)
    tmodel.load_state_dict(params_from_flax(tree))
    rng = np.random.default_rng(19)
    grad_trees = [
        jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 1e-2, tree)
        for _ in range(3)
    ]
    jparams, jopt = _optax_steps(jax.tree_util.tree_map(jnp.asarray, tree), grad_trees,
                                 jlr.schedule_from_config(tcfg))
    state = ckpt.create_train_state(tmodel)
    lr_fn = tlr.schedule_from_config(tcfg)
    for g in grad_trees:
        ckpt.adam_update(state, params_from_flax(g), lr_fn(state.step))
        state.step += 1
    assert state.opt_state["count"] == int(jopt[0].count) == 3
    for mine, theirs in ((state.params, jparams), (state.opt_state["mu"], jopt[0].mu),
                         (state.opt_state["nu"], jopt[0].nu)):
        want = params_from_flax(jax.tree_util.tree_map(np.asarray, theirs))
        for k, t in mine.items():
            np.testing.assert_allclose(t.detach().numpy(), want[k].numpy(), atol=1e-6, rtol=1e-6,
                                       err_msg=k)


# ---------------------------------------------------------------- checkpoints


def _trained_port_state(steps=2):
    _, _, tcfg, tmodel = _models()
    tmodel.load_state_dict(params_from_flax(_tree(20)))
    state = ckpt.create_train_state(tmodel)
    rng = np.random.default_rng(21)
    for _ in range(steps):
        g = {k: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
             for k, p in state.params.items()}
        ckpt.adam_update(state, g, 1e-3)
        state.step += 1
    return tmodel, state


def test_port_checkpoint_restores_in_jax(tmp_path):
    _, state = _trained_port_state()
    path = ckpt.save_checkpoint(str(tmp_path), state, state.step)
    assert os.path.basename(path) == "checkpoint_2"
    restored = jckpt.restore_checkpoint(str(tmp_path), _jax_state(_tree(99)))
    assert int(restored.step) == 2 and int(restored.opt_state[0].count) == 2
    pairs = (
        (restored.variables["params"], state.params),
        (restored.opt_state[0].mu, state.opt_state["mu"]),
        (restored.opt_state[0].nu, state.opt_state["nu"]),
    )
    for jtree, mine in pairs:
        jflat = params_from_flax(jax.tree_util.tree_map(np.asarray, jtree))
        assert sorted(jflat) == sorted(mine)
        for k, t in mine.items():
            np.testing.assert_array_equal(jflat[k].numpy(), t.detach().numpy())


def test_jax_checkpoint_restores_in_port(tmp_path):
    tree = _tree(22)
    jstate = _jax_state(tree)
    grads = jax.tree_util.tree_map(lambda a: jnp.full(a.shape, 0.01, jnp.float32), tree)
    _, opt = _optax_steps(jax.tree_util.tree_map(jnp.asarray, tree), [grads] * 3,
                          lambda s: jnp.float32(1e-3))
    jstate = jstate.replace(step=jnp.int32(7), opt_state=opt)
    (tmp_path / "checkpoint_7").write_bytes(serialization.to_bytes(jstate))
    _, _, _, tmodel = _models()
    state = ckpt.restore_checkpoint(str(tmp_path), ckpt.create_train_state(tmodel))
    assert state.step == 7 and state.opt_state["count"] == 3
    want = params_from_flax(tree)
    for k, p in tmodel.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), want[k].numpy())
    mu = params_from_flax(jax.tree_util.tree_map(np.asarray, opt[0].mu))
    for k, t in state.opt_state["mu"].items():
        np.testing.assert_array_equal(t.numpy(), mu[k].numpy())


def test_msgpack_subset_matches_flax():
    tree = {
        "a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.asarray(5, np.int32),
        "c": {"d": 1, "e": -3, "f": 2.5, "g": "text", "h": True, "i": None, "j": {}},
        "k": np.float32(1.5), "l": list(range(20)), "m": 70000, "n": -70000,
    }
    flax_bytes = serialization.msgpack_serialize(tree)
    back = msgpack_lite.unpackb(flax_bytes)
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert back["b"].dtype == np.int32 and back["b"] == 5
    assert back["c"] == tree["c"] and back["k"] == 1.5 and back["l"] == tree["l"]
    assert (back["m"], back["n"]) == (70000, -70000)
    mine = serialization.msgpack_restore(msgpack_lite.packb(tree))
    np.testing.assert_array_equal(mine["a"], tree["a"])
    assert mine["c"] == tree["c"] and mine["l"] == tree["l"] and mine["k"] == 1.5
