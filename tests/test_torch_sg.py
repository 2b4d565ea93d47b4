"""The port's SG head against the JAX package on the CPU: ops/sg.py, the SG
NerfModel's forward and training gradients (sg_lambda, sg_mu_spher and the
trunks), SG checkpoints both ways, and SG extraction (extra_data and leaf
data). Small sizes: depth 4, width 32, skip 2, sg_dim 4, 8 + 8 samples,
64 rays; extraction at init_grid_depth 3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from jax import random

from plenoctree_tpu import engine as jengine
from plenoctree_tpu.models import construct_nerf as jax_construct_nerf
from plenoctree_tpu.octree import extract as jextract
from plenoctree_tpu.octree.n3tree import N3Tree as JaxN3Tree
from plenoctree_tpu.ops import sampling as jsampling
from plenoctree_tpu.ops import sg as jsg
from plenoctree_tpu.types import Rays as JaxRays
from plenoctree_tpu.utils import checkpoints as jckpt
from plenoctree_tpu.utils import config as jconfig
from plenoctree_tpu_torch import engine
from plenoctree_tpu_torch.data.rays import Rays
from plenoctree_tpu_torch.models.nerf import NerfModel, construct_nerf, get_model_state
from plenoctree_tpu_torch.models.params import init_trunk_params, params_from_flax, params_to_flax
from plenoctree_tpu_torch.octree import extract as textract
from plenoctree_tpu_torch.octree.n3tree import N3Tree
from plenoctree_tpu_torch.ops import sampling
from plenoctree_tpu_torch.ops import sg
from plenoctree_tpu_torch.utils import checkpoints as ckpt
from plenoctree_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)  # as tests/test_torch_extract.py: several xdist workers share the cores

SG_DIM = 4
BASE = dict(
    net_depth=4, net_width=32, skip_layer=2, sh_deg=-1, sg_dim=SG_DIM, use_viewdirs=False,
    num_coarse_samples=8, num_fine_samples=8, batch_size=64, sparsity_npoints=300,
    randomized=False, weight_decay_mult=0.1, max_steps=1000,
)
B = 64
OPS_RTOL = 1e-6  # the same f32 ops in the same order on both sides
F32_TOL = dict(atol=1e-5, rtol=1e-5)  # whole f32 models
# Gradients against JAX's loss_fn run op-by-op, at JAX's fine depths, per
# leaf max relative error (tests/test_torch_train.py's bounds: f32 1e-4;
# the fused path's plain version, bf16 roundings, 1e-2).
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _rays(seed, n=B):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(size=(n, 3)) * 0.3 - o / 4.0
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return [a.astype(np.float32) for a in (o, d, v)]


def _sg_tree(seed, bias_std=0.05):
    """Seeded flax params of the SG model: two trunks with a 3 * SG_DIM
    head, lambda N(0.5, 0.5) and mu (theta, phi) uniform on the sphere."""
    rng = np.random.default_rng(seed)
    tree = {
        name: init_trunk_params(rng, 63, 4, 32, 2, 1, 3 * SG_DIM, bias_std=bias_std)
        for name in ("MLP_0", "MLP_1")
    }
    tree["sg_lambda"] = rng.normal(0.5, 0.5, SG_DIM).astype(np.float32)
    tree["sg_mu_spher"] = np.stack(
        [rng.uniform(0, np.pi, SG_DIM), rng.uniform(0, 2 * np.pi, SG_DIM)], -1
    ).astype(np.float32)
    return tree


def _models(dtype="float32", use_pallas=False, **over):
    kw = dict(BASE, compute_dtype=dtype, use_pallas=use_pallas, **over)
    jcfg, tcfg = jconfig.default_config(**kw), tconfig.default_config(**kw)
    jmodel, _ = jax_construct_nerf(random.PRNGKey(0), jcfg)
    return jcfg, jmodel, tcfg, NerfModel(tcfg)


def _jax_depths(monkeypatch):
    """JAX's coarse and fine depths handed to the port. The fine ones as
    tests/test_torch_train.py's _fine_depths does (the inverse CDF is
    ill-conditioned); the coarse ones too: XLA's linspace differs from
    PyTorch's by an ulp at some depths, and the posenc's 2^9 frequency
    turns that into ~1e-4 of a sample's sigma (measured 9e-5 at one of 512
    coarse samples), more than these tests' bounds."""
    seen = {}
    jax_fns = (jsampling.sample_along_rays, jsampling.sample_pdf)
    port_fns = (sampling.sample_along_rays, sampling.sample_pdf)

    def jax_side(i):
        def fn(*args, **kwargs):
            z_vals, points = jax_fns[i](*args, **kwargs)
            seen[i] = np.asarray(z_vals)
            return z_vals, points
        return fn

    def port_side(i):
        def fn(*args, **kwargs):
            port_fns[i](*args, **kwargs)
            origins, directions = args[:2] if i == 0 else args[2:4]
            z = torch.from_numpy(seen[i].copy())
            return z, sampling.cast_rays(z, origins, directions)
        return fn

    for i, name in enumerate(("sample_along_rays", "sample_pdf")):
        monkeypatch.setattr(jsampling, name, jax_side(i))
        monkeypatch.setattr(sampling, name, port_side(i))
    return seen


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("mu_form", [2, 3])
@pytest.mark.parametrize("batched_lobes", [False, True])
def test_eval_sg_matches_jax(mu_form, batched_lobes):
    rng = np.random.default_rng(mu_form + 2 * batched_lobes)
    lead = (5, 7) if batched_lobes else ()
    lam = rng.normal(0.5, 1.0, lead + (SG_DIM,)).astype(np.float32)
    if mu_form == 2:
        mu = np.stack([rng.uniform(0, np.pi, lead + (SG_DIM,)),
                       rng.uniform(0, 2 * np.pi, lead + (SG_DIM,))], -1)
    else:
        mu = rng.normal(size=lead + (SG_DIM, 3))
        mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
    mu = mu.astype(np.float32)
    coeffs = rng.normal(size=(5, 7, 3, SG_DIM)).astype(np.float32)
    dirs = rng.normal(size=(5, 7, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    got = sg.eval_sg(_t(lam), _t(mu), _t(coeffs), _t(dirs)).numpy()
    want = np.asarray(jsg.eval_sg(*map(jnp.asarray, (lam, mu, coeffs, dirs))))
    assert got.shape == want.shape == (5, 7, 3)
    np.testing.assert_allclose(got, want, rtol=OPS_RTOL, atol=OPS_RTOL * np.abs(want).max())


def test_spher2cart_and_euler2mat_match_jax():
    rng = np.random.default_rng(3)
    r, th, ph = (rng.uniform(0.5, 2, 50), rng.uniform(0, np.pi, 50), rng.uniform(0, 2 * np.pi, 50))
    r, th, ph = (a.astype(np.float32) for a in (r, th, ph))
    got = sg.spher2cart(_t(r), _t(th), _t(ph)).numpy()
    want = np.asarray(jsg.spher2cart(*map(jnp.asarray, (r, th, ph))))
    np.testing.assert_allclose(got, want, rtol=OPS_RTOL, atol=OPS_RTOL * 2)
    ang = rng.uniform(-np.pi, np.pi, (4, 6, 3)).astype(np.float32)
    got = sg.euler2mat(_t(ang)).numpy()
    want = np.asarray(jsg.euler2mat(jnp.asarray(ang)))
    assert got.shape == want.shape == (4, 6, 3, 3)
    np.testing.assert_allclose(got, want, rtol=OPS_RTOL, atol=OPS_RTOL)
    # rotation matrices: orthonormal
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2), np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-5)


# ---------------------------------------------------------------- model


def test_sg_model_parameters_and_init():
    """sg_lambda [N] and sg_mu_spher [N, 2] are top-level parameters named as
    in flax; the port's seeded init draws lambda = 1 and mu in
    [0, pi) x [0, 2 pi) (JAX's PRNGKey(0) stream is not reproduced)."""
    _, _, tcfg, _ = _models()
    model = construct_nerf(tcfg, seed=3)
    names = dict(model.named_parameters())
    assert names["sg_lambda"].shape == (SG_DIM,) and names["sg_mu_spher"].shape == (SG_DIM, 2)
    assert names["MLP_0.Dense_5.kernel"].shape == (32, 3 * SG_DIM)
    assert torch.equal(model.sg_lambda, torch.ones(SG_DIM))
    mu = model.sg_mu_spher.detach().numpy()
    assert (mu[:, 0] >= 0).all() and (mu[:, 0] < np.pi).all()
    assert (mu[:, 1] >= 0).all() and (mu[:, 1] < 2 * np.pi).all()
    jtree = jax_construct_nerf(random.PRNGKey(0), jconfig.default_config(**BASE))[1]["params"]
    assert sorted(params_to_flax(model)) == sorted(jtree)
    # The trunks' draws do not depend on the SG head: the same seed gives the
    # SH-free trunk of the same width.
    plain = construct_nerf(tconfig.default_config(**dict(BASE, sg_dim=-1, num_rgb_channels=12)), 3)
    assert torch.equal(plain.MLP_1.Dense_0.kernel, model.MLP_1.Dense_0.kernel)


@pytest.mark.parametrize("randomized", [False, True])
def test_sg_nerf_call_matches_jax(randomized, monkeypatch):
    _, jmodel, _, tmodel = _models()
    tree = _sg_tree(4)
    tmodel.load_state_dict(params_from_flax(tree))
    _jax_depths(monkeypatch)
    o, d, v = _rays(5)
    rng0, rng1 = random.PRNGKey(1), random.PRNGKey(2)
    jret = jmodel.apply({"params": tree}, rng0, rng1, JaxRays(*map(jnp.asarray, (o, d, v))),
                        randomized)
    draws = None
    if randomized:  # JAX's own draws (NerfModel.__call__'s key splits)
        k0, r0 = random.split(rng0)
        k1, _ = random.split(r0)
        draws = {"t_rand": _t(random.uniform(k0, (B, 8))),
                 "noise_c": _t(random.normal(k1, (B, 8))),
                 "noise_f": _t(random.normal(random.split(random.split(rng1)[1])[0], (B, 16)))}
    with torch.no_grad():
        tret = tmodel(Rays(_t(o), _t(d), _t(v)), randomized, draws=draws)
    for (trgb, tdisp, tacc), (jrgb, jdisp, jacc) in zip(tret, jret):
        np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), **F32_TOL)
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_sg_loss_and_grads_match_jax(use_pallas, monkeypatch):
    """JAX's loss_fn inside its train step, run op-by-op, from a fresh Adam
    state (mu = (1 - b1) * grad), against the port's loss_and_grads: every
    leaf, sg_lambda and sg_mu_spher included. With use_pallas both packages
    take the fused trunk (on the CPU its plain version: bf16 roundings) with
    the 1 + 3 * sg_dim head."""
    dtype = "bfloat16" if use_pallas else "float32"
    jcfg, jmodel, tcfg, tmodel = _models(dtype, use_pallas)
    tree = _sg_tree(6)
    tmodel.load_state_dict(params_from_flax(tree))
    _jax_depths(monkeypatch)
    o, d, v = _rays(7)
    pixels = np.random.default_rng(8).uniform(size=(B, 3)).astype(np.float32)
    rng = random.PRNGKey(9)
    step = jengine.make_train_step(jmodel, jcfg, donate=False)
    jstate = jckpt.create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, tree)})
    with jax.disable_jit():
        new_state, jstats, _ = step(
            jstate, {"rays": JaxRays(*map(jnp.asarray, (o, d, v))), "pixels": jnp.asarray(pixels)},
            rng,
        )
    key_2 = random.split(random.fold_in(rng, 0), 3)[2]
    sp = np.asarray(random.uniform(key_2, (jcfg.sparsity_npoints, 3),
                                   minval=-jcfg.sparsity_radius, maxval=jcfg.sparsity_radius))
    stats, grads = engine.loss_and_grads(
        tmodel, {"rays": Rays(_t(o), _t(d), _t(v)), "pixels": _t(pixels)}, tcfg,
        draws={"sp_points": _t(sp)},
    )
    stat_tol = F32_TOL if not use_pallas else dict(atol=0, rtol=5e-4)
    for name in engine.Stats._fields:
        np.testing.assert_allclose(float(getattr(stats, name)), float(getattr(jstats, name)),
                                   err_msg=name, **stat_tol)
    want = params_from_flax(new_state.opt_state[0].mu)
    assert sorted(grads) == sorted(want)
    assert float(grads["sg_lambda"].abs().max()) > 0 and float(grads["sg_mu_spher"].abs().max()) > 0
    for k, mu in want.items():
        err = _rel(grads[k].numpy(), mu.numpy() / np.float32(1 - 0.9))
        assert err <= GRAD_RTOL[dtype], (k, err)


# ---------------------------------------------------------------- checkpoints


def test_sg_port_checkpoint_restores_in_jax(tmp_path):
    _, _, _, tmodel = _models()
    tmodel.load_state_dict(params_from_flax(_sg_tree(10)))
    state = ckpt.create_train_state(tmodel)
    rng = np.random.default_rng(11)
    for _ in range(2):
        g = {k: _t(rng.normal(size=p.shape)) for k, p in state.params.items()}
        ckpt.adam_update(state, g, 1e-3)
        state.step += 1
    ckpt.save_checkpoint(str(tmp_path), state, state.step)
    jtree = jax_construct_nerf(random.PRNGKey(0), jconfig.default_config(**BASE))[1]
    restored = jckpt.restore_checkpoint(str(tmp_path), jckpt.create_train_state(jtree))
    assert int(restored.step) == 2
    for jt, mine in ((restored.variables["params"], state.params),
                     (restored.opt_state[0].mu, state.opt_state["mu"]),
                     (restored.opt_state[0].nu, state.opt_state["nu"])):
        jflat = params_from_flax(jax.tree_util.tree_map(np.asarray, jt))
        assert sorted(jflat) == sorted(mine) and "sg_mu_spher" in jflat
        for k, t in mine.items():
            np.testing.assert_array_equal(jflat[k].numpy(), t.detach().numpy(), err_msg=k)


def _write_jax_sg_checkpoint(train_dir, tree, step=5):
    state = jckpt.create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, tree)})
    g = jax.tree_util.tree_map(lambda a: jnp.full(a.shape, 0.01, jnp.float32), tree)
    import optax

    _, opt = optax.adam(1.0).update(g, state.opt_state, state.variables["params"])
    os.makedirs(train_dir, exist_ok=True)
    with open(os.path.join(train_dir, f"checkpoint_{step}"), "wb") as f:
        f.write(serialization.to_bytes(state.replace(step=jnp.int32(step), opt_state=opt)))
    return opt


def test_sg_jax_checkpoint_restores_in_port(tmp_path):
    tree = _sg_tree(12)
    opt = _write_jax_sg_checkpoint(str(tmp_path), tree)
    _, _, _, tmodel = _models()
    state = ckpt.restore_checkpoint(str(tmp_path), ckpt.create_train_state(tmodel))
    assert state.step == 5 and state.opt_state["count"] == 1
    for k in ("sg_lambda", "sg_mu_spher"):
        np.testing.assert_array_equal(getattr(tmodel, k).detach().numpy(), tree[k])
    mu = params_from_flax(jax.tree_util.tree_map(np.asarray, opt[0].mu))
    for k in ("sg_lambda", "sg_mu_spher", "MLP_1.Dense_5.bias"):
        np.testing.assert_array_equal(state.opt_state["mu"][k].numpy(), mu[k].numpy())


# ---------------------------------------------------------------- extraction


def test_sg_extra_data_matches_jax_cli():
    """extra_data [N, 4] = (softplus lambda, cartesian mu), baked in f32 as
    the JAX CLI bakes it (JAX cli/extract.py:54-70, replayed here)."""
    tree = _sg_tree(13)
    got = textract.sg_extra_data(tree["sg_lambda"], tree["sg_mu_spher"])
    lam = np.logaddexp(0.0, tree["sg_lambda"])
    m = tree["sg_mu_spher"]
    mu = np.stack([np.sin(m[:, 0]) * np.cos(m[:, 1]), np.sin(m[:, 0]) * np.sin(m[:, 1]),
                   np.cos(m[:, 0])], -1)
    want = np.concatenate([lam[:, None], mu], -1).astype(np.float32)
    assert got.dtype == np.float32 and got.shape == (SG_DIM, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got[:, 1:], axis=-1), 1.0, atol=1e-6)


def test_sg_extraction_matches_jax(tmp_path):
    """One SG checkpoint written by the JAX package, restored and extracted
    by each package (f32 trunks, sigma masking at init_grid_depth 3, 4
    jittered samples per leaf, the SG format and extra_data): equal
    topology, extra_data within 1e-6 and leaf data within
    tests/test_torch_extract.py's 1e-4."""
    train_dir = str(tmp_path / "ckpt")
    tree = _sg_tree(7, bias_std=0.3)
    _write_jax_sg_checkpoint(train_dir, tree)
    kw = dict(BASE, train_dir=train_dir, init_grid_depth=3, samples_per_cell=4,
              masking_mode="sigma", alpha_thresh=0.01, radius="1.5", chunk=4096)
    jcfg, tcfg = jconfig.default_config(**kw), tconfig.default_config(**kw)
    jmodel, jvars = jax_construct_nerf(random.PRNGKey(0), jcfg)
    jstate = jckpt.restore_checkpoint(train_dir, jckpt.create_train_state(jvars))
    fn = jengine.make_eval_points_fn(jmodel, raw_rgb=True)
    jfn = lambda p, v: fn(jstate.variables, p, v)  # noqa: E731
    tmodel, _ = get_model_state(tcfg, restore=True)
    tfn = textract.make_points_fn(tmodel, "cpu")
    extra = textract.sg_extra_data(tmodel.sg_lambda.detach().numpy(),
                                   tmodel.sg_mu_spher.detach().numpy())
    trees = []
    for pkg_tree, ext, pfn, cfg in ((JaxN3Tree, jextract, jfn, jcfg),
                                    (N3Tree, textract, tfn, tcfg)):
        t = pkg_tree(data_dim=1 + 3 * SG_DIM, depth_limit=3, radius=[1.5] * 3,
                     center=[0.0] * 3, data_format=f"SG{SG_DIM}", init_reserve=1000,
                     extra_data=extra)
        ext.step1_build(cfg, t, pfn, None)
        ext.step2_fill(cfg, t, pfn)
        t.relu_sigma_()
        t.shrink_to_fit()
        trees.append(t)
    a, b = trees[1], trees[0]
    n = a.n_internal
    assert n == b.n_internal > 1 and a.n_leaves > 50
    np.testing.assert_array_equal(a.child[:n], b.child[:n])
    np.testing.assert_allclose(a.data[:n], b.data[:n], rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.extra_data, b.extra_data, rtol=1e-6, atol=1e-6)
    assert repr(a.data_format) == f"SG{SG_DIM}"
