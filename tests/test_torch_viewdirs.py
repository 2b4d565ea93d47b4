"""The view-conditioned NeRF, activations by name and extraction by SH
projection: the port against the JAX package on the CPU.

Small sizes: depth 3, width 32, skip 4, condition 1 x 16 (and 2 x 16),
posenc 0..4 (d_in 27), view directions to degree 4 (d_view 27), 8 + 8
samples, 64 rays. The JAX model is built with sh_deg -1 (it refuses SH
with use_viewdirs); the port takes sh_deg as the projection's target and
builds the same model.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from jax import random

from plenoctree_tpu.models import construct_nerf as jax_construct_nerf
from plenoctree_tpu.models.mlp import TrunkMLP as JaxTrunkMLP
from plenoctree_tpu.ops import sh_project as jsh_project
from plenoctree_tpu.types import Rays as JaxRays
from plenoctree_tpu.utils import checkpoints as jckpt
from plenoctree_tpu.utils import config as jconfig
from plenoctree_tpu_torch import engine
from plenoctree_tpu_torch.data.rays import Rays
from plenoctree_tpu_torch.models import nerf as tnerf
from plenoctree_tpu_torch.models.mlp import TrunkMLP
from plenoctree_tpu_torch.models.params import params_from_flax, params_to_flax
from plenoctree_tpu_torch.ops import sh_project
from plenoctree_tpu_torch.utils import checkpoints as ckpt
from plenoctree_tpu_torch.utils import config as tconfig

from tests.test_torch_train import _fine_depths, _rays, _rel

BASE = dict(
    net_depth=3, net_width=32, skip_layer=4, net_width_condition=16, max_deg_point=4,
    deg_view=4, use_viewdirs=True, sh_deg=-1, num_coarse_samples=8, num_fine_samples=8,
    batch_size=64, sparsity_npoints=200, randomized=False, weight_decay_mult=0.1,
    max_steps=1000,
)
F32_TOL = dict(atol=1e-5, rtol=1e-5)  # whole f32 models
BF16_TOL = dict(atol=3e-2, rtol=3e-2)  # bf16 paths (as tests/test_torch_train.py)
# Gradients of the whole loss, per-leaf max relative error, against JAX's
# loss_fn run op-by-op at JAX's fine depths (as tests/test_torch_train.py).
F32_GRAD_RTOL = 1e-4
PROJ_RTOL = 1e-5  # the projection's einsum sums in another order


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _models(**over):
    kw = dict(BASE, **over)
    jmodel, variables = jax_construct_nerf(random.PRNGKey(0), jconfig.default_config(**kw))
    tmodel = tnerf.NerfModel(tconfig.default_config(**kw))
    params = jax.tree_util.tree_map(np.asarray, flax_params(variables))
    tmodel.load_state_dict(params_from_flax(params))
    return jmodel, params, tmodel


def flax_params(variables):
    return dict(variables["params"]) if "params" in variables else dict(variables)


def _with_biases(params, seed):
    """Non-zero biases (flax initialises them to 0), so a dropped bias add
    shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + (rng.normal(0, 0.05, a.shape).astype(np.float32) if a.ndim == 1 else 0),
        params,
    )


@pytest.mark.parametrize("depth_cond", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_condition_mlp_matches_flax(dtype, depth_cond):
    """TrunkMLP with the view branch: forward and cross against flax's, on
    flax's own init with biases perturbed; the layers are Dense_0 .. Dense_n
    in call order in both."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jmlp = JaxTrunkMLP(net_depth=5, net_width=32, net_depth_condition=depth_cond,
                       net_width_condition=16, skip_layer=4, condition=True, compute_dtype=jdt)
    x = np.random.default_rng(1).normal(size=(4, 6, 27)).astype(np.float32)
    cond = np.random.default_rng(2).normal(size=(4, 15)).astype(np.float32)
    params = _with_biases(
        jax.tree_util.tree_map(np.asarray, dict(jmlp.init(random.PRNGKey(3), x, cond)["params"])),
        4,
    )
    tmlp = TrunkMLP(27, 5, 32, 4, 3, condition=True, compute_dtype=getattr(torch, dtype),
                    d_condition=15, net_depth_condition=depth_cond, net_width_condition=16)
    assert sorted(params_from_flax(params)) == sorted(tmlp.state_dict())
    tmlp.load_state_dict(params_from_flax(params))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jr, js = jmlp.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond))
    tr, ts = tmlp(_t(x), _t(cond))
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(jr), **tol)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **tol)
    pts, dirs = x[0], cond[:3]
    jr, js = jmlp.apply({"params": params}, jnp.asarray(pts), jnp.asarray(dirs),
                        method=jmlp.cross)
    tr, ts = tmlp.cross(_t(pts), _t(dirs))
    assert tuple(tr.shape) == (6, 3, 3) and tuple(ts.shape) == (6, 1)
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(jr), **tol)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **tol)


def test_condition_mlp_refuses_the_fused_kernels():
    tmlp = TrunkMLP(27, 3, 32, 4, 3, condition=True, d_condition=15)
    with pytest.raises(ValueError, match="view-conditioned"):
        tmlp.flat_weights()
    with pytest.raises(ValueError, match="d_condition"):
        TrunkMLP(27, 3, 32, 4, 3, condition=True)


@pytest.mark.parametrize("num_fine", [0, 8])
def test_viewdirs_nerf_call_matches_flax(num_fine, monkeypatch):
    """NerfModel(use_viewdirs) renders as the flax model (f32), both levels;
    the fine level at JAX's fine depths."""
    jmodel, params, tmodel = _models(num_fine_samples=num_fine)
    params = _with_biases(params, 5)
    tmodel.load_state_dict(params_from_flax(params))
    _fine_depths(monkeypatch)
    o, d, v = _rays(6)
    jret = jmodel.apply({"params": params}, random.PRNGKey(1), random.PRNGKey(2),
                        JaxRays(*map(jnp.asarray, (o, d, v))), False)
    with torch.no_grad():
        tret = tmodel(Rays(_t(o), _t(d), _t(v)), False)
    assert len(tret) == len(jret) == (2 if num_fine else 1)
    for (trgb, _, tacc), (jrgb, _, jacc) in zip(tret, jret):
        np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), **F32_TOL)
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), atol=1e-4, rtol=1e-5)


def test_viewdirs_loss_and_grads_match_jax(monkeypatch):
    """The training loss and every parameter's gradient of a use_viewdirs
    model against JAX's loss_fn run op-by-op (f32; sparsity weight 0, as
    og_nerf.yaml: the JAX train step asserts view directions in its
    sparsity query of such a model). Then the port's sparsity term of the
    same model, queried at zero view directions, against the JAX model's
    sigma there (through eval_points_cross: its eval_points_raw mis-shapes
    the view branch's input)."""
    from plenoctree_tpu import engine as jengine

    jcfg = jconfig.default_config(**dict(BASE, sparsity_weight=0.0))
    tcfg = tconfig.default_config(**dict(BASE, sparsity_weight=0.0))
    jmodel, params, tmodel = _models()
    params = _with_biases(params, 7)
    tmodel.load_state_dict(params_from_flax(params))
    _fine_depths(monkeypatch)
    o, d, v = _rays(8)
    pixels = np.random.default_rng(9).uniform(size=(o.shape[0], 3)).astype(np.float32)
    rng = random.PRNGKey(10)
    step = jengine.make_train_step(jmodel, jcfg, donate=False)
    state = jckpt.create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, params)})
    with jax.disable_jit():
        new_state, jstats, _ = step(
            state, {"rays": JaxRays(*map(jnp.asarray, (o, d, v))), "pixels": jnp.asarray(pixels)},
            rng,
        )
    key_2 = random.split(random.fold_in(rng, 0), 3)[2]
    sp = np.asarray(random.uniform(key_2, (jcfg.sparsity_npoints, 3),
                                   minval=-jcfg.sparsity_radius, maxval=jcfg.sparsity_radius))
    stats, grads = engine.loss_and_grads(
        tmodel, {"rays": Rays(_t(o), _t(d), _t(v)), "pixels": _t(pixels)}, tcfg,
        draws={"sp_points": _t(sp)},
    )
    for name in engine.Stats._fields:
        np.testing.assert_allclose(float(getattr(stats, name)), float(getattr(jstats, name)),
                                   err_msg=name, **F32_TOL)
    tcfg.sparsity_weight = 1e-3
    stats_sp, _ = engine.loss_and_grads(
        tmodel, {"rays": Rays(_t(o), _t(d), _t(v)), "pixels": _t(pixels)}, tcfg,
        draws={"sp_points": _t(sp)},
    )
    _, jsigma = jmodel.apply({"params": params}, jnp.asarray(sp), jnp.zeros((1, 3)),
                             method=jmodel.eval_points_cross)
    with torch.no_grad():
        _, tsigma = tmodel.eval_points_raw(_t(sp), viewdirs=torch.zeros(sp.shape))
    np.testing.assert_allclose(tsigma.numpy(), np.asarray(jsigma), **F32_TOL)
    # 1 - mean(exp(-x)) cancels in f32 at these small densities: compared
    # in absolute terms.
    want_sp = 1e-3 * (1.0 - np.exp(-tcfg.sparsity_length * np.maximum(jsigma, 0)).mean())
    assert float(stats_sp.loss_sp) > 0
    np.testing.assert_allclose(float(stats_sp.loss_sp), want_sp, rtol=0, atol=1e-10)
    jgrads = params_to_flax(params_from_flax(new_state.opt_state[0].mu))
    got = params_to_flax(grads)
    assert sorted(got) == sorted(jgrads)
    for mlp in jgrads:
        assert sorted(got[mlp]) == sorted(jgrads[mlp])
        for layer, leaves in jgrads[mlp].items():
            for leaf, mu in leaves.items():
                err = _rel(got[mlp][layer][leaf], mu / np.float32(1 - 0.9))
                assert err <= F32_GRAD_RTOL, (mlp, layer, leaf, err)


@pytest.mark.parametrize("config", ["og_nerf", "proj"])
def test_viewdirs_checkpoints_both_ways(config, tmp_path):
    """Checkpoints of the og_nerf / proj models (the view branch's layers
    included) restore in both packages with equal params. The JAX side
    builds the proj model with sh_deg -1 (it refuses SH with use_viewdirs)."""
    cfg = tconfig.parse_flags(
        __import__("plenoctree_tpu_torch.cli.train", fromlist=["build_parser"]).build_parser(),
        ["--config", f"nerf_sh/config/misc/{config}", "--net_depth", "3", "--net_width", "32",
         "--net_width_condition", "16", "--train_dir", str(tmp_path / "port")],
    )
    assert cfg.use_viewdirs
    model = tnerf.construct_nerf(cfg, seed=3)
    names = sorted(params_to_flax(model)["MLP_0"])
    assert names == [f"Dense_{i}" for i in range(7)]  # 3 trunk, sigma, bottleneck, 1 cond, rgb
    state = ckpt.create_train_state(model)
    state.step = 5
    ckpt.save_checkpoint(str(tmp_path / "port"), state, 5)
    jkw = dict(net_depth=3, net_width=32, net_width_condition=16, use_viewdirs=True, sh_deg=-1)
    _, jvars = jax_construct_nerf(random.PRNGKey(0), jconfig.default_config(**jkw))
    jstate = jckpt.restore_checkpoint(str(tmp_path / "port"), jckpt.create_train_state(jvars))
    assert int(jstate.step) == 5
    jparams = jax.tree_util.tree_map(np.asarray, flax_params(jstate.variables))
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(params_from_flax(jparams)[k].numpy(), t.numpy())
    # and back: a JAX checkpoint restores in the port
    # (the legacy msgpack layout, as test_torch_train.py writes it: the
    # port does not read orbax directories)
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "checkpoint_7").write_bytes(
        serialization.to_bytes(jstate.replace(step=jnp.int32(7))))
    fresh = tnerf.construct_nerf(cfg, seed=4)
    restored = ckpt.restore_checkpoint(str(tmp_path / "jax"), ckpt.create_train_state(fresh))
    assert restored.step == 7
    for k, t in restored.params.items():
        np.testing.assert_array_equal(t.detach().numpy(), model.state_dict()[k].numpy())


NAMES = sorted(tnerf._ACTIVATIONS)


@pytest.mark.parametrize("name", NAMES)
def test_activation_matches_flax_linen(name):
    """Every activation name against getattr(flax.linen, name) over a wide
    range (f32; 2e-6 relative for libm's and XLA's transcendental rounding,
    1e-6 absolute for the tails where 1 + tanh or 1 - e^x cancels: gelu's
    near x = -5, measured 4.4e-7)."""
    x = np.concatenate([np.linspace(-30, 30, 2001), [-1e4, -90.0, 0.0, 90.0, 1e4]])
    x = x.astype(np.float32)
    want = np.asarray(getattr(fnn, name)(jnp.asarray(x)))
    got = tnerf.activation_by_name(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def test_gelu_is_the_tanh_approximation():
    """flax.linen.gelu defaults to approximate=True; torch's exact erf form
    differs by up to ~5e-4, which this test tells apart."""
    x = torch.linspace(-4, 4, 801)
    want = np.asarray(fnn.gelu(jnp.asarray(x.numpy())))
    got = tnerf.activation_by_name("gelu")(x).numpy()
    exact = torch.nn.functional.gelu(x).numpy()
    assert np.abs(got - want).max() <= 2e-6 < np.abs(exact - want).max()


def test_unknown_activation_and_fused_non_relu_trunk_raise():
    """A name without a counterpart raises instead of guessing; the fused
    kernels apply ReLU whatever the trunk's activation (as the JAX kernel
    does), so use_pallas with a non-relu trunk is refused; the probe of the
    output activations' ranges raises as in the JAX package."""
    with pytest.raises(ValueError, match="no counterpart"):
        tnerf.activation_by_name("glu")
    with pytest.raises(ValueError, match="no counterpart"):
        tnerf.activation_by_name("mish")
    kw = dict(BASE, use_viewdirs=False, sh_deg=1)
    with pytest.raises(ValueError, match="ReLU"):
        tnerf.NerfModel(tconfig.default_config(**kw, net_activation="elu", use_pallas=True))
    model = tnerf.NerfModel(tconfig.default_config(**kw, net_activation="elu"))
    with pytest.raises(ValueError, match="ReLU"):
        model.eval_points_raw(torch.zeros(4, 3), use_pallas=True)
    # a view-conditioned model never takes the kernels: accepted
    tnerf.NerfModel(tconfig.default_config(**BASE, net_activation="elu", use_pallas=True))
    with pytest.raises(NotImplementedError, match="outside"):
        tnerf.NerfModel(tconfig.default_config(**kw, rgb_activation="relu"))
    with pytest.raises(NotImplementedError, match="negative"):
        tnerf.NerfModel(tconfig.default_config(**kw, sigma_activation="tanh"))


@pytest.mark.parametrize("net_activation", ["elu", "gelu", "softplus"])
def test_non_relu_trunk_matches_flax(net_activation, monkeypatch):
    """A non-relu trunk (plain path) renders as the flax model with that
    activation."""
    jmodel, params, tmodel = _models(net_activation=net_activation)
    params = _with_biases(params, 11)
    tmodel.load_state_dict(params_from_flax(params))
    _fine_depths(monkeypatch)
    o, d, v = _rays(12)
    jret = jmodel.apply({"params": params}, random.PRNGKey(1), random.PRNGKey(2),
                        JaxRays(*map(jnp.asarray, (o, d, v))), False)
    with torch.no_grad():
        tret = tmodel(Rays(_t(o), _t(d), _t(v)), False)
    for (trgb, _, _), (jrgb, _, _) in zip(tret, jret):
        np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), **F32_TOL)


# ---------------------------------------------------------------- projection


def _sphere_fn(seed, p=5, c=3):
    """A smooth directional function: per-point quadratic forms of the
    direction (exactly SH of degree 2)."""
    a = np.random.default_rng(seed).normal(size=(p, c, 3, 3)).astype(np.float32)

    def fn(dirs):
        vals = np.einsum("pcij,si,sj->psc", a, dirs, dirs).astype(np.float32)
        return vals, np.zeros((p, 1), np.float32)

    return fn


@pytest.mark.parametrize("sparse", [False, True])
def test_project_function_matches_jax(sparse):
    """project_function_nerf (Monte-Carlo) and _sparse (least squares)
    against the JAX package's, given generators at the same seed (the same
    directions), rtol 1e-5; the generators end in the same state."""
    fn = _sphere_fn(0)
    name = "project_function_nerf_sparse" if sparse else "project_function_nerf"
    rj, rp = np.random.default_rng(3), np.random.default_rng(3)
    want, _ = getattr(jsh_project, name)(2, fn, 500, rj)
    got, _ = getattr(sh_project, name)(2, fn, 500, rp)
    assert tuple(got.shape) == want.shape == (5, 3, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=PROJ_RTOL, atol=1e-6)
    assert rj.random() == rp.random()
    np.testing.assert_array_equal(
        sh_project.spherical_uniform_dirs(64, np.random.default_rng(4)),
        jsh_project.spherical_uniform_dirs(64, np.random.default_rng(4)),
    )


def _extract_cfg(**over):
    kw = dict(BASE, sh_deg=1, chunk=4096, init_grid_depth=3, alpha_thresh=0.0,
              masking_mode="sigma", samples_per_cell=2, projection_samples=64)
    kw.update(over)
    return jconfig.default_config(**kw), tconfig.default_config(**kw)


def test_projection_extraction_matches_jax():
    """Steps 1 and 2 of a use_viewdirs model's extraction (SH projection to
    degree 1) on a small tree, against the JAX package's with the same
    model and generator: the same topology, the leaves' SH coefficients
    and sigma within 1e-5, the generator in the same state after."""
    from plenoctree_tpu.octree import N3Tree as JaxN3Tree
    from plenoctree_tpu.octree import extract as jextract
    from plenoctree_tpu_torch.octree import N3Tree
    from plenoctree_tpu_torch.octree import extract as textract

    jcfg, tcfg = _extract_cfg()
    jmodel, jvars = jax_construct_nerf(
        random.PRNGKey(0), jconfig.default_config(**dict(vars(jcfg), sh_deg=-1))
    )
    params = _with_biases(jax.tree_util.tree_map(np.asarray, flax_params(jvars)), 13)
    tmodel = tnerf.NerfModel(tcfg)
    tmodel.load_state_dict(params_from_flax(params))
    cross_jit = jax.jit(
        lambda p, d: jmodel.apply({"params": params}, p, d, method=jmodel.eval_points_cross)
    )
    jcross = lambda p, d: jax.device_get(cross_jit(p, d))  # noqa: E731

    def jpoints(p, v):
        # Sigma at a zero view direction, through eval_points_cross: the
        # JAX model's eval_points_raw mis-shapes the view branch's input
        # (its points[None] batch), so its extract CLI cannot run step 1 of
        # a use_viewdirs model.
        rgb, sigma = cross_jit(jnp.asarray(p), jnp.zeros((1, 3), jnp.float32))
        return rgb[:, 0], sigma

    trees = []
    for Tree in (JaxN3Tree, N3Tree):
        trees.append(Tree(data_dim=1 + 3 * 4, depth_limit=3, radius=1.3, center=(0, 0, 0),
                          data_format="SH4", init_reserve=100))
    rj, rp = np.random.default_rng(20200823), np.random.default_rng(20200823)
    jextract.step1_build(jcfg, trees[0], jpoints, dataset=None)
    jextract.step2_fill(jcfg, trees[0], jpoints, jcross, rng=rj)
    textract.step1_build(tcfg, trees[1], textract.make_points_fn(tmodel, "cpu"), None)
    textract.step2_fill(tcfg, trees[1], textract.make_points_fn(tmodel, "cpu"), rng=rp,
                        cross_fn=textract.make_cross_fn(tmodel, "cpu"))
    assert trees[0].n_leaves == trees[1].n_leaves > 8
    np.testing.assert_array_equal(trees[0].child, trees[1].child)
    np.testing.assert_allclose(trees[1].data, trees[0].data, rtol=1e-5, atol=1e-5)
    assert np.abs(trees[1].data[..., :-1]).max() > 1e-3  # the coefficients are not vacuous
    assert rj.random() == rp.random()


def test_projection_needs_cross_fn_and_dc_is_the_mean():
    """step2_fill of a use_viewdirs model without cross_fn raises; the
    projected DC coefficient decodes to the spherical mean of the raw rgb
    (the JAX package's tests/test_extraction_heads.py check)."""
    from plenoctree_tpu_torch.octree import N3Tree
    from plenoctree_tpu_torch.octree import extract as textract
    from plenoctree_tpu_torch.ops.sh import SH_C0

    _, tcfg = _extract_cfg(sh_deg=2)
    model = tnerf.construct_nerf(tcfg, seed=1)
    tree = N3Tree(data_dim=28, depth_limit=1, radius=1.0, center=(0, 0, 0),
                  data_format="SH9", init_reserve=10)
    with pytest.raises(ValueError, match="cross_fn"):
        textract.step2_fill(tcfg, tree, textract.make_points_fn(model, "cpu"))
    cross = textract.make_cross_fn(model, "cpu")
    pts = np.zeros((1, 3), np.float32)
    coeffs, sigma = textract.project_nerf_to_sh(cross, 2, pts, 4000, np.random.default_rng(3))
    assert tuple(coeffs.shape) == (1, 27) and tuple(sigma.shape) == (1, 1)
    dirs = sh_project.spherical_uniform_dirs(4000, np.random.default_rng(9))
    raw_rgb, _ = cross(pts, dirs)
    mean_rgb = raw_rgb.mean(dim=1)[0].numpy()
    np.testing.assert_allclose(coeffs.reshape(3, 9)[:, 0].numpy() * SH_C0, mean_rgb,
                               rtol=0.1, atol=0.02)
