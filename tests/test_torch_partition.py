"""Port parity on the CPU: tensor parallelism over the mesh's "model" axis
(plenoctree_tpu_torch/parallel/partition.py, mesh.py's layout and groups,
the train CLI's --mesh_shape D,M) against the JAX package's
plenoctree_tpu/parallel/partition.py.

The specs equal the JAX param_specs on the same tree. A DP x TP step on 4
gloo ranks laid out 2 x 2 is held to the port's one-process step, and to
JAX's op-by-op step on its 4 x 2 mesh with the state sharded by its own
shard_train_state, at tests/test_partition.py's bounds (loss rtol 2e-5,
params rtol 5e-5 / atol 1e-6): the sharded columns' sums come in other
orders, nothing else differs. As in tests/test_torch_parallel.py the JAX
step runs op by op and coarse-only, each step from the port's parameters.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax import random

from plenoctree_tpu import engine as jengine
from plenoctree_tpu.models import construct_nerf as jax_construct_nerf
from plenoctree_tpu.models import get_model_state as jax_get_model_state
from plenoctree_tpu.parallel import make_mesh as jax_make_mesh
from plenoctree_tpu.parallel import shard_pytree_batch
from plenoctree_tpu.parallel.partition import param_specs as jax_param_specs
from plenoctree_tpu.parallel.partition import shard_train_state as jax_shard_train_state
from plenoctree_tpu.types import Rays as JaxRays
from plenoctree_tpu.utils import checkpoints as jckpt
from plenoctree_tpu.utils import config as jconfig
from plenoctree_tpu_torch import parallel
from plenoctree_tpu_torch.cli import train as train_cli
from plenoctree_tpu_torch.models.nerf import NerfModel, get_model_state
from plenoctree_tpu_torch.models.params import params_from_flax
from plenoctree_tpu_torch.parallel import partition
from plenoctree_tpu_torch.parallel.ranks import run_ranks, train_steps
from plenoctree_tpu_torch.utils import config as tconfig

from tests.test_torch_parallel import (
    B, CFG, STATS, WORKER, _batch, _free_port, _jax_state, _params, _rel, _warm_adam,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 2e-5  # tests/test_partition.py
PARAM_TOL = dict(rtol=5e-5, atol=1e-6)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("sh_deg,sg_dim,width,model_size", [(1, 0, 32, 2), (3, 0, 32, 4),
                                                            (-1, 5, 24, 2), (2, 0, 32, 3)])
def test_param_specs_equal_jax(sh_deg, sg_dim, width, model_size):
    """On the JAX model's own params tree (SH heads of 12 and 48 columns, an
    SG head of 15 with its top-level sg_lambda / sg_mu_spher, a model size
    that divides no trunk layer but the 27-column head): every leaf's spec
    equals the JAX PartitionSpec;
    the port's flat state dict gets the same specs under its dotted names."""
    cfg = jconfig.default_config(net_depth=3, net_width=width, sh_deg=sh_deg,
                                 sg_dim=sg_dim if sg_dim else -1, use_viewdirs=False,
                                 num_coarse_samples=4, num_fine_samples=4)
    _, state = jax_get_model_state(random.PRNGKey(0), cfg, restore=False)
    tree = jax.tree_util.tree_map(np.asarray, state.variables["params"])
    want = _leaves(jax_param_specs(tree, model_size))
    got = _leaves(partition.param_specs(tree, model_size))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    flat = partition.param_specs(params_from_flax(tree), model_size)
    assert {k.replace(".", "/"): v for k, v in flat.items()} == got
    assert bool(got["MLP_0/Dense_0/kernel"]) == (width % model_size == 0)


@pytest.mark.parametrize("shape,n", [("1,2", 2), ("2,2", 4), ("-1,2", 4), ("4,2", 8), ("2,4", 8)])
def test_model_axis_no_longer_refused(shape, n):
    """make_mesh takes a model axis above 1 (it raised NotImplementedError
    before the model axis was ported), shaped as the JAX make_mesh shapes
    it."""
    mesh = parallel.make_mesh(shape, ["cpu"] * n)
    jmesh = jax_make_mesh(shape, jax.devices()[:n])
    assert (mesh.data, mesh.model) == (jmesh.shape["data"], jmesh.shape["model"])
    assert parallel.mesh.parse_mesh_shape(shape, n) == (mesh.data, mesh.model)


def test_groups_are_laid_out_row_major():
    """init_groups over 4 ranks as (2, 2): rank = data * 2 + model, as JAX
    reshapes its devices; data-axis groups join the ranks of one model
    index, model-axis groups those of one data index."""
    out = run_ranks("plenoctree_tpu_torch.parallel.ranks:groups", 4, dict(mesh_shape="2,2"),
                    timeout=60, threads=1)
    assert out == [(0, 0, [0, 2], [0, 1]), (0, 1, [1, 3], [0, 1]),
                   (1, 0, [0, 2], [2, 3]), (1, 1, [1, 3], [2, 3])]


def _draws(n_steps, seed):
    rng = np.random.default_rng(seed)
    return [{"t_rand": rng.uniform(size=(B, 8)).astype(np.float32),
             "u": rng.uniform(size=(B, 9)).astype(np.float32),
             "sp_points": rng.uniform(-1.5, 1.5, (128, 3)).astype(np.float32)}
            for _ in range(n_steps)]


@pytest.mark.parametrize("dtype,use_pallas", [("float32", False), ("bfloat16", True)])
def test_dp_tp_steps_match_one_process(dtype, use_pallas):
    """3 steps on 4 gloo ranks laid out 2 x 2 (each data index half of the
    global batch, each model rank half of every trunk's and head's columns;
    with use_pallas the fused trunk on gathered weights) against the port's
    one-process step, coarse and fine, on the same draws: losses within
    rtol 2e-5, parameters within rtol 5e-5 / atol 1e-6 after every step,
    the four ranks' whole parameters bitwise equal, and every leaf moved."""
    cfg = dict(CFG, randomized=True, compute_dtype=dtype, use_pallas=use_pallas)
    params = _params(60)
    kw = dict(cfg=cfg, params=params, batches=[_batch(61 + k) for k in range(3)],
              draws=_draws(3, 64), opt_state=_warm_adam(params, 65))
    one = train_steps(0, 1, **kw)
    four = run_ranks(WORKER, 4, dict(kw, mesh_shape="2,2", launches=True), threads=1)
    for k in range(3):
        for name in ("loss", "loss_c", "weight_l2"):
            np.testing.assert_allclose(four[0]["stats"][k][name], one["stats"][k][name],
                                       rtol=LOSS_RTOL, err_msg=f"step {k} {name}")
        for name, p in one["params"][k + 1].items():
            np.testing.assert_allclose(four[0]["params"][k + 1][name], p, err_msg=name,
                                       **PARAM_TOL)
    for r in range(1, 4):
        for name, p in four[0]["params"][-1].items():
            np.testing.assert_array_equal(four[r]["params"][-1][name], p)
    for name, p in one["params"][-1].items():
        assert not np.array_equal(p, params[name]), name
    assert all(r["model_collectives_ms"] > 0 for r in four)


def test_dp_tp_steps_match_jax_op_by_op_tp_step():
    """3 coarse steps on 4 gloo ranks laid out 2 x 2 against the JAX mesh
    step over its 8 CPU devices as 4 x 2, the state sharded by the JAX
    shard_train_state (TP columns on "model", the batch on "data"), each
    step from the same parameters and Adam moments (the port's, before that
    step) on the same batch and sparsity points (JAX's own key_2 draw):
    stats within rtol 2e-5, parameters within rtol 5e-5 / atol 1e-6, the
    gradients (from JAX's new mu) within tests/test_torch_parallel.py's
    1e-4 per leaf."""
    cfg = dict(CFG, num_fine_samples=0)
    params = _params(70, fine=False)
    opt = _warm_adam(params, 71)
    key = random.PRNGKey(72)
    batches = [_batch(73 + k) for k in range(3)]
    sp = [np.asarray(random.uniform(random.split(random.fold_in(key, opt["count"] + k), 3)[2],
                                    (cfg["sparsity_npoints"], 3), minval=-1.5, maxval=1.5))
          for k in range(3)]
    got = run_ranks(WORKER, 4, dict(cfg=cfg, params=params, batches=batches,
                                    draws=[{"sp_points": s} for s in sp], opt_state=opt,
                                    mesh_shape="2,2"), threads=1)[0]
    jcfg = jconfig.default_config(**cfg)
    jmodel, _ = jax_construct_nerf(random.PRNGKey(0), jcfg)
    mesh = jax_make_mesh((4, 2))
    step = jengine.make_train_step(jmodel, jcfg, mesh, donate=False)
    for k, b in enumerate(batches):
        moments = {"count": opt["count"] + k, "mu": got["mu"][k], "nu": got["nu"][k]}
        state = jax_shard_train_state(_jax_state(got["params"][k], moments), mesh)
        jb = shard_pytree_batch({"rays": JaxRays(*b["rays"]), "pixels": b["pixels"]}, mesh)
        with jax.disable_jit():
            new, jstats, _ = step(state, jb, key)
        for name in STATS:
            np.testing.assert_allclose(got["stats"][k][name], float(getattr(jstats, name)),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=f"step {k} {name}")
        jmu = params_from_flax(jax.device_get(new.opt_state[0].mu))
        jparams = params_from_flax(jax.device_get(new.variables["params"]))
        for name, g in got["grads"][k].items():
            jg = (jmu[name].numpy().astype(np.float64) - 0.9 * got["mu"][k][name]) / 0.1
            assert _rel(g, jg) <= 1e-4, (k, name, _rel(g, jg))
            np.testing.assert_allclose(got["params"][k + 1][name], jparams[name].numpy(),
                                       err_msg=f"step {k} {name}", **PARAM_TOL)


def test_shard_and_gather_train_state_round_trip():
    """shard_train_state cuts params and Adam moments by the specs (in one
    process, a model group of one rank each for index 0 and 1 of 2, no
    collective needed to cut); ModelParallel's column helpers invert it."""
    model = NerfModel(tconfig.default_config(**CFG))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in _params(80).items()})
    from plenoctree_tpu_torch.utils import checkpoints as ckpt_utils

    whole = ckpt_utils.create_train_state(model)
    for t in whole.opt_state["mu"].values():
        t.normal_()
    specs = partition.param_specs(whole.params, 2)
    for index in (0, 1):
        lay = parallel.Layout(rank=index, world=2, data=1, model=2)
        m = NerfModel(tconfig.default_config(**CFG))
        m.load_state_dict(model.state_dict())
        st = partition.shard_train_state(whole, m, lay)
        for name, p in st.params.items():
            want = partition.shard_leaf(whole.params[name].detach(), specs[name], index, 2)
            assert torch.equal(p.detach(), want), name
            assert torch.equal(st.opt_state["mu"][name],
                               partition.shard_leaf(whole.opt_state["mu"][name], specs[name],
                                                    index, 2))
            assert (name in m.tp.sharded) == bool(specs[name])
        assert m.tp.full_numel == sum(p.numel() for p in whole.params.values())
        assert sum(p.numel() for p in st.params.values()) < m.tp.full_numel


def _train_argv(train_dir, extra):
    return ["--config", "nerf_sh/config/blender", "--dataset", "synthetic", "--device", "cpu",
            "--net_depth", "2", "--net_width", "16", "--sh_deg", "1",
            "--num_coarse_samples", "4", "--num_fine_samples", "4",
            "--synthetic_resolution", "16", "--chunk", "256", "--train_dir", train_dir,
            "--batch_size", "64", "--image_batching", "--max_steps", "3", "--print_every", "1",
            "--save_every", "2", "--render_every", "2", "--sparsity_npoints", "32", *extra]


def test_train_cli_under_torchrun_with_mesh_2x2(tmp_path):
    """torch.distributed.run with 4 CPU ranks and --mesh_shape 2,2: every rank
    reports its model-axis collectives, rank 0 alone writes (two
    checkpoints in the one-process layout, renders), and the last
    checkpoint restores in the JAX package and in the port at world size
    1 with whole leaves; Adam's moments are whole too."""
    train_dir = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4",
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           "-m", "plenoctree_tpu_torch.cli.train", *_train_argv(train_dir, ["--mesh_shape", "2,2"])]
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = res.stdout.splitlines()
    for r in range(4):
        assert sum(ln.startswith(f"* rank {r}/4: 3 steps") and "model collectives" in ln
                   for ln in lines) == 1, r
    assert sum("data 1/2, model 1/2" in ln for ln in lines) == 1
    names = sorted(os.listdir(train_dir))
    assert "checkpoint_2" in names and "checkpoint_3" in names
    assert sorted(os.listdir(os.path.join(train_dir, "render"))) == ["0000000002.png"]
    model = _train_argv(train_dir, [])[:18]
    cfg = tconfig.parse_flags(train_cli.build_parser(), model + ["--train_dir", train_dir])
    _, state = get_model_state(cfg, restore=True)
    assert state.step == 3 and state.opt_state["count"] == 3
    assert state.params["MLP_0.Dense_0.kernel"].shape == (63, 16)
    jcfg = jconfig.default_config(**{k: getattr(cfg, k) for k in (
        "net_depth", "net_width", "sh_deg", "num_coarse_samples", "num_fine_samples",
        "use_viewdirs", "sg_dim")})
    _, jvars = jax_construct_nerf(random.PRNGKey(0), jcfg)
    restored = jckpt.restore_checkpoint(train_dir, jckpt.create_train_state(jvars))
    assert int(restored.step) == 3
    jflat = params_from_flax(jax.tree_util.tree_map(np.asarray, restored.variables["params"]))
    for k, t in state.params.items():
        np.testing.assert_array_equal(jflat[k].numpy(), t.detach().numpy())


def test_train_cli_in_one_process_replicates_the_model_axis(tmp_path, capsys):
    """Without a process group --mesh_shape 1,2 trains as one process (the
    model axis replicated, as the JAX CLI replicates its state over the
    mesh); 2,2 still asks for torch.distributed.run."""
    train_cli.main(_train_argv(str(tmp_path / "one"), ["--mesh_shape", "1,2", "--max_steps", "1",
                                                        "--render_every", "0"]))
    assert "the model axis is replicated" in capsys.readouterr().out
    assert "checkpoint_1" in os.listdir(tmp_path / "one")
    with pytest.raises(ValueError, match="torch.distributed.run"):
        train_cli.main(_train_argv(str(tmp_path / "two"), ["--mesh_shape", "2,2"]))
