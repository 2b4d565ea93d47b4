"""Checkpoints the JAX package writes, read by the port.

The JAX package's save_checkpoint writes orbax directories here (flax's
`flax_use_orbax_checkpointing` is on): a tiny and a full-width blender SH16
TrainState restore in the port with params, Adam mu, nu and count, and step
bitwise equal; the orbax and the msgpack form of one state read as the same
dict; original JaxNeRF trees ({'optimizer': {'target', 'state'}}), with and
without `params`, as orbax and as msgpack, import as the JAX package's own
restore_checkpoint imports them (the same params and step, a fresh Adam);
the OCDBT reader's keys and values equal tensorstore's on stores with
interior nodes and out-of-line values; zarr arrays of many chunks, absent
chunks and every dtype read as tensorstore reads them; and damaged or
unknown files raise.
"""

import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization
from flax.training import checkpoints as flax_checkpoints
from jax import random

from plenoctree_tpu.models import get_model_state as jax_get_model_state
from plenoctree_tpu.utils import checkpoints as jckpt
from plenoctree_tpu.utils import config as jconfig
from plenoctree_tpu_torch.models import nerf as tnerf
from plenoctree_tpu_torch.models.params import init_trunk_params, params_from_flax
from plenoctree_tpu_torch.utils import checkpoints as ckpt
from plenoctree_tpu_torch.utils import config as tconfig
from plenoctree_tpu_torch.utils import ocdbt

TINY = dict(net_depth=2, net_width=16, sh_deg=1, num_coarse_samples=4, num_fine_samples=4)


def _noise(tree, rng, scale, positive=False):
    def draw(a):
        x = rng.normal(size=np.shape(a)).astype(np.float32) * scale
        return jnp.asarray(np.abs(x) if positive else x)

    return jax.tree_util.tree_map(draw, tree)


def _trained_jax_state(cfg, step=200, count=200, seed=0):
    """A JAX TrainState of cfg's model with non-zero Adam moments."""
    _, state = jax_get_model_state(random.PRNGKey(seed), cfg, restore=False)
    rng = np.random.default_rng(seed)
    adam = state.opt_state[0]
    adam = adam._replace(count=jnp.int32(count), mu=_noise(adam.mu, rng, 1e-3),
                         nu=_noise(adam.nu, rng, 1e-6, positive=True))
    return state.replace(step=step, opt_state=(adam,) + tuple(state.opt_state[1:]))


def _cfgs(tmp_path, **kw):
    jcfg = jconfig.default_config(config="nerf_sh/config/blender", **kw)
    jconfig.update_flags(jcfg)
    for k, v in kw.items():
        setattr(jcfg, k, v)
    tcfg = tconfig.default_config(config="nerf_sh/config/blender", train_dir=str(tmp_path), **kw)
    tconfig.update_flags(tcfg)
    for k, v in kw.items():
        setattr(tcfg, k, v)
    return jcfg, tcfg


def _assert_state_equal(tstate, jstate):
    assert tstate.step == int(jstate.step)
    adam = jstate.opt_state[0]
    assert tstate.opt_state["count"] == int(adam.count)
    for mine, theirs in ((tstate.params, jstate.variables["params"]),
                         (tstate.opt_state["mu"], adam.mu), (tstate.opt_state["nu"], adam.nu)):
        want = params_from_flax(jax.tree_util.tree_map(np.asarray, theirs))
        assert sorted(want) == sorted(mine)
        for k, t in mine.items():
            np.testing.assert_array_equal(t.detach().numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_orbax_train_state_restores_bitwise(width, tmp_path):
    """save_checkpoint (orbax) of a TrainState, restored by the port's
    get_model_state(restore=True). The full-width case is blender SH16
    (8x256, both trunks, 1 + 48 head): 1,011,298 parameters; its restore
    time is printed (pytest -s), a CPU number from this sandbox."""
    kw = TINY if width == "tiny" else {}
    jcfg, tcfg = _cfgs(tmp_path, **kw)
    jstate = _trained_jax_state(jcfg)
    jckpt.save_checkpoint(str(tmp_path), jstate, 200)
    assert os.path.isdir(tmp_path / "checkpoint_200")  # orbax's layout, not a file
    t0 = time.perf_counter()
    _, tstate = tnerf.get_model_state(tcfg, seed=1, restore=True)
    seconds = time.perf_counter() - t0
    print(f"\n{width}-width orbax restore (get_model_state): {seconds:.2f} s on the CPU")
    _assert_state_equal(tstate, jstate)


def test_orbax_and_msgpack_read_the_same(tmp_path):
    jcfg, _ = _cfgs(tmp_path, **TINY)
    jstate = _trained_jax_state(jcfg, step=7, count=3)
    jckpt.save_checkpoint(str(tmp_path / "orbax"), jstate, 7)
    (tmp_path / "checkpoint_7").write_bytes(serialization.to_bytes(jstate))
    a = ckpt.read_checkpoint(str(tmp_path / "orbax" / "checkpoint_7"))
    b = ckpt.read_checkpoint(str(tmp_path / "checkpoint_7"))

    def same(x, y, path=()):
        if isinstance(y, dict):
            assert isinstance(x, dict) and sorted(x) == sorted(y), path
            for k in y:
                same(x[k], y[k], path + (k,))
        else:
            assert type(x) is type(y) or (np.asarray(x).dtype == np.asarray(y).dtype), path
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))

    same(a, b)
    assert a["step"] == 7 and int(a["opt_state"]["0"]["count"]) == 3


def _reference_tree(seed, with_params):
    rng = np.random.default_rng(seed)
    params = {name: init_trunk_params(rng, 63, 2, 16, 4, 1, 12, bias_std=0.05)
              for name in ("MLP_0", "MLP_1")}
    target = {"params": params} if with_params else params
    # flax.optim.Adam's state: a step and per-parameter moments.
    moments = jax.tree_util.tree_map(lambda a: {"grad_ema": a * 0.5, "grad_sq_ema": a * a},
                                     params)
    return {"optimizer": {"target": target, "state": {"step": 4321, "param_states": moments}}}


@pytest.mark.parametrize("form", ["orbax", "msgpack"])
@pytest.mark.parametrize("with_params", [True, False])
def test_original_jaxnerf_checkpoints_import(form, with_params, tmp_path):
    raw = _reference_tree(5, with_params)
    if form == "orbax":
        flax_checkpoints.save_checkpoint(str(tmp_path), raw, 4321)
        assert os.path.isdir(tmp_path / "checkpoint_4321")
    else:
        (tmp_path / "checkpoint_4321").write_bytes(serialization.to_bytes(raw))
    jcfg, tcfg = _cfgs(tmp_path, **TINY)
    jcfg.train_dir = str(tmp_path)
    _, jstate = jax_get_model_state(random.PRNGKey(0), jcfg, restore=True)
    _, tstate = tnerf.get_model_state(tcfg, seed=1, restore=True)
    assert int(jstate.step) == 4321 and int(jstate.opt_state[0].count) == 0
    _assert_state_equal(tstate, jstate)
    for m in ("mu", "nu"):
        assert all(not t.any() for t in tstate.opt_state[m].values())


def _tensorstore():
    return pytest.importorskip("tensorstore")


STORES = [
    dict(max_inline_value_bytes=40, max_decoded_node_bytes=200),
    dict(max_inline_value_bytes=0, max_decoded_node_bytes=120, compression={"id": "zstd"}),
    dict(max_inline_value_bytes=300, max_decoded_node_bytes=100000),
]


@pytest.mark.parametrize("case", range(len(STORES)))
def test_ocdbt_keys_and_values_match_tensorstore(case, tmp_path):
    """Random writes (60, over several versions) into an OCDBT store under
    small node and inline limits: interior B-tree nodes, prefix-compressed
    keys, inline and out-of-line values."""
    ts = _tensorstore()
    root = str(tmp_path / "store")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}",
                          "config": STORES[case]}).result()
    rng = np.random.default_rng(case)
    want = {}
    for _ in range(60):
        k = (f"{rng.choice(['opt_state.0.mu', 'variables.params.MLP_0.Dense_'])}"
             f"{int(rng.integers(0, 40))}/{rng.choice(['.zarray', '0', '0.0'])}")
        want[k] = bytes(rng.integers(0, 256, int(rng.integers(0, 500)), dtype=np.uint8))
        kv.write(k, want[k]).result()
    store = ocdbt.OcdbtStore(root)
    got = store.items()
    assert list(got) == sorted(x.decode() for x in kv.list().result())
    assert got == want
    if case < 2:
        assert store.root_ref[3] > 0  # the root is an interior node


@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<i4", "<i8", "|b1", "<u4"])
def test_zarr_chunks_assemble_as_tensorstore_reads_them(dtype, tmp_path):
    """A zarr v2 array in an OCDBT store: chunks that do not divide the
    shape, Fortran order, a fill value and chunks never written."""
    ts = _tensorstore()
    root = str(tmp_path / "store")
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}"},
            "path": "a.b", "metadata": {"shape": [7, 10], "chunks": [3, 4], "dtype": dtype,
                                        "order": "F",
                                        "fill_value": True if dtype == "|b1" else 1,
                                        "compressor": {"id": "zstd", "level": 1}}}
    arr = ts.open(spec, create=True).result()
    rng = np.random.default_rng(0)
    vals = (rng.normal(size=(5, 6)) * 50).astype(np.dtype(dtype))
    arr[1:6, 2:8].write(vals).result()
    want = arr.read().result()
    got = ocdbt.read_zarr(ocdbt.OcdbtStore(root).items(), "a.b")
    assert got.dtype == want.dtype and got.shape == (7, 10)
    np.testing.assert_array_equal(got, want)


def _orbax_dir(tmp_path):
    jcfg, _ = _cfgs(tmp_path, **TINY)
    jckpt.save_checkpoint(str(tmp_path / "run"), _trained_jax_state(jcfg, step=2, count=2), 2)
    return tmp_path / "run" / "checkpoint_2"


def _node_files(directory):
    out = []
    for root, _, files in os.walk(directory):
        for name in files:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                head = f.read(4)
            if head == b"\x0c\xdb\x20\xde":
                out.append(path)
    return out


def test_crc32c_and_damaged_files_raise(tmp_path):
    assert ocdbt.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    good = _orbax_dir(tmp_path)
    assert ckpt.read_checkpoint(str(good))["step"] == 2
    # a flipped byte in the root B-tree node: its CRC-32C footer no longer holds
    bad = tmp_path / "bad"
    shutil.copytree(good, bad)
    with open(bad / "manifest.ocdbt", "rb") as f:
        body = f.read()
    root_rel = [p for p in _node_files(bad) if "ocdbt.process" not in p]
    node = root_rel[0] if root_rel else _node_files(bad)[0]
    buf = bytearray(open(node, "rb").read())
    buf[len(buf) // 2] ^= 1
    open(node, "wb").write(bytes(buf))
    with pytest.raises(ValueError, match="CRC-32C"):
        ckpt.read_checkpoint(str(bad))
    # another compression byte, with a valid CRC: named as unknown
    weird = bytearray(body)
    weird[13] = 2
    weird[-4:] = ocdbt.crc32c(bytes(weird[:-4])).to_bytes(4, "little")
    (bad / "manifest.ocdbt").write_bytes(bytes(weird))
    with pytest.raises(ValueError, match="manifest.ocdbt: unknown compression byte 2"):
        ckpt.read_checkpoint(str(bad))


def test_unknown_layouts_raise(tmp_path):
    good = _orbax_dir(tmp_path)
    z3 = tmp_path / "z3"
    shutil.copytree(good, z3)
    meta = json.loads((z3 / "_METADATA").read_text())
    meta["use_zarr3"] = True
    (z3 / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="zarr3"):
        ckpt.read_checkpoint(str(z3))
    kv = ocdbt.OcdbtStore(str(good)).items()
    name = "opt_state.0.count"
    zarray = json.loads(kv[f"{name}/.zarray"])
    zarray["compressor"] = {"id": "blosc"}
    kv[f"{name}/.zarray"] = json.dumps(zarray).encode()
    with pytest.raises(ValueError, match="blosc"):
        ocdbt.read_zarr(kv, name)
    zarray["compressor"], zarray["dtype"] = None, "<c8"
    kv[f"{name}/.zarray"] = json.dumps(zarray).encode()
    with pytest.raises(ValueError, match="<c8"):
        ocdbt.read_zarr(kv, name)


def test_unfinished_orbax_save_is_skipped(tmp_path):
    jcfg, tcfg = _cfgs(tmp_path, **TINY)
    jckpt.save_checkpoint(str(tmp_path), _trained_jax_state(jcfg, step=3, count=3), 3)
    os.makedirs(tmp_path / "checkpoint_9.orbax-checkpoint-tmp-1234")
    _, tstate = tnerf.get_model_state(tcfg, seed=1, restore=True)
    assert tstate.step == 3 and tstate.opt_state["count"] == 3


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "jax_ckpt")


@pytest.mark.parametrize("name", ["train_state", "jaxnerf_orbax", "jaxnerf_msgpack"])
def test_committed_jax_fixtures(name, tmp_path):
    """The committed checkpoints (tests/torch_fixtures/make_jax_checkpoints.py,
    the JAX package's savers; chip_smoke.py phase 29 reads them on the
    card): the port restores the arrays want.npz holds, and the JAX
    package's own restore_checkpoint gives the same state."""
    want = np.load(os.path.join(FIXTURES, "want.npz"))
    kw = dict(net_depth=2, net_width=16)
    jcfg, tcfg = _cfgs(tmp_path, **kw)
    jcfg.train_dir = tcfg.train_dir = os.path.join(FIXTURES, name)
    _, tstate = tnerf.get_model_state(tcfg, seed=1, restore=True)
    _, jstate = jax_get_model_state(random.PRNGKey(0), jcfg, restore=True)
    _assert_state_equal(tstate, jstate)
    group = "train_state" if name == "train_state" else "jaxnerf"
    assert tstate.step == int(want[f"{group}/step"])
    for k, t in tstate.params.items():
        np.testing.assert_array_equal(t.detach().numpy(), want[f"{group}/params/{k}"])
    if name == "train_state":
        assert tstate.opt_state["count"] == 3
        for m in ("mu", "nu"):
            for k, t in tstate.opt_state[m].items():
                np.testing.assert_array_equal(t.numpy(), want[f"train_state/{m}/{k}"])
    else:
        assert tstate.opt_state["count"] == 0
