"""Write the JAX-package checkpoint fixtures in tests/torch_fixtures/jax_ckpt/.

Run from the repository root on a machine with the JAX stack (jax, flax,
orbax):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_jax_checkpoints.py

It writes, with the JAX package's own savers, a blender-config model cut to
MODEL_FLAGS (2 x 16, SH degree 3, both trunks):
  train_state/checkpoint_3/   save_checkpoint of a TrainState with seeded
                              params and non-zero Adam moments (orbax);
  jaxnerf_orbax/checkpoint_4321/, jaxnerf_msgpack/checkpoint_4321
                              an original JaxNeRF tree ({'optimizer':
                              {'target': {'params'}, 'state'}}) through
                              flax's save_checkpoint (orbax) and as msgpack;
  want.npz                    the arrays they hold ("<group>/<name>" in the
                              port's state_dict naming) and the steps.
tests/test_torch_checkpoints.py, tests/test_torch_gpu.py and chip_smoke.py
(phase 29) read them.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
from flax import serialization
from flax.training import checkpoints as flax_checkpoints
from jax import random

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from plenoctree_tpu.models import get_model_state  # noqa: E402
from plenoctree_tpu.utils import checkpoints as jckpt  # noqa: E402
from plenoctree_tpu.utils import config as jconfig  # noqa: E402
from plenoctree_tpu_torch.models.params import params_from_flax  # noqa: E402

OUT = os.path.join(ROOT, "tests", "torch_fixtures", "jax_ckpt")
MODEL_FLAGS = {"net_depth": 2, "net_width": 16}


def main():
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    cfg = jconfig.default_config(config=os.path.join(ROOT, "nerf_sh/config/blender"))
    jconfig.update_flags(cfg)
    for k, v in MODEL_FLAGS.items():
        setattr(cfg, k, v)
    _, state = get_model_state(random.PRNGKey(7), cfg, restore=False)
    rng = np.random.default_rng(7)

    def draw(tree, scale):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * scale), tree)

    params = jax.tree_util.tree_map(
        lambda a, n: a + n, state.variables["params"], draw(state.variables["params"], 0.1))
    adam = state.opt_state[0]
    adam = adam._replace(count=jnp.int32(3), mu=draw(adam.mu, 1e-3),
                         nu=jax.tree_util.tree_map(jnp.abs, draw(adam.nu, 1e-6)))
    state = state.replace(step=3, variables={"params": params},
                          opt_state=(adam,) + tuple(state.opt_state[1:]))
    jckpt.save_checkpoint(os.path.join(OUT, "train_state"), state, 3)

    ref_params = jax.tree_util.tree_map(np.asarray, draw(state.variables["params"], 0.2))
    raw = {"optimizer": {"target": {"params": ref_params},
                         "state": {"step": 4321, "param_states": jax.tree_util.tree_map(
                             lambda a: {"grad_ema": a * 0.5, "grad_sq_ema": a * a},
                             ref_params)}}}
    flax_checkpoints.save_checkpoint(os.path.join(OUT, "jaxnerf_orbax"), raw, 4321)
    os.makedirs(os.path.join(OUT, "jaxnerf_msgpack"))
    with open(os.path.join(OUT, "jaxnerf_msgpack", "checkpoint_4321"), "wb") as f:
        f.write(serialization.to_bytes(raw))

    want = {"train_state/step": 3, "train_state/count": 3, "jaxnerf/step": 4321}
    for group, tree in (("train_state/params", params), ("train_state/mu", adam.mu),
                        ("train_state/nu", adam.nu), ("jaxnerf/params", ref_params)):
        for k, t in params_from_flax(jax.tree_util.tree_map(np.asarray, tree)).items():
            want[f"{group}/{k}"] = t.numpy()
    np.savez(os.path.join(OUT, "want.npz"), **want)


if __name__ == "__main__":
    main()
