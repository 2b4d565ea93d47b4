"""Learning-rate schedule: log-linear decay with an optional delayed start.

Port of plenoctree_tpu/utils/lr.py, evaluated on the host per step (a
Python float; the JAX package evaluates it inside its jitted step).
"""

import functools
import math

import numpy as np


def learning_rate_decay(step, lr_init, lr_final, max_steps, lr_delay_steps=0,
                        lr_delay_mult=1.0):
    """lr at `step` (float32 arithmetic, like the JAX package's jnp version)."""
    f32 = np.float32
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * math.pi) * np.clip(f32(step) / f32(lr_delay_steps), 0, 1)
        )
    else:
        delay_rate = f32(1.0)
    t = np.clip(f32(step) / f32(max_steps), 0, 1)
    log_lerp = np.exp(f32(np.log(lr_init)) * (1 - t) + f32(np.log(lr_final)) * t)
    return float(f32(delay_rate * log_lerp))


def schedule_from_config(cfg):
    """A `step -> lr` schedule from a config namespace."""
    return functools.partial(
        learning_rate_decay,
        lr_init=cfg.lr_init,
        lr_final=cfg.lr_final,
        max_steps=cfg.max_steps,
        lr_delay_steps=cfg.lr_delay_steps,
        lr_delay_mult=cfg.lr_delay_mult,
    )
