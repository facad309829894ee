"""JAX-side helpers of the port's parity tests.

- The JAX package's random draws, reproduced on the CPU: the port's
  samplers take the uniforms ``u`` in place of a generator; the draws do
  not depend on the mask, so feeding these makes both packages sample
  the same rows.
- ``jit_call``: a reference function run as one jitted program, which
  compiles several times faster than the same function op by op.
"""
import functools

import jax
import numpy as np


def jit_call(fn, *args, **static):
    """``fn(*args, **static)`` compiled as one program, with ``static`` the
    keyword arguments that are Python values (sizes, flags, thresholds)."""
    return jax.jit(functools.partial(fn, **static))(*args)


def uniforms_from_jax(key, shapes):
    """The chain ``key, sub = jax.random.split(key)`` then
    ``jax.random.uniform(sub, shape)`` for each shape in turn (one object
    after another in ``TableMemory.update``).  A list of numpy arrays."""
    out = []
    for shape in shapes:
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, shape)))
    return out


def detect_table_uniforms(key, config):
    """What ``detect_table`` draws: ``jax.random.split(key, C)`` and one
    ``(sac_hypotheses, 3)`` block per candidate; (C, H, 3) numpy."""
    keys = jax.random.split(key, config.max_table_candidates)
    return np.stack([np.asarray(jax.random.uniform(k, (config.sac_hypotheses, 3))) for k in keys])
