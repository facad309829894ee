"""JAX-side helpers of the port's parity tests.

- The JAX package's random draws, reproduced on the CPU: the port's
  samplers take the uniforms ``u`` in place of a generator; the draws do
  not depend on the mask, so feeding these makes both packages sample
  the same rows (``uniforms_from_jax``, ``detect_table_uniforms``,
  ``layered_uniforms``, ``hough_uniforms``, ``multi_plane_uniforms``).
- ``jit_call``: a reference function run as one jitted program, which
  compiles several times faster than the same function op by op.
- ``one_torch_thread``: a fixture a test module imports to run its torch
  CPU ops on one thread.
"""
import functools

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The importing module's torch CPU ops on one thread, the previous
    count restored after it.  The full suite runs six pytest-xdist
    workers on one machine; with torch's default pool of a thread per
    core in each, every small op waits on the oversubscribed cores (the
    compact engine's 5-slot chunk test took 1.4 s alone and 315 s
    there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def layered_uniforms(key, n_layers, num_hypotheses):
    """What ``layered_reconstruction`` draws for each fitted layer in
    turn: ``key, sub = split(key)``, ``kl, kc = split(sub)``, then the
    line fit's (H, 2) and the circle fit's (H, 3) uniforms.  A list of
    (line, circle) numpy pairs, one for each of ``n_layers`` layers."""
    out = []
    for _ in range(n_layers):
        key, sub = jax.random.split(key)
        kl, kc = jax.random.split(sub)
        out.append((np.asarray(jax.random.uniform(kl, (num_hypotheses, 2))),
                    np.asarray(jax.random.uniform(kc, (num_hypotheses, 3)))))
    return out


def hough_uniforms(key, n_rounds, num_hypotheses, significant_plane=False):
    """What ``hough_segment`` draws, in order: with ``significant_plane``
    first ``key, sub = split(key)`` and the plane fit's (max(H, 128), 3)
    uniforms from ``sub``, then for each round the chain of
    ``layered_uniforms`` (a (line, circle) pair).  ``segment_by_voting``
    draws the rounds' chain once for each cluster that votes."""
    out = []
    if significant_plane:
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.uniform(sub, (max(num_hypotheses, 128), 3))))
    return out + [tuple(np.array(a) for a in pair) for pair in layered_uniforms(key, n_rounds, num_hypotheses)]


def multi_plane_uniforms(key, max_planes, num_hypotheses):
    """What ``realtime.segmentation.multi_plane_ransac`` draws: the round
    that has accepted ``count`` planes samples with
    ``uniform(fold_in(key, count), (num_hypotheses,))``.  Row ``count`` of
    the (max_planes, num_hypotheses) numpy result is that draw."""
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, c), (num_hypotheses,)))
                     for c in range(max_planes)])
