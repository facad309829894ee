"""Port parity: ops/filters.py against the JAX package on the same numpy
inputs (tests/test_icp.py's bumpy surface with scattered outliers, dead
rows included).

The statistical filter ranks neighbours over matmul-form distances in
the JAX package and over direct differences in the port (its k-best
search over the live rows), which round differently; on these clouds no
point's mean distance lies near the gate, and its keep-masks must be
identical.
Every other mask must be identical too: the same f32 comparisons, with
angle thresholds taken in f32 on both sides (a normal placed exactly on
the f32 cosine of the gate is kept by both; at 15°, the table detector's
gate, ``math.cos`` would drop it)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import jit_call
from test_icp import _bumpy_surface

from mapping_private_tpu.core.cloud import PointCloud as JCloud
from mapping_private_tpu.ops import filters as jf
from mapping_private_tpu_torch.core.cloud import PointCloud as TCloud
from mapping_private_tpu_torch.ops import filters as tf


def _clouds(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([_bumpy_surface(seed=seed, n=n),
                          rng.uniform(-1.5, 1.5, (60, 3)).astype(np.float32)])
    label = rng.integers(0, 4, len(xyz)).astype(np.float32)
    jc = JCloud.from_numpy(xyz, {"label": label})
    jc = jc.select(jnp.arange(jc.capacity) % 11 != 5)
    tc = TCloud.from_arrays(np.asarray(jc.xyz), np.asarray(jc.mask),
                            {"label": np.asarray(jc.channel("label"))}, device="cpu")
    return jc, tc


@pytest.mark.parametrize("use_grid", [False, True])
def test_statistical_outlier_mask_matches(use_grid):
    jc, tc = _clouds()
    kw = dict(k=12, alpha=1.0, use_grid=use_grid, cell_size=0.2)
    want = np.asarray(jit_call(jf.statistical_outlier_mask, jc.padded_xyz(), jc.mask, **kw))
    got = tf.statistical_outlier_mask(tc.padded_xyz(), tc.mask, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    live = np.asarray(jc.mask)
    assert 0.8 * live.sum() < want.sum() < live.sum()  # the filter removes some, not most


def test_remove_statistical_outliers_validity_flag():
    jc, tc = _clouds(n=800, seed=1)
    for min_nr in (0, 700, 5000):
        jout, jvalid = jit_call(jf.remove_statistical_outliers, jc, k=10, alpha=2.0, min_nr_pts=min_nr)
        tout, tvalid = tf.remove_statistical_outliers(tc, k=10, alpha=2.0, min_nr_pts=min_nr)
        np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
        assert bool(tvalid) == bool(jvalid) == (min_nr <= int(jout.count()))
        assert int(tout.count()) == int(jout.count())


def test_box_and_band_and_depth_masks_match():
    jc, tc = _clouds(seed=2)
    xj, xt, mj, mt = jc.xyz, tc.xyz, jc.mask, tc.mask
    lo, hi = [-0.5, -0.2, -0.1], [0.6, 0.9, 0.2]
    np.testing.assert_array_equal(tf.box_filter(tc, lo, hi).mask.numpy(),
                                  np.asarray(jf.box_filter(jc, lo, hi).mask))
    np.testing.assert_array_equal(tf.z_band_mask(xt, mt, -0.05, 0.1).numpy(),
                                  np.asarray(jf.z_band_mask(xj, mj, -0.05, 0.1)))
    for relative in (False, True):
        np.testing.assert_array_equal(tf.depth_limit_mask(xt, mt, 0.15, relative).numpy(),
                                      np.asarray(jf.depth_limit_mask(xj, mj, 0.15, relative)))
    for value, atol in ((2.0, 0.0), (1.0, 1.5)):
        np.testing.assert_array_equal(tf.channel_equal_mask(tc, "label", value, atol).numpy(),
                                      np.asarray(jf.channel_equal_mask(jc, "label", value, atol)))


def _normals_at_gate(eps):
    """Unit normals at angles around ``eps`` from +z and −z, among them one
    whose z is exactly float32(cos eps) and one at float32(sin eps)."""
    rng = np.random.default_rng(3)
    ang = np.concatenate([eps + rng.normal(0, 1e-3, 400), np.pi / 2 - eps + rng.normal(0, 1e-3, 400),
                          rng.uniform(0, np.pi, 200)])
    az = rng.uniform(0, 2 * np.pi, len(ang))
    n = np.column_stack([np.sin(ang) * np.cos(az), np.sin(ang) * np.sin(az), np.cos(ang)])
    n[::2] *= -1
    n = n.astype(np.float32)
    n[0] = [0.0, 0.0, float(np.float32(np.cos(np.float32(eps))))]
    n[1] = [0.0, 0.0, float(np.float32(np.sin(np.float32(eps))))]
    return n


@pytest.mark.parametrize("eps", [15.0 * math.pi / 180.0, 0.1])
def test_normal_axis_gates_match(eps):
    n = _normals_at_gate(eps)
    mask = np.ones(len(n), bool)
    mask[5::9] = False
    axis = np.array([0.0, 0.0, 2.0], np.float32)
    jn, jm, ja = jnp.asarray(n), jnp.asarray(mask), jnp.asarray(axis)
    tn, tm, ta = torch.from_numpy(n), torch.from_numpy(mask), torch.from_numpy(axis)
    par = tf.axis_parallel_normal_mask(tn, tm, ta, eps).numpy()
    np.testing.assert_array_equal(par, np.asarray(jf.axis_parallel_normal_mask(jn, jm, ja, eps)))
    perp = tf.axis_perpendicular_normal_mask(tn, tm, ta, eps).numpy()
    np.testing.assert_array_equal(perp, np.asarray(jf.axis_perpendicular_normal_mask(jn, jm, ja, eps)))
    assert par[0] and perp[1]  # on the f32 gate: kept by both packages
    assert 100 < par.sum() < 400 and 100 < perp.sum() < 400  # about half of each band of 400
