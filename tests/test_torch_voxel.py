"""Port parity: ops/voxel.py against the JAX package on the same numpy
clouds (dead rows, negative cells, a 1-D and a 2-D channel).

Rows, masks and ``vox_count`` must be identical: both sides sort by the
same int32 keys (stably) and count.  Centroids within 1e-6 absolute and
channel means within 1e-6 relative (1e-4 absolute near 0): the JAX
package sums each voxel's rows in float32, the port in float64 (atomics
in any order on the card), rounding each mean to float32 once, so its
centroid is the nearest float32 to the exact mean."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import jit_call

from mapping_private_tpu.core.cloud import PointCloud as JCloud
from mapping_private_tpu.ops import voxel as jvox
from mapping_private_tpu_torch.core.cloud import PointCloud as TCloud
from mapping_private_tpu_torch.ops import voxel as tvox

TOL = dict(rtol=0, atol=1e-6)


def _clouds(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.6, 0.9, (n, 3)).astype(np.float32)
    chans = {"intensity": rng.uniform(0, 1, n).astype(np.float32),
             "rgb": rng.uniform(0, 255, (n, 3)).astype(np.float32)}
    jc = JCloud.from_numpy(xyz, chans, capacity=n + 72)
    jc = jc.select(jnp.arange(jc.capacity) % 7 != 3)
    tc = TCloud.from_arrays(np.asarray(jc.xyz), np.asarray(jc.mask),
                            {k: np.asarray(v) for k, v in jc.channels.items()}, device="cpu")
    return jc, tc


def _check(jout, tout):
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
    np.testing.assert_allclose(tout.xyz.numpy(), np.asarray(jout.xyz), **TOL)
    assert tout.channels.keys() == jout.channels.keys()
    for k in jout.channels:
        want, got = np.asarray(jout.channel(k)), tout.channel(k).numpy()
        assert got.shape == want.shape, k
        if k == "vox_count":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("voxel, cap", [(0.1, 4096), (0.1, 300), (0.37, 64)])
def test_voxel_downsample_matches(voxel, cap):
    """Ample capacity, and capacities that spill (the voxels past ``cap``
    in key order are dropped)."""
    jc, tc = _clouds()
    jout = jit_call(jvox.voxel_downsample, jc, voxel_size=voxel, out_capacity=cap)
    tout = tvox.voxel_downsample(tc, voxel, cap)
    _check(jout, tout)
    n_occ = int(np.asarray(jout.mask).sum())
    assert n_occ == min(cap, n_occ) and (cap > 1000) == (n_occ < cap)


@pytest.mark.parametrize("seed", [0, 1])
def test_voxel_centroids_are_the_nearest_float32_of_the_exact_mean(seed):
    _, tc = _clouds(seed=seed)
    out = tvox.voxel_downsample(tc, 0.1, 4096)
    xyz, live = tc.xyz.numpy(), tc.mask.numpy()
    keys = np.floor(xyz[live] / np.float32(0.1)).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    sums = np.zeros((inv.max() + 1, 3))
    np.add.at(sums, inv.ravel(), xyz[live].astype(np.float64))
    want = (sums / np.bincount(inv.ravel())[:, None]).astype(np.float32)
    got = out.xyz.numpy()[out.mask.numpy()]
    order = lambda a: a[np.lexsort(a.T)]  # noqa: E731  (rows in the same order on both sides)
    np.testing.assert_array_equal(order(got), order(want))


@pytest.mark.parametrize("cap", [2048, 100])
def test_voxel_downsample_dense_matches(cap):
    """A bounded grid that cuts off part of the cloud (points outside it
    are dropped) at an ample and a spilling capacity."""
    jc, tc = _clouds(seed=1)
    kw = dict(voxel_size=0.1, origin=(-0.5, -0.6, -0.4), dims=(12, 14, 10), out_capacity=cap)
    _check(jit_call(jvox.voxel_downsample_dense, jc, **kw), tvox.voxel_downsample_dense(tc, **kw))


def test_voxel_downsample_all_dead():
    jc, tc = _clouds(n=200)
    jc, tc = jc.select(jnp.zeros(jc.capacity, bool)), tc.select(torch.zeros(tc.capacity, dtype=torch.bool))
    jout, tout = jvox.voxel_downsample(jc, 0.1, 128), tvox.voxel_downsample(tc, 0.1, 128)
    _check(jout, tout)
    assert not tout.mask.any()
