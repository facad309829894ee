"""Port parity: the grid hash of ops/neighbors.py against the JAX package.

Same numpy inputs through both.  The hash build is integer work and a
stable sort: keys, order and gathered positions must be identical.  The
searches sum the same direct differences in f32: indices identical and
squared distances within 1e-6 on rows where the winner is not tied
(ties between equal distances may resolve differently in ``top_k``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapping_private_tpu.ops import neighbors as jn
from mapping_private_tpu_torch.ops import neighbors as tn


def _cloud(n, seed, lo=-1.5, hi=1.5):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(lo, hi, (n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def _grids(xyz, mask, cell):
    gj = jn.build_grid_hash(jnp.asarray(xyz), jnp.asarray(mask), cell)
    gt = tn.build_grid_hash(torch.from_numpy(xyz), torch.from_numpy(mask), cell)
    return gj, gt


def test_cell_key_matches_for_negative_cells():
    rng = np.random.default_rng(0)
    cell = rng.integers(-3000, 3000, (500, 3)).astype(np.int32)
    want = np.asarray(jn._cell_key(jnp.asarray(cell)))
    got = tn._cell_key(torch.from_numpy(cell))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(tn._KEY_SENTINEL) == int(jn._KEY_SENTINEL) > want.max()


@pytest.mark.parametrize("cell", [0.25, 0.1])
def test_build_matches(cell):
    xyz = _cloud(2000, 1)  # negative coordinates: negative cells
    mask = np.ones(2000, bool)
    mask[::9] = False
    gj, gt = _grids(xyz, mask, cell)
    np.testing.assert_array_equal(gt.sorted_keys.numpy(), np.asarray(gj.sorted_keys))
    np.testing.assert_array_equal(gt.sorted_idx.numpy(), np.asarray(gj.sorted_idx))
    np.testing.assert_array_equal(gt.sorted_xyz.numpy(), np.asarray(gj.sorted_xyz))
    assert gt.sorted_keys.dtype == gt.sorted_idx.dtype == torch.int32


def test_nn_grid_1nn_matches():
    xyz = _cloud(3000, 2)
    mask = np.ones(3000, bool)
    mask[::11] = False
    q = (_cloud(1000, 3) + np.float32(0.01)).astype(np.float32)
    q[:5] += 50.0  # far away: no candidate in the stencil
    gj, gt = _grids(xyz, mask, 0.25)
    ij, sj = (np.asarray(a) for a in jn.nn_grid_1nn(gj, jnp.asarray(q), cap_per_cell=32))
    it, st = (a.numpy() for a in tn.nn_grid_1nn(gt, torch.from_numpy(q), cap_per_cell=32))
    assert it.dtype == np.int32
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    assert (it[:5] == -1).all() and np.isinf(st[:5]).all()
    # and it is the true NN among the live points (cell ≥ the NN distance)
    d2 = ((q[5:, None, :] - xyz[None, mask, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(it[5:], np.flatnonzero(mask)[d2.argmin(1)])


def test_knn_grid_matches():
    xyz = _cloud(2000, 4)
    mask = np.ones(2000, bool)
    mask[::13] = False
    gj, gt = _grids(xyz, mask, 0.3)
    self_idx = np.arange(2000, dtype=np.int32)
    ij, sj = (np.asarray(a) for a in jn.knn_grid(
        gj, jnp.asarray(xyz), 8, cap_per_cell=32, self_idx=jnp.asarray(self_idx)))
    it, st = (a.numpy() for a in tn.knn_grid(
        gt, torch.from_numpy(xyz), 8, cap_per_cell=32, self_idx=torch.from_numpy(self_idx)))
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    assert (it != self_idx[:, None]).all()
    # indices wherever a slot's distance differs from its neighbours'
    untied = np.ones_like(it, bool)
    untied[:, 1:] &= st[:, 1:] != st[:, :-1]
    untied[:, :-1] &= st[:, 1:] != st[:, :-1]
    assert untied.mean() > 0.99
    np.testing.assert_array_equal(it[untied], ij[untied])
    np.testing.assert_array_equal(it == -1, np.isinf(st))


def test_radius_count_grid_matches():
    xyz = _cloud(2000, 5)
    mask = np.ones(2000, bool)
    mask[::7] = False
    gj, gt = _grids(xyz, mask, 0.2)
    q = _cloud(700, 6)
    want = np.asarray(jn.radius_count_grid(gj, jnp.asarray(q), 0.15, cap_per_cell=32))
    got = tn.radius_count_grid(gt, torch.from_numpy(q), 0.15, cap_per_cell=32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    d2 = ((q[:, None, :].astype(np.float64) - xyz[None, mask, :]) ** 2).sum(-1)
    assert np.abs(got.numpy() - (d2 <= 0.15 ** 2).sum(1)).max() <= 1  # boundary rounding
