"""Port parity: ops/neighbors.py and ops/normals.py against the JAX
package on tests/test_icp.py's bumpy-surface data.

Both sides rank neighbours over the same matmul-form distances, but
``jax.lax.top_k`` and ``torch.topk`` order an exact tie at the k-th
neighbour differently, and the two matmuls round differently at a radius
boundary.  Either swaps one neighbour of a point, which moves its normal
by far more than rounding does.  So the neighbour sets are compared first
(at least 99.5% of live points must agree), and on the points whose sets
agree normals must match within 1e-4 and curvature within 1e-5.  A point
with fewer than 3 neighbours has no defined normal (any direction across
its one segment fits) and is left out of the value check too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import jit_call
from test_icp import _bumpy_surface

from mapping_private_tpu.core.cloud import PointCloud as JCloud
from mapping_private_tpu.ops import neighbors as jnb
from mapping_private_tpu.ops import normals as jnorm
from mapping_private_tpu_torch.core.cloud import PointCloud as TCloud
from mapping_private_tpu_torch.ops import neighbors as tnb
from mapping_private_tpu_torch.ops import normals as tnorm

VIEW = np.array([0.0, 0.0, 10.0], np.float32)


def _clouds(n=2000, seed=0, dead_every=0):
    jc = JCloud.from_numpy(_bumpy_surface(seed=seed, n=n))
    if dead_every:
        jc = jc.select(jnp.arange(jc.capacity) % dead_every != 0)
    tc = TCloud.from_arrays(np.asarray(jc.xyz), np.asarray(jc.mask), device="cpu")
    return jc, tc


def _same_neighbourhood(jc, tc, k, radius=None):
    """Live points with ≥ 3 neighbours whose valid neighbour sets agree on
    both sides."""
    xj, xt = jc.padded_xyz(), tc.padded_xyz()
    excl = radius is None
    ij, sj = (np.asarray(a) for a in jnb.knn_bruteforce(xj, xj, jc.mask, k, excl))
    it, st = (a.numpy() for a in tnb.knn_bruteforce(xt, xt, tc.mask, k, excl))
    if radius is not None:
        ij = np.where(sj <= radius * radius, ij, -1)
        it = np.where(st <= radius * radius, it, -1)
    live = np.asarray(jc.mask)
    same = np.array([set(a) == set(b) for a, b in zip(ij, it)]) & live
    assert same.sum() >= 0.995 * live.sum()
    return same & ((ij >= 0).sum(1) >= 3)


def _check_normals(jc, tc, live):
    nj, nt = np.asarray(jc.channel("normal")), tc.channel("normal").numpy()
    cj, ct = np.asarray(jc.channel("curvature")), tc.channel("curvature").numpy()
    np.testing.assert_allclose(nt[live], nj[live], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ct[live], cj[live], rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(nt[live], axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("dead_every", [0, 9])
def test_estimate_normals_k12_matches(dead_every):
    jc, tc = _clouds(dead_every=dead_every)
    jc = jnorm.estimate_normals(jc, k=12, viewpoint=jnp.asarray(VIEW))
    tc = tnorm.estimate_normals(tc, k=12, viewpoint=torch.from_numpy(VIEW))
    _check_normals(jc, tc, _same_neighbourhood(jc, tc, 12))


def test_estimate_normals_default_viewpoint_matches():
    jc, tc = _clouds(n=700, seed=2)
    _check_normals(jnorm.estimate_normals(jc, k=12), tnorm.estimate_normals(tc, k=12),
                   _same_neighbourhood(jc, tc, 12))


def test_estimate_normals_radius_matches():
    jc, tc = _clouds(n=1500, seed=1)
    jc = jnorm.estimate_normals_radius(jc, radius=0.12, k_cap=48, viewpoint=jnp.asarray(VIEW))
    tc = tnorm.estimate_normals_radius(tc, radius=0.12, k_cap=48, viewpoint=torch.from_numpy(VIEW))
    _check_normals(jc, tc, _same_neighbourhood(jc, tc, 48, radius=0.12))


def test_smallest_eigenpair_matches():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1)
    ev_j, vec_j = (np.asarray(a) for a in jnorm.smallest_eigenvector_3x3(jnp.asarray(A)))
    ev_t, vec_t = (a.numpy() for a in tnorm.smallest_eigenvector_3x3(torch.from_numpy(A)))
    np.testing.assert_allclose(ev_t, ev_j, rtol=1e-4, atol=1e-4)
    # eigenvectors up to sign
    dots = np.abs(np.sum(vec_t * vec_j, axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)


@pytest.mark.parametrize("k,exclude_self", [(1, False), (12, True)])
def test_knn_bruteforce_matches(k, exclude_self, monkeypatch):
    jc, tc = _clouds(n=900, seed=5, dead_every=4)
    # several query blocks on the port side
    monkeypatch.setattr(tnb, "_CHUNK_ELEMS", tc.capacity * 100)
    xj, xt = jc.padded_xyz(), tc.padded_xyz()
    idx_j, sq_j = (np.asarray(a) for a in jnb.knn_bruteforce(xj, xj, jc.mask, k, exclude_self))
    idx_t, sq_t = (a.numpy() for a in tnb.knn_bruteforce(xt, xt, tc.mask, k, exclude_self))
    live = np.asarray(jc.mask)
    assert idx_t.dtype == np.int32
    np.testing.assert_allclose(sq_t[live], sq_j[live], rtol=1e-5, atol=1e-6)
    same = [set(a) == set(b) for a, b in zip(idx_t[live], idx_j[live])]
    assert np.mean(same) > 0.99
    assert (idx_t[~live] >= -1).all()


def test_pairwise_sq_dists_matches():
    rng = np.random.default_rng(6)
    a = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    b = rng.uniform(-2, 2, (70, 3)).astype(np.float32)
    want = np.asarray(jnb.pairwise_sq_dists(jnp.asarray(a), jnp.asarray(b)))
    got = tnb.pairwise_sq_dists(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("jitter", [1e-6, 1e-5])
def test_direct_knn_ranks_near_ties_as_float64_does(jitter):
    """``direct``: a 3 cm grid of voxel centroids on a table 0.8 m out,
    jittered so that neighbours of one ring lie within ~1e-4 of each
    other in d².  Direct differences give every row whose k-th and
    (k+1)-th float64 distances part by more than 1e-6 the float64
    neighbour set, and d² by the float32 formula exactly; the matmul form
    swaps neighbours on some of those rows."""
    rng = np.random.default_rng(0)
    grid = np.stack(np.meshgrid(np.arange(30), np.arange(20), [0]), -1).reshape(-1, 3) * 0.03
    p = (grid + np.array([0.2, -0.3, 0.75]) + rng.normal(0, jitter, grid.shape)).astype(np.float32)
    p64 = p.astype(np.float64)
    d64 = ((p64[:, None] - p64[None]) ** 2).sum(-1)
    np.fill_diagonal(d64, np.inf)
    k = 10
    want = [set(r[:k]) for r in np.argsort(d64, 1, kind="stable")]
    srt = np.sort(d64, 1)
    clear = (srt[:, k] - srt[:, k - 1]) / srt[:, k - 1] > 1e-6
    x, live = torch.from_numpy(p), torch.ones(len(p), dtype=torch.bool)
    idx, sq = tnb.knn_bruteforce(x, x, live, k, exclude_self=True, direct=True)
    same = np.array([set(a) == b for a, b in zip(idx.numpy(), want)])
    assert clear.sum() > 0.95 * len(p) and same[clear].all()
    d = p[:, None, :] - p[idx.numpy().astype(np.int64)]
    np.testing.assert_array_equal(sq.numpy(), (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2])
    idx_mm, _ = tnb.knn_bruteforce(x, x, live, k, exclude_self=True)
    assert not all(set(a) == b for a, b in zip(idx_mm.numpy()[clear], np.asarray(want, object)[clear]))


def test_estimate_normals_grid_matches():
    """The grid-hash path (``use_grid``): the same stencil candidates on
    both sides, ranked by direct differences, so the neighbour sets agree
    but for near ties; normals compared as for brute force."""
    jc, tc = _clouds(n=700, seed=3, dead_every=7)
    kw = dict(k=12, use_grid=True, cell_size=0.25)
    jn = jit_call(jnorm.estimate_normals, jc, viewpoint=jnp.asarray(VIEW), **kw)
    tn = tnorm.estimate_normals(tc, viewpoint=torch.from_numpy(VIEW), **kw)
    xj, xt = jc.padded_xyz(), tc.padded_xyz()
    self_j = jnp.arange(jc.capacity, dtype=jnp.int32)
    ij = np.asarray(jit_call(lambda x, m: jnb.knn_grid(jnb.build_grid_hash(x, m, 0.25), x, k=12,
                                                       self_idx=self_j)[0], xj, jc.mask))
    it = tnb.knn_grid(tnb.build_grid_hash(xt, tc.mask, 0.25), xt, k=12,
                      self_idx=torch.arange(tc.capacity, dtype=torch.int32))[0].numpy()
    live = np.asarray(jc.mask)
    same = np.array([set(a) == set(b) for a, b in zip(ij, it)]) & live
    assert same.sum() >= 0.995 * live.sum()
    _check_normals(jn, tn, same & ((ij >= 0).sum(1) >= 3))
