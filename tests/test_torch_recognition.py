"""Port parity: recognition/pca.py and recognition/search.py against the
JAX package.

- PCA: variances within 1e-5 relative; eigenvectors only up to sign and
  within degenerate eigenspaces, so the subspaces are compared by their
  projectors W Wᵀ (within 1e-4).  A file written by either package from
  the same ``PCAResult`` is byte for byte the other's, and each package
  reads the other's files.
- Search: the summed-area tables and box sums within ~eps × the table's
  total (the cumsum orders differ); the planted-object scenes of the JAX
  package's tests give the same ranked boxes and modes, scores within
  1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import jit_call, one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.core.voxelgrid import VoxelGrid as JGrid
from mapping_private_tpu.features import colorchlac as jcc
from mapping_private_tpu.recognition import pca as jpca
from mapping_private_tpu.recognition import search as jsearch
from mapping_private_tpu_torch.core import VoxelGrid
from mapping_private_tpu_torch.features import colorchlac as tcc
from mapping_private_tpu_torch.recognition import pca as tpca
from mapping_private_tpu_torch.recognition import search as tsearch


def _features(seed, n=400, d=8):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(d, d))
    return (rng.normal(size=(n, d)) @ np.diag(np.geomspace(5, 0.05, d)) @ A + 0.3).astype(np.float32)


def _projector(axis, k):
    W = np.asarray(axis, np.float64)[:, :k]
    return W @ W.T


@pytest.mark.parametrize("mean_flg,reg,masked", [(False, 0.0, False), (True, 0.0, True), (True, 0.1, False)])
def test_pca_fit_matches(mean_flg, reg, masked):
    f = _features(0)
    mask = (np.arange(len(f)) % 5 != 0) if masked else None
    jr = jpca.pca_fit(jnp.asarray(f), None if mask is None else jnp.asarray(mask), mean_flg, reg)
    tr = tpca.pca_fit(torch.tensor(f), None if mask is None else torch.tensor(mask), mean_flg, reg)
    assert isinstance(tr.axis, np.ndarray) and tr.axis.shape == (8, 8) and tr.variance.dtype == np.float32
    assert (np.diff(tr.variance) <= 0).all()
    np.testing.assert_allclose(tr.variance, jr.variance, rtol=1e-5, atol=1e-6 * jr.variance[0])
    for k in (1, 3, 5, 8):
        np.testing.assert_allclose(_projector(tr.axis, k), _projector(jr.axis, k), atol=1e-4)
    cos = np.abs(np.sum(tr.axis * jr.axis, axis=0))
    np.testing.assert_allclose(cos, 1.0, atol=1e-4)
    if mean_flg:
        np.testing.assert_allclose(tr.mean, jr.mean, rtol=1e-6, atol=1e-6)
    else:
        assert tr.mean is None


def test_degenerate_eigenspace_compares_by_projector():
    """Two equal eigenvalues: any basis of their plane is right, the
    projector onto it is the same."""
    f = np.zeros((4, 3), np.float32)
    f[0, 0] = f[1, 1] = 2.0
    f[2, 2] = 1.0
    jr, tr = jpca.pca_fit(jnp.asarray(f)), tpca.pca_fit(torch.tensor(f))
    np.testing.assert_allclose(tr.variance, [1.0, 1.0, 0.25], atol=1e-6)
    np.testing.assert_allclose(_projector(tr.axis, 2), _projector(jr.axis, 2), atol=1e-6)


@pytest.mark.parametrize("with_mean", [False, True])
def test_pca_files_byte_for_byte_and_cross_read(tmp_path, with_mean):
    jr = jpca.pca_fit(jnp.asarray(_features(1)), mean_flg=with_mean)
    tr = tpca.PCAResult(**dataclasses.asdict(jr))  # the model carried across
    for ascii_fmt in (False, True):
        pj, pt = tmp_path / f"j{ascii_fmt}.pca", tmp_path / f"t{ascii_fmt}.pca"
        jpca.write_pca(str(pj), jr, ascii_fmt=ascii_fmt)
        tpca.write_pca(str(pt), tr, ascii_fmt=ascii_fmt)
        assert pj.read_bytes() == pt.read_bytes()
        a, b = tpca.read_pca(str(pj), ascii_fmt=ascii_fmt), jpca.read_pca(str(pt), ascii_fmt=ascii_fmt)
        for field in ("axis", "variance", "mean"):
            x, y = getattr(a, field), getattr(b, field)
            if with_mean or field != "mean":
                np.testing.assert_array_equal(x, y)
            else:
                assert x is None and y is None
    for ms in (False, True):
        np.testing.assert_array_equal(tpca.subspace_axis(tr, 3, ms), jpca.subspace_axis(jr, 3, ms))
    for kw in ({}, {"dim": 5}, {"dim": 6, "contrib_dim": 2}, {"contrib_rate": 0.9}, {"dim": 4, "contrib_rate": 1.5}):
        np.testing.assert_array_equal(tpca.variance_report(tr, **kw), jpca.variance_report(jr, **kw))


def test_scene_tables_and_box_sums_match():
    rng = np.random.default_rng(3)
    feat = rng.uniform(0, 50, (7, 6, 5, 4)).astype(np.float32)
    exist = rng.integers(0, 30, (7, 6, 5)).astype(np.float32)
    axis = rng.normal(size=(3, 4)).astype(np.float32)
    mean = rng.normal(size=4).astype(np.float32)
    for kw in ({}, {"scene_axis": axis}, {"scene_axis": axis, "scene_mean": mean}):
        js = jsearch.build_scene_data(jnp.asarray(feat), jnp.asarray(exist),
                                      **{k: jnp.asarray(v) for k, v in kw.items()})
        ts = tsearch.build_scene_data(torch.tensor(feat), torch.tensor(exist), **kw)
        assert ts.dims == js.dims == (7, 6, 5)
        tol = 4 * np.finfo(np.float32).eps * np.abs(np.asarray(js.int_feat)).max()
        np.testing.assert_allclose(ts.int_feat.numpy(), np.asarray(js.int_feat), rtol=0, atol=tol)
        np.testing.assert_array_equal(ts.int_exist.numpy(), np.asarray(js.int_exist))
    ts = tsearch.build_scene_data(torch.tensor(feat), torch.tensor(exist))
    for r in [(1, 1, 1), (2, 3, 1), (3, 2, 4), (7, 6, 5)]:
        got = tsearch._box_sums(ts.int_feat, *r).numpy()
        want = np.asarray(jsearch._box_sums(jnp.asarray(ts.int_feat.numpy()), *r))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        x, y, z = (s - d for s, d in zip((7, 6, 5), r))
        # the corner differences cancel: within a few eps of the table's total
        np.testing.assert_allclose(got[x, y, z], feat[x:, y:, z:].sum((0, 1, 2)), rtol=0,
                                   atol=8 * np.finfo(np.float32).eps * float(ts.int_feat.abs().max()))
    for r in [(2, 2, 2), (1, 1, 2), (2, 1, 1), (1, 2, 1), (1, 2, 3)]:
        assert tsearch.active_modes(*r) == jsearch.active_modes(*r)
    assert tsearch._MODE_PERMS == jsearch._MODE_PERMS


def _random_object(rng, shape, color):
    count = np.ones(shape, np.int64)
    return (count,) + tuple(np.clip(rng.normal(c, 20, shape), 0, 255).round() * count for c in color)


def _grids(count, r, g, b):
    jg = JGrid(origin=jnp.zeros(3), voxel_size=jnp.float32(0.01), count=jnp.asarray(count, jnp.int32),
               sums={"r": jnp.asarray(r, jnp.float32), "g": jnp.asarray(g, jnp.float32),
                     "b": jnp.asarray(b, jnp.float32)})
    tg = VoxelGrid(origin=torch.zeros(3), voxel_size=torch.tensor(0.01), count=torch.tensor(count, dtype=torch.int32),
                   sums={k: torch.tensor(np.asarray(v, np.float32)) for k, v in zip("rgb", (r, g, b))})
    return jg, tg


def _planted(seed, scene_shape, place, obj_shape, color, clutter=0.97):
    rng = np.random.default_rng(seed)
    count = (rng.random(scene_shape) > clutter).astype(np.int64)
    r, g, b = (128.0 * count for _ in range(3))
    sl = tuple(slice(o, o + s) for o, s in zip(place, obj_shape))
    oc, orr, og, ob = _random_object(rng, obj_shape, color)
    count[sl], r[sl], g[sl], b[sl] = oc, orr, og, ob
    return _grids(count, r, g, b)


def _object_subspace(seed0, n, shape, color, dim):
    feats = [np.asarray(tcc.colorchlac117(_grids(*_random_object(np.random.default_rng(seed0 + i), shape, color))[1]))
             for i in range(n)]
    jr = jpca.pca_fit(jnp.asarray(np.stack(feats)))
    return jpca.subspace_axis(jr, dim)


@pytest.mark.parametrize("case", ["planted", "rotated"])
def test_search_object_matches(case):
    if case == "planted":
        jg, tg = _planted(5, (24, 20, 16), (12, 8, 4), (6, 4, 4), (220, 30, 30))
        aq, ranges, rank, thr, bs = _object_subspace(100, 20, (6, 4, 4), (220, 30, 30), 5), (3, 2, 2), 3, 8.0, 2
    else:
        jg, tg = _planted(6, (20, 20, 12), (4, 6, 2), (2, 6, 4), (30, 200, 60), clutter=1.0)
        aq, ranges, rank, thr, bs = _object_subspace(200, 16, (6, 2, 4), (30, 200, 60), 4), (3, 1, 2), 2, 4.0, 2
    js = jsearch.build_scene_data(jit_call(jcc.colorchlac117_subdiv, jg, block_size=bs), jcc.occupied_count_subdiv(jg, bs))
    ts = tsearch.build_scene_data(tcc.colorchlac117_subdiv(tg, bs), tcc.occupied_count_subdiv(tg, bs))
    for rot in (True, False):
        jd = jsearch.search_object(js, jnp.asarray(aq), ranges, rank_num=rank, exist_threshold=thr, with_rotation=rot)
        td = tsearch.search_object(ts, aq, ranges, rank_num=rank, exist_threshold=thr, with_rotation=rot)
        assert len(td) == len(jd) > 0
        for a, b in zip(td, jd):
            assert (a.x, a.y, a.z, a.xrange, a.yrange, a.zrange, a.mode) == (b.x, b.y, b.z, b.xrange, b.yrange,
                                                                             b.zrange, b.mode)
            assert abs(a.score - b.score) < 1e-5
    best = td[0] if case == "planted" else tsearch.search_object(ts, aq, ranges, rank_num=rank, exist_threshold=thr)[0]
    if case == "planted":
        assert (best.x, best.y, best.z) == (6, 4, 2) and best.score > 0.9
    else:
        assert (best.xrange, best.yrange, best.zrange) == (1, 3, 2) and (best.x, best.y, best.z) == (2, 3, 1)
    multi = tsearch.search_objects_multi(ts, [aq, aq], [ranges, ranges], rank_num=rank, exist_threshold=thr)
    jmulti = jsearch.search_objects_multi(js, [jnp.asarray(aq)] * 2, [ranges] * 2, rank_num=rank, exist_threshold=thr)
    assert [[(d.x, d.y, d.z, d.mode) for d in m] for m in multi] == [[(d.x, d.y, d.z, d.mode) for d in m]
                                                                     for m in jmulti]
    assert [[dataclasses.astuple(d) for d in m] for m in multi] == [[dataclasses.astuple(d) for d in
                                                                     tsearch.search_object(ts, aq, ranges, rank_num=rank,
                                                                                           exist_threshold=thr)]] * 2
