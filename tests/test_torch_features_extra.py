"""Port parity: features/pfh.py, gfpfh.py, hlac2d.py and extract.py
against the JAX package.

- PFH pair features within 1e-5, the histograms bin for bin (within 1e-4:
  each bin is a sum of the same increments);
- GFPFH with the JAX package's uniforms carried across (``split`` then
  ``uniform`` for each end), within 1e-6;
- the 2-D HLAC variants within 1e-6 relative (sums of integer products);
- the extraction pipelines on a seeded coloured cloud: the grid exact,
  the surface types equal on at least 97% of the occupied voxels (RSD
  votes near get_type's thresholds may flip), the ColorCHLAC parts
  within 2e-5 of each block's largest bin; and every feature unchanged
  by ``dim_floor`` padding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import jit_call, one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.core import PointCloud as JCloud
from mapping_private_tpu.features import extract as jex
from mapping_private_tpu.features import gfpfh as jgf
from mapping_private_tpu.features import hlac2d as jhl
from mapping_private_tpu.features import pfh as jpfh
from mapping_private_tpu.features import rsd as jrsd
from mapping_private_tpu_torch.core import PointCloud
from mapping_private_tpu_torch.features import extract as tex
from mapping_private_tpu_torch.features import gfpfh as tgf
from mapping_private_tpu_torch.features import hlac2d as thl
from mapping_private_tpu_torch.features import pfh as tpfh
from mapping_private_tpu_torch.features import rsd as trsd


def _sphere(n=256, r=0.05, seed=0):
    """Points on a sphere with noisy normals: on the exact sphere many pair
    features sit exactly on a bin edge (β = 1/2), where rounding picks
    the bin."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    nrm = v + rng.normal(0, 0.05, v.shape)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (r * v).astype(np.float32), nrm.astype(np.float32)


def test_pair_features_match():
    rng = np.random.default_rng(1)
    ps, pt = (rng.normal(size=(500, 3)).astype(np.float32) for _ in range(2))
    ns, nt = (rng.normal(size=(500, 3)) for _ in range(2))
    ns, nt = ((a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32) for a in (ns, nt))
    pt[:3] = ps[:3]  # zero-length pairs are invalid
    for flip in (True, False):
        got = tpfh.pair_features(*(torch.tensor(a) for a in (ps, ns, pt, nt)), check_flip=flip)
        want = jpfh.pair_features(*(jnp.asarray(a) for a in (ps, ns, pt, nt)), check_flip=flip)
        ok = np.asarray(want[4])
        np.testing.assert_array_equal(got[4].numpy(), ok)
        assert not ok[:3].any() and ok[3:].all()
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_allclose(g.numpy()[ok], np.asarray(w)[ok], rtol=0, atol=1e-5)


@pytest.mark.parametrize("combine,use_dist,quantum", [(True, False, 4), (True, True, 3), (False, True, 5)])
def test_pfh_histograms_match(combine, use_dist, quantum):
    pts, nrm = _sphere()
    mask = np.arange(len(pts)) % 7 != 0
    kw = dict(radius=0.03, k=12, quantum=quantum, combine=combine, use_dist=use_dist)
    got = tpfh.pfh_histograms(torch.tensor(pts), torch.tensor(nrm), torch.tensor(mask), **kw).numpy()
    want = np.asarray(jit_call(jpfh.pfh_histograms, jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(mask), **kw))
    assert got.shape == want.shape == (256, quantum ** (4 if use_dist else 3) if combine else quantum * 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[mask].sum(1), 100.0 * (1 if combine else 4), rtol=1e-4)
    np.testing.assert_array_equal(got[~mask], 0.0)


def _jax_gfpfh_uniforms(key, num_pairs):
    ka, kb = jax.random.split(key)
    return tuple(torch.tensor(np.asarray(jax.random.uniform(k, (num_pairs,)))) for k in (ka, kb))


@pytest.mark.parametrize("hollow", [False, True])
def test_gfpfh_matches_with_the_jax_draws(hollow):
    rng = np.random.default_rng(2)
    t = rng.integers(0, 5, (8, 7, 6)).astype(np.int32)
    occ = rng.uniform(size=t.shape) < (0.3 if hollow else 0.9)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jgf.gfpfh_global(jnp.asarray(t), jnp.asarray(occ), key, num_pairs=512))
    got = tgf.gfpfh_global(torch.tensor(t), torch.tensor(occ), num_pairs=512,
                           u=_jax_gfpfh_uniforms(key, 512)).numpy()
    assert got.shape == (150,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(), 1.0, atol=1e-5)
    # from a generator: a distribution over the same bins
    g = tgf.gfpfh_global(torch.tensor(t), torch.tensor(occ), torch.Generator().manual_seed(0), num_pairs=512)
    assert abs(float(g.sum()) - 1.0) < 1e-5
    empty = tgf.gfpfh_global(torch.zeros((4, 4, 4), dtype=torch.int32), torch.zeros((4, 4, 4), dtype=torch.bool),
                             torch.Generator().manual_seed(0))
    assert torch.isfinite(empty).all() and float(empty.sum()) == 0.0


def test_hlac2d_matches():
    rng = np.random.default_rng(4)
    assert (thl.BIN2_3, thl.GRAY2_3, thl.COLOR1_3) == (jhl.BIN2_3, jhl.GRAY2_3, jhl.COLOR1_3)
    assert (thl.BIN1_3, thl.GRAY1_3) == (jhl.BIN1_3, jhl.GRAY1_3)
    binary = (rng.uniform(size=(23, 17)) < 0.4).astype(np.float32)
    gray = rng.integers(0, 256, (23, 17)).astype(np.float32) / 255.0
    color = rng.integers(0, 256, (23, 17, 3)).astype(np.float32) / 255.0
    for rx, ry in ((1, 1), (2, 3)):
        for norm in (False, True):
            for order in (1, 2):
                for t_fn, j_fn, img in ((thl.hlac_bin, jhl.hlac_bin, binary), (thl.hlac_gray, jhl.hlac_gray, gray)):
                    got = t_fn(img, order=order, rx=rx, ry=ry, normalize=norm).numpy()
                    want = np.asarray(j_fn(jnp.asarray(img), order=order, rx=rx, ry=ry, normalize=norm))
                    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            got = thl.hlac_color(color, rx=rx, ry=ry, normalize=norm).numpy()
            want = np.asarray(jhl.hlac_color(jnp.asarray(color), rx=rx, ry=ry, normalize=norm))
            assert got.shape == (45,)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _object_cloud(seed=5, n=1500):
    """A 6 cm box (red) beside a cylinder of radius 2.5 cm (blue), integer
    colours with noise: (xyz, channels)."""
    rng = np.random.default_rng(seed)
    m = n // 2
    face = rng.integers(0, 6, m)
    p = rng.uniform(-0.03, 0.03, (m, 3))
    p[np.arange(m), face // 2] = np.where(face % 2, 0.03, -0.03)
    th = rng.uniform(0, 2 * np.pi, n - m)
    cyl = np.column_stack([0.1 + 0.025 * np.cos(th), 0.025 * np.sin(th), rng.uniform(-0.03, 0.05, n - m)])
    xyz = (np.vstack([p, cyl]) + rng.normal(0, 0.0005, (n, 3))).astype(np.float32)
    rgb = np.vstack([np.tile([200, 40, 30], (m, 1)), np.tile([30, 60, 210], (n - m, 1))])
    rgb = np.clip(rgb + rng.normal(0, 10, (n, 3)), 0, 255).round()
    return xyz, {c: rgb[:, i].astype(np.float32) for i, c in enumerate("rgb")}


@pytest.fixture(scope="module")
def clouds():
    xyz, ch = _object_cloud()
    return JCloud.from_numpy(xyz, channels=ch), PointCloud.from_numpy(xyz, ch, device="cpu")


def test_voxelize_for_features_and_types_match(clouds):
    jc, tc = clouds
    jg, tg = jex.voxelize_for_features(jc), tex.voxelize_for_features(tc)
    assert tg.dims == tuple(jg.dims) and tg.dims[0] % 8 == 0
    np.testing.assert_array_equal(tg.count.numpy(), np.asarray(jg.count))
    np.testing.assert_allclose(tg.origin.numpy(), np.asarray(jg.origin), rtol=0, atol=0)
    np.testing.assert_allclose(tg.mean("_xyz").numpy(), np.asarray(jg.mean("_xyz")), rtol=0, atol=1e-6)
    occ = tg.occupancy().numpy()
    for t_fn, j_fn in ((tex.voxel_types, jex.voxel_types), (tex.voxel_types_era, jex.voxel_types_era)):
        tt = t_fn(tc, tg).numpy()
        jt = np.asarray(jit_call(j_fn, jc, jg))
        assert tt.dtype == np.int32 and tt.shape == tg.dims
        agree = (tt == jt)[occ].mean()
        assert agree >= 0.97, (t_fn.__name__, agree)
        assert len(np.unique(tt[occ])) >= 2


def _jax_extracts(jc):
    """The JAX package's three extract_* results, their device stages
    jitted (the same functions, one compile each)."""
    from mapping_private_tpu.features import colorchlac as jcc

    grid = jex.voxelize_for_features(jc)
    c117 = np.asarray(jit_call(jcc.colorchlac117, grid))
    c981 = np.asarray(jit_call(jcc.colorchlac981, grid))
    g = np.asarray(jit_call(jrsd.grsd20_era, jit_call(jex.voxel_types_era, jc, grid), grid.occupancy()))
    halved = c117.copy()
    halved[0:6] *= 0.5
    halved[63:69] *= 0.5
    return c117, halved, c981, np.asarray(jcc.to_reference_layout_981(jnp.asarray(c981))), np.concatenate([g, halved])


def test_extract_pipelines_match(clouds):
    from test_torch_colorchlac import _close

    jc, tc = clouds
    c117, halved, c981, c981_ref, grsd_cchlac = _jax_extracts(jc)
    _close(tex.extract_colorchlac117(tc).numpy(), c117, 117)
    _close(tex.extract_colorchlac117(tc, legacy_zeroth_scale=True).numpy(), halved, 117)
    got = tex.extract_colorchlac981(tc).numpy()
    assert got.shape == (981,)
    _close(got, c981, 981)
    got = tex.extract_colorchlac981(tc, layout="reference").numpy()
    np.testing.assert_allclose(got, c981_ref, rtol=0, atol=2e-5 * np.abs(c981_ref).max())
    got = tex.extract_grsd_cchlac(tc, legacy_zeroth_scale=True).numpy()
    assert got.shape == (137,)
    _close(got[20:], grsd_cchlac[20:], 117)
    # GRSD-20 counts move by the few flipped voxels' transitions
    assert np.abs(got[:20] - grsd_cchlac[:20]).sum() <= 0.05 * np.abs(grsd_cchlac[:20]).sum()


def test_features_do_not_change_with_dim_floor(clouds):
    from test_torch_colorchlac import _close

    _, tc = clouds
    g0 = tex.voxelize_for_features(tc)
    g1 = tex.voxelize_for_features(tc, dim_floor=40, dim_bucket=1)
    assert g1.dims != g0.dims and min(g1.dims) >= 40
    t0, t1 = tex.voxel_types(tc, g0), tex.voxel_types(tc, g1)
    occ0 = g0.occupancy()
    sl = tuple(slice(0, d) for d in g0.dims)
    assert torch.equal(g1.count[sl], g0.count) and int(g1.count.sum()) == int(g0.count.sum())
    assert torch.equal(t1[sl][occ0], t0[occ0])
    assert torch.equal(trsd.grsd20_from_types(t1, g1.occupancy()), trsd.grsd20_from_types(t0, occ0))
    from mapping_private_tpu_torch.features import colorchlac981

    _close(colorchlac981(g1).numpy(), colorchlac981(g0).numpy(), 981, rtol=1e-6)
