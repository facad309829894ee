"""Port parity: features/rsd.py against the JAX package.

- ``rsd_radii`` and ``rsd_radii_pcl`` on the same seeded surfaces: the
  radii within 1e-5 (both build the kNN from the same expansion form;
  their sums round differently), for at least 98% of the voxels; the
  base point of a voxel whose centroid lies exactly between two points
  is the lower index in both.  The surface types are equal wherever both
  radii lie more than 1e-5 from every threshold of ``get_type``, and the
  flips elsewhere are counted (at most 2% of the voxels).
- The type classifiers exactly; the GRSD-20 (snapshot, era, per block),
  GRSD-325, PlusGRSD-110 and VOSCH variants on seeded type grids:
  transition counts are integers, exact in f32, so they are compared bit
  for bit (PlusGRSD-110 and VOSCH's colour half within 1e-5 relative)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import jit_call, one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.core import PointCloud as JCloud
from mapping_private_tpu.core.voxelgrid import voxelize as jvoxelize
from mapping_private_tpu.features import rsd as jrsd
from mapping_private_tpu_torch.core import PointCloud
from mapping_private_tpu_torch.core.voxelgrid import voxelize as tvoxelize
from mapping_private_tpu_torch.features import rsd as trsd

THRESHOLDS = (0.015, 0.100, 0.175)  # get_type's, on r_min and r_max


def _surface(seed, n=700):
    """A cylinder (r 0.03) standing on a plane, and a small sphere: points
    and analytic normals, 1 mm noise."""
    rng = np.random.default_rng(seed)
    m = n // 3
    th = rng.uniform(0, 2 * np.pi, m)
    cyl = np.column_stack([0.03 * np.cos(th), 0.03 * np.sin(th), rng.uniform(0, 0.06, m)])
    ncyl = np.column_stack([np.cos(th), np.sin(th), np.zeros(m)])
    pla = np.column_stack([rng.uniform(-0.06, 0.06, (m, 2)), np.zeros(m)])
    npla = np.tile([0.0, 0.0, 1.0], (m, 1))
    v = rng.normal(size=(n - 2 * m, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    sph = v * 0.02 + [0.07, 0.07, 0.03]
    xyz = np.vstack([cyl, pla, sph]) + rng.normal(0, 0.001, (n, 3))
    nrm = np.vstack([ncyl, npla, v])
    return xyz.astype(np.float32), nrm.astype(np.float32)


def _away_from_thresholds(r_min, r_max, tol=1e-5):
    return np.all([(np.abs(r - t) > tol) for r in (r_min, r_max) for t in THRESHOLDS], axis=0)


def test_constants_equal():
    assert trsd.NEIGHBOR_OFFSETS_26 == jrsd.NEIGHBOR_OFFSETS_26
    assert (trsd.NOISE, trsd.PLANE, trsd.CYLINDER, trsd.SPHERE, trsd.EDGE, trsd.EMPTY) == (
        jrsd.NOISE, jrsd.PLANE, jrsd.CYLINDER, jrsd.SPHERE, jrsd.EDGE, jrsd.EMPTY)
    assert trsd.NORMALIZE_GRSD == jrsd.NORMALIZE_GRSD and trsd.GRSD_GOLD_SCALE == jrsd.GRSD_GOLD_SCALE
    assert (trsd.ERA_EDGE_RMIN, trsd.ERA_NR_SUBDIV, trsd.ERA_NORMALS_RADIUS, trsd.NR_DIV) == (
        jrsd.ERA_EDGE_RMIN, jrsd.ERA_NR_SUBDIV, jrsd.ERA_NORMALS_RADIUS, jrsd.NR_DIV)
    assert trsd._LOWER_TRI_ERA == jrsd._LOWER_TRI_ERA and trsd._UPPER_TRI_6 == jrsd._UPPER_TRI_6


def test_get_type_classifiers_exact():
    r = np.concatenate([np.linspace(0, 0.25, 501), [0.015, 0.1, 0.175, 0.037, 0.05]]).astype(np.float32)
    rmin, rmax = np.meshgrid(r, r)
    rmin, rmax = rmin.ravel(), rmax.ravel()
    got = trsd.get_type(torch.tensor(rmin), torch.tensor(rmax))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrsd.get_type(jnp.asarray(rmin), jnp.asarray(rmax))))
    np.testing.assert_array_equal(trsd.get_type_era(torch.tensor(rmin), torch.tensor(rmax)).numpy(),
                                  np.asarray(jrsd.get_type_era(jnp.asarray(rmin), jnp.asarray(rmax))))


def test_rsd_radii_matches():
    xyz, nrm = _surface(0)
    mask = np.arange(len(xyz)) % 11 != 0
    q = xyz[::3]
    qn = nrm[::3]
    qmask = np.arange(len(q)) % 5 != 0
    jr = jrsd.rsd_radii(jnp.asarray(q), jnp.asarray(qmask), jnp.asarray(xyz), jnp.asarray(mask),
                        jnp.asarray(nrm), jnp.asarray(qn), radius=0.02, k=48)
    tr = trsd.rsd_radii(torch.tensor(q), torch.tensor(qmask), torch.tensor(xyz), torch.tensor(mask),
                        torch.tensor(nrm), torch.tensor(qn), radius=0.02, k=48)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    assert (tr[1].numpy()[qmask] > 0).mean() > 0.9


@pytest.mark.parametrize("nr_subdiv", [5, 4])
def test_rsd_radii_pcl_types_match(nr_subdiv):
    xyz, nrm = _surface(1)
    mask = np.arange(len(xyz)) % 13 != 0
    jc = JCloud.from_numpy(xyz).select(jnp.asarray(np.pad(mask, (0, 768 - len(xyz)))))
    dims = (14, 14, 8)
    origin = np.array([-0.07, -0.07, -0.005], np.float32)
    jg = jvoxelize(jc.with_channel("_xyz", jc.padded_xyz()), 0.01, jnp.asarray(origin), dims, channels=("_xyz",))
    cent = np.asarray(jg.mean("_xyz")).reshape(-1, 3)
    occ = np.asarray(jg.occupancy()).reshape(-1)
    sx, sm = np.asarray(jc.padded_xyz()), np.asarray(jc.mask)
    sn = np.pad(nrm, ((0, 768 - len(xyz)), (0, 0)))
    kw = dict(radius=jrsd_radius(), k=96, nr_subdiv=nr_subdiv)
    # op by op: one jitted JAX program fuses the distances' multiply-adds
    # and breaks the exact ties of two-point centroids otherwise
    jmin, jmax = jrsd.rsd_radii_pcl(jnp.asarray(cent), jnp.asarray(occ), jnp.asarray(sx),
                                    jnp.asarray(sm), jnp.asarray(sn), **kw)
    tmin, tmax = trsd.rsd_radii_pcl(torch.tensor(cent), torch.tensor(occ), torch.tensor(sx), torch.tensor(sm),
                                    torch.tensor(sn), **kw)
    jmin, jmax, tmin, tmax = (np.asarray(a) for a in (jmin, jmax, tmin, tmax))
    assert occ.sum() > 100 and (tmax[occ] > 0).mean() > 0.9
    np.testing.assert_array_equal(tmin[~occ], 0.0)
    close = np.isclose(tmin, jmin, rtol=0, atol=1e-5) & np.isclose(tmax, jmax, rtol=0, atol=1e-5)
    assert close[occ].mean() >= 0.98, close[occ].mean()
    tt = trsd.get_type(torch.tensor(tmin), torch.tensor(tmax)).numpy()
    jt = np.asarray(jrsd.get_type(jnp.asarray(jmin), jnp.asarray(jmax)))
    away = _away_from_thresholds(tmin, tmax) & _away_from_thresholds(jmin, jmax)
    np.testing.assert_array_equal(tt[away & close], jt[away & close])
    flips = int((tt != jt)[occ].sum())
    assert flips <= 0.02 * occ.sum(), flips
    assert len(np.unique(tt[occ])) >= 2


def jrsd_radius():
    from mapping_private_tpu.features.extract import RSD_RADIUS

    return RSD_RADIUS


def _type_grid(seed, dims=(6, 5, 4), n_types=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_types, dims).astype(np.int32), rng.uniform(size=dims) < 0.6


@pytest.mark.parametrize("normalize", [False, True])
def test_grsd_variants_exact(normalize):
    t, occ = _type_grid(2)
    jt, jo, tt, to = jnp.asarray(t), jnp.asarray(occ), torch.tensor(t), torch.tensor(occ)
    for name in ("grsd20_from_types", "grsd325_from_types"):
        got = getattr(trsd, name)(tt, to, normalize=normalize).numpy()
        want = np.asarray(jit_call(getattr(jrsd, name), jt, jo, normalize=normalize))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(trsd.grsd20_era(tt, to, normalize=normalize).numpy(),
                                  np.asarray(jit_call(jrsd.grsd20_era, jt, jo, normalize=normalize)))
    for bs in (2, 4):
        got = trsd.grsd20_subdiv(tt, to, bs, normalize=normalize).numpy()
        np.testing.assert_array_equal(got, np.asarray(jit_call(jrsd.grsd20_subdiv, jt, jo, block_size=bs, normalize=normalize)))
        np.testing.assert_allclose(got.sum((0, 1, 2)), trsd.grsd20_from_types(tt, to, normalize=normalize).numpy(),
                                   rtol=1e-6)


def test_plus_grsd110_matches():
    t, occ = _type_grid(3)
    rng = np.random.default_rng(4)
    n = rng.normal(size=t.shape + (3,)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[rng.uniform(size=t.shape) < 0.1] = 0.0  # invalid normals
    got = trsd.plus_grsd110_from_types(torch.tensor(t), torch.tensor(occ), torch.tensor(n)).numpy()
    want = np.asarray(jit_call(jrsd.plus_grsd110_from_types, jnp.asarray(t), jnp.asarray(occ), jnp.asarray(n)))
    assert got.shape == (110,)
    np.testing.assert_array_equal(got, want)


def test_vosch_and_subdiv_match():
    rng = np.random.default_rng(5)
    dims = (6, 6, 4)
    xyz = (rng.uniform(0, 1, (300, 3)) * np.asarray(dims) * 0.01).astype(np.float32)
    ch = {c: rng.integers(0, 256, 300).astype(np.float32) for c in "rgb"}
    jg = jvoxelize(JCloud.from_numpy(xyz, channels=ch), 0.01, jnp.zeros(3), dims, channels=("r", "g", "b"))
    tg = tvoxelize(PointCloud.from_numpy(xyz, ch, device="cpu"), 0.01, torch.zeros(3), dims, channels=("r", "g", "b"))
    t = rng.integers(0, 5, dims).astype(np.int32)
    got = trsd.vosch(tg, torch.tensor(t)).numpy()
    want = np.asarray(jit_call(jrsd.vosch, jg, jnp.asarray(t)))
    assert got.shape == (137,)
    np.testing.assert_array_equal(got[:20], want[:20])
    np.testing.assert_allclose(got[20:], want[20:], rtol=1e-5, atol=1e-5 * np.abs(want).max())
    got = trsd.vosch_subdiv(tg, torch.tensor(t), 3, normalize_grsd=True).numpy()
    want = np.asarray(jit_call(jrsd.vosch_subdiv, jg, jnp.asarray(t), block_size=3, normalize_grsd=True))
    assert got.shape == (2, 2, 2, 137)
    np.testing.assert_array_equal(got[..., :20], want[..., :20])
    np.testing.assert_allclose(got[..., 20:], want[..., 20:], rtol=1e-5, atol=1e-5 * np.abs(want).max())
