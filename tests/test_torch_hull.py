"""Port parity: ops/hull.py against the JAX package.

``radial_hull`` bins points by ``atan2``, which XLA and torch may round an
ulp apart, so a point on a bin edge may land in either bin: centres are
compared within 1e-6 and radii within 1e-5 on clouds with no point within
1e-4 rad of an edge, and ``in_radial_hull`` exactly on queries away from
the edges and from the boundary radius.  The host polygon routines are
numpy on both sides and must agree bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapping_private_tpu.ops import hull as jh
from mapping_private_tpu_torch.ops import hull as th

BINS = 72


def _away_from_edges(xy, center, bins=BINS, margin=1e-4):
    ang = np.arctan2(xy[:, 1] - center[1], xy[:, 0] - center[0]) + np.pi
    frac = ang / (2 * np.pi) * bins
    return np.abs(frac - np.round(frac)) > margin * bins / (2 * np.pi)


def _table(seed=0, n=2000):
    """A table top symmetric about the origin (each point and its mirror
    image live or dead together), so its centroid is 0 to within f32
    rounding and the bin edges are known beforehand."""
    rng = np.random.default_rng(seed)
    half = rng.uniform([-0.6, -0.4], [0.6, 0.4], (n // 2, 2)).astype(np.float32)
    live = rng.uniform(size=n // 2) > 0.2
    return np.concatenate([half, -half]), np.concatenate([live, live])


@pytest.mark.parametrize("bins", [BINS, 16])
def test_radial_hull_matches(bins):
    xy, mask = _table()
    keep = mask & _away_from_edges(xy, np.zeros(2), bins)
    jhull = jh.radial_hull(jnp.asarray(xy), jnp.asarray(keep), num_bins=bins)
    assert _away_from_edges(xy[keep], np.asarray(jhull.center), bins, margin=5e-5).all()
    thull = th.radial_hull(torch.from_numpy(xy), torch.from_numpy(keep), num_bins=bins)
    np.testing.assert_allclose(thull.center.numpy(), np.asarray(jhull.center), rtol=0, atol=1e-6)
    np.testing.assert_allclose(thull.radii.numpy(), np.asarray(jhull.radii), rtol=0, atol=1e-5)
    assert (thull.radii.numpy() > 0.35).all()


def test_in_radial_hull_matches():
    xy, mask = _table(seed=1)
    jhull = jh.radial_hull(jnp.asarray(xy), jnp.asarray(mask))
    thull = th.RadialHull(center=torch.tensor(np.asarray(jhull.center)),
                          radii=torch.tensor(np.asarray(jhull.radii)))
    rng = np.random.default_rng(2)
    q = rng.uniform(-1, 1, (3000, 2)).astype(np.float32)
    c, radii = np.asarray(jhull.center), np.asarray(jhull.radii)
    r = np.linalg.norm(q - c, axis=1)
    off_boundary = np.abs(r[:, None] - radii[None, :]).min(1) > 1e-5
    ok = _away_from_edges(q, c) & off_boundary
    for margin in (0.0, 0.05):
        want = np.asarray(jh.in_radial_hull(jhull, jnp.asarray(q), margin))
        got = th.in_radial_hull(thull, torch.from_numpy(q), margin).numpy()
        np.testing.assert_array_equal(got[ok], want[ok])
        assert 0.2 < got.mean() < 0.8
    # the hull of an empty set: nothing inside but the centre
    empty = th.radial_hull(torch.from_numpy(xy), torch.zeros(len(xy), dtype=torch.bool))
    assert not th.in_radial_hull(empty, torch.from_numpy(q)).any()


def test_host_polygon_routines_match():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(40, 2)), rng.normal(size=(30, 2)) + [0.7, 0.2]
    ha, hb = th.convex_hull_2d(a), th.convex_hull_2d(b)
    np.testing.assert_array_equal(ha, jh.convex_hull_2d(a))
    assert th.polygon_area(ha) == jh.polygon_area(ha)
    clip = th.convex_polygon_intersection(ha, hb)
    np.testing.assert_array_equal(clip, jh.convex_polygon_intersection(ha, hb))
    assert 0 < th.polygon_area(clip) < min(th.polygon_area(ha), th.polygon_area(hb))
    assert len(th.convex_polygon_intersection(ha, hb + 50.0)) == 0
    q = rng.normal(size=(500, 2)) * 1.5
    np.testing.assert_array_equal(th.point_in_polygon(ha, q), jh.point_in_polygon(ha, q))
    assert len(th.convex_hull_2d(a[:2])) == 2
