"""Port parity: fit/orientation.py and fit/rotational.py against the JAX
package on the scenes of tests/test_fit_models.py (TestOrientation,
TestRotational), with the JAX package's uniform draws carried across.

- Orientation: the same hypotheses win, the direction within 1e-6 and
  the inliers identical.
- Rotational: the axis within 1e-5 (up to sign), each point's residual
  within 1e-4 and the inliers identical.  The axis point and the contour
  coefficients are not compared: the point slides along the axis (the
  Gauss-Newton steps leave that direction to the 1e-6 damping), and the
  contour follows it.

Divergences by design: a hypothesis whose score is not finite counts as
degenerate; a Gauss-Newton step or contour re-fit that is not finite is
not taken; after each step the axis point goes back to the inliers'
axial centroid (the same line).  The JAX package's point can slide a
metre along the axis, and its polish returns NaN for the 20,000-point
vase with some keys; the last test holds the port to recovering it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.fit import orientation as jo
from mapping_private_tpu.fit import rotational as jr
from mapping_private_tpu_torch.fit import orientation as to
from mapping_private_tpu_torch.fit import rotational as tr


def _manhattan_normals(seed=6, th_deg=25.0):
    """test_fit_models.py::TestOrientation's normals, with dead rows."""
    rng = np.random.default_rng(seed)
    th = np.deg2rad(th_deg)
    d = np.array([np.cos(th), np.sin(th), 0.0])
    left = np.cross([0, 0, 1.0], d)
    dirs = np.stack([d, -d, left, -left])
    normals = dirs[rng.integers(0, 4, 400)] + rng.normal(0, 0.02, (400, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    up = np.tile([0, 0, 1.0], (100, 1)) + rng.normal(0, 0.02, (100, 3))
    up /= np.linalg.norm(up, axis=1, keepdims=True)
    mask = np.ones(500, bool)
    mask[::9] = False
    return np.vstack([normals, up]).astype(np.float32), mask, d


@pytest.mark.parametrize("refine_iters,key", [(2, 3), (0, 4), (3, 5)])
def test_orientation_matches_jax(refine_iters, key):
    normals, mask, d_true = _manhattan_normals()
    k = jax.random.PRNGKey(key)
    dj, ij = jo.fit_orientation_ransac(jnp.asarray(normals), jnp.asarray(mask), k,
                                       eps_angle=0.15, refine_iters=refine_iters)
    u = torch.tensor(np.asarray(jax.random.uniform(k, (128, 1))))
    dt, it = to.fit_orientation_ransac(torch.from_numpy(normals), torch.from_numpy(mask),
                                       eps_angle=0.15, refine_iters=refine_iters, u=u)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # the direction is one of the 4 cardinal directions of the scene
    assert np.abs(np.abs(d_true @ dt.numpy()) - np.array([1.0, 0.0])).min() < 0.02 or \
        abs(abs(np.cross(d_true, dt.numpy())[2]) - 1.0) < 0.02


def test_orientation_with_generator():
    normals, mask, d_true = _manhattan_normals(seed=7, th_deg=-40.0)
    gen = torch.Generator().manual_seed(0)
    dt, it = to.fit_orientation_ransac(torch.from_numpy(normals), torch.from_numpy(mask), gen,
                                       axis=torch.tensor([0.0, 0.0, 2.0]), eps_angle=0.15)
    c = abs(float(d_true @ dt.numpy()))
    assert min(c, abs(1 - c)) < 0.02 and abs(dt.numpy()[2]) < 1e-6
    assert it.numpy()[:400][mask[:400]].mean() > 0.95 and not it.numpy()[400:].any()


def _vase(n=1024, seed=5):
    """test_fit_models.py::TestRotational: r(z) = 0.08 + 0.03 sin 6z about
    the z axis, with the exact normals."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-0.2, 0.2, n)
    r = 0.08 + 0.03 * np.sin(6 * z)
    ang = rng.uniform(0, 2 * np.pi, n)
    pts = np.column_stack([r * np.cos(ang), r * np.sin(ang), z]).astype(np.float32)
    nr = np.column_stack([np.cos(ang), np.sin(ang), -0.18 * np.cos(6 * z)])
    return pts, (nr / np.linalg.norm(nr, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("key,method", [(1, "msac"), (2, "ransac")])
def test_rotational_matches_jax(key, method):
    pts, nrm = _vase()
    mask = np.ones(len(pts), bool)
    mask[::11] = False
    k = jax.random.PRNGKey(key)
    # op by op, as the JAX package runs it (one jitted program fuses the
    # contour solves differently, and on these near-singular systems that
    # can change the winner)
    sj, ij = jr.fit_rotational_ransac(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(mask), k,
                                      threshold=0.01, method=method)
    u = torch.tensor(np.asarray(jax.random.uniform(k, (256, 8))))
    st, it = tr.fit_rotational_ransac(torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(mask),
                                      threshold=0.01, method=method, u=u)
    aj, at = np.asarray(sj.axis), st.axis.numpy()
    np.testing.assert_allclose(at * np.sign(at @ aj), aj, rtol=0, atol=1e-5)
    dj = np.asarray(jr.rotational_distance(sj, jnp.asarray(pts)))
    dt = tr.rotational_distance(st, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(dt[mask], dj[mask], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert it.numpy()[mask].mean() > 0.7 and abs(at[2]) > 0.95


def test_rotational_nan_hypotheses_are_degenerate():
    """A hypothesis whose samples all sit at one k has a near rank-1
    contour system whose solve can overflow to NaN; it must not win."""
    pts, nrm = _vase()
    mask = np.ones(len(pts), bool)
    u = torch.tensor(np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (256, 8))))
    st, it = tr.fit_rotational_ransac(torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(mask),
                                      threshold=0.01, u=u)
    assert all(bool(torch.isfinite(t).all()) for t in (st.point, st.axis, st.coeffs, st.k_scale))
    assert it.numpy().mean() > 0.7


def test_rotational_non_finite_steps_are_not_taken():
    """On a 20,000-point vase the polish's 6×6 system (two null
    directions held by a 1e-6 jitter) overflows in f32: the JAX package
    returns a NaN surface for PRNGKey(1); the port, with the same draws,
    skips the non-finite step, keeps the point centred and recovers the
    vase."""
    pts, nrm = _vase(n=20_000, seed=0)
    mask = np.ones(len(pts), bool)
    k = jax.random.PRNGKey(1)
    sj, _ = jr.fit_rotational_ransac(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(mask), k, threshold=0.01)
    assert np.isnan(np.asarray(sj.axis)).all()
    u = torch.tensor(np.asarray(jax.random.uniform(k, (256, 8))))
    st, it = tr.fit_rotational_ransac(torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(mask),
                                      threshold=0.01, u=u)
    assert abs(float(st.axis[2])) > 0.999 and it.numpy().mean() > 0.99
    assert float(tr.rotational_distance(st, torch.from_numpy(pts)).median()) < 1e-3
