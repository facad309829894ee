"""Port parity: fit/ransac.py against the JAX package, with the JAX
package's uniform draws carried across (``tests/jax_ref.py``).

With the same uniforms the sampled indices are equal row for row (the
mask's float32 cumsum is exact below 2^24).  The scores are sums over
(H, N) distances that the two libraries round differently, so two
hypotheses within f32 rounding of each other may rank either way: the
fitted models are compared within 1e-4 and the inlier sets up to the
points within 1e-6 of the threshold.  A batched plane fit (one mask per
row) equals the row-by-row fits: planes within 1e-6, inliers exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import jit_call, uniforms_from_jax

from mapping_private_tpu.fit import ransac as jr
from mapping_private_tpu_torch.fit import ransac as tr

TOL = dict(rtol=0, atol=1e-4)


def _u(seed, shape):
    return uniforms_from_jax(jax.random.PRNGKey(seed), [shape])[0]


def _key_and_u(seed, shape):
    """The key a JAX sampler is given and the uniforms it draws with it."""
    key, sub = jax.random.split(jax.random.PRNGKey(seed))
    return sub, torch.tensor(_u(seed, shape))


def _plane_scene(seed=0, n=900):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    z = 0.3 * xy[:, 0] - 0.2 * xy[:, 1] + 0.75 + rng.normal(0, 0.003, n)
    pts = np.column_stack([xy, z])
    pts[: n // 4] = rng.uniform(-1, 1, (n // 4, 3))  # outliers
    mask = rng.uniform(size=n) > 0.1
    return pts.astype(np.float32), mask


def _inliers_match(got, want, dist, threshold):
    near = np.abs(dist - threshold) < 1e-6
    np.testing.assert_array_equal(got[~near], want[~near])


@pytest.mark.parametrize("n, dead", [(1000, 0.0), (777, 0.4), (50, 0.98)])
def test_sample_live_indices_equal(n, dead):
    rng = np.random.default_rng(n)
    mask = rng.uniform(size=n) >= dead
    key, u = _key_and_u(n, (64, 3))
    want = np.asarray(jr.sample_live_indices(key, jnp.asarray(mask), (64, 3)))
    got = tr.sample_live_indices(None, torch.from_numpy(mask), (64, 3), u=u).numpy()
    np.testing.assert_array_equal(got, want)
    assert mask[got].all()


@pytest.mark.parametrize("method", ["ransac", "msac"])
def test_score_hypotheses_matches(method):
    rng = np.random.default_rng(1)
    d = rng.uniform(0, 0.05, (16, 300)).astype(np.float32)
    mask = rng.uniform(size=300) > 0.3
    want = np.asarray(jr.score_hypotheses(jnp.asarray(d), jnp.asarray(mask), 0.02, method))
    got = tr.score_hypotheses(torch.from_numpy(d), torch.from_numpy(mask), 0.02, method).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError):
        tr.score_hypotheses(torch.from_numpy(d), torch.from_numpy(mask), 0.02, "lmeds")


@pytest.mark.parametrize("method, refine", [("msac", 2), ("ransac", 0)])
def test_fit_plane_ransac_matches(method, refine):
    pts, mask = _plane_scene()
    key, u = _key_and_u(3, (128, 3))
    kw = dict(num_hypotheses=128, threshold=0.02, method=method, refine_iters=refine)
    jp, ji = jit_call(jr.fit_plane_ransac, jnp.asarray(pts), jnp.asarray(mask), key, **kw)
    tp, ti = tr.fit_plane_ransac(torch.from_numpy(pts), torch.from_numpy(mask), u=u, **kw)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    _inliers_match(ti.numpy(), np.asarray(ji), np.abs(pts @ np.asarray(jp)[:3] + np.asarray(jp)[3]), 0.02)
    assert abs(tp[2]) > 0.9 and ti.sum() > 500


def test_fit_plane_ransac_axis_constraint_matches():
    """A wall and a floor: the axis gate picks the floor although the wall
    holds more points (the few wall points near z = 0 are its inliers too)."""
    rng = np.random.default_rng(4)
    wall = np.column_stack([np.full(700, 1.0), rng.uniform(-1, 1, (700, 2))])
    floor = np.column_stack([rng.uniform(-1, 1, (300, 2)), np.zeros(300)])
    pts = np.concatenate([wall, floor]).astype(np.float32)
    mask = np.ones(len(pts), bool)
    key, u = _key_and_u(5, (256, 3))
    axis = np.array([0.0, 0.0, 1.0], np.float32)
    kw = dict(num_hypotheses=256, threshold=0.01, eps_angle=0.2)
    jp, ji = jit_call(jr.fit_plane_ransac, jnp.asarray(pts), jnp.asarray(mask), key, axis=jnp.asarray(axis), **kw)
    tp, ti = tr.fit_plane_ransac(torch.from_numpy(pts), torch.from_numpy(mask), u=u,
                                 axis=torch.from_numpy(axis), **kw)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert abs(tp[2]) > 0.99 and 300 <= int(ti.sum()) < 320


def test_fit_plane_ransac_batched_equals_rows():
    pts, mask = _plane_scene(seed=2)
    rng = np.random.default_rng(6)
    masks = np.stack([mask, rng.uniform(size=len(mask)) > 0.5, np.zeros(len(mask), bool)])
    u = torch.tensor(np.stack([_u(s, (64, 3)) for s in range(3)]))
    bp, bi = tr.fit_plane_ransac(torch.from_numpy(pts), torch.from_numpy(masks), u=u, num_hypotheses=64)
    assert bp.shape == (3, 4) and bi.shape == masks.shape
    for r in range(3):
        p, i = tr.fit_plane_ransac(torch.from_numpy(pts), torch.from_numpy(masks[r]), u=u[r], num_hypotheses=64)
        np.testing.assert_allclose(bp[r].numpy(), p.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(bi[r].numpy(), i.numpy())
    assert not bi[2].any()


def test_fit_plane_ransac_generator_draws():
    """With a generator the fit draws its own uniforms: the same seed gives
    the same plane, and it finds the plane."""
    pts, mask = _plane_scene(seed=3)
    runs = [tr.fit_plane_ransac(torch.from_numpy(pts), torch.from_numpy(mask),
                                torch.Generator().manual_seed(7), num_hypotheses=128)[0] for _ in range(2)]
    np.testing.assert_array_equal(runs[0].numpy(), runs[1].numpy())
    z0 = -float(runs[0][3]) / float(runs[0][2])
    assert abs(z0 - 0.75) < 0.01


def test_fit_line2d_ransac_matches():
    rng = np.random.default_rng(7)
    t = rng.uniform(-1, 1, 400)
    xy = np.column_stack([t, 0.5 * t + 0.1 + rng.normal(0, 0.002, 400)])
    xy[:120] = rng.uniform(-1, 1, (120, 2))
    xy = xy.astype(np.float32)
    mask = rng.uniform(size=400) > 0.05
    key, u = _key_and_u(8, (128, 2))
    jl, ji = jit_call(jr.fit_line2d_ransac, jnp.asarray(xy), jnp.asarray(mask), key, num_hypotheses=128)
    tl, ti = tr.fit_line2d_ransac(torch.from_numpy(xy), torch.from_numpy(mask), u=u, num_hypotheses=128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _inliers_match(ti.numpy(), np.asarray(ji), np.abs(xy @ np.asarray(jl)[:2] + np.asarray(jl)[2]), 0.01)
    assert ti.sum() > 250


@pytest.mark.parametrize("max_radius", [np.inf, 0.2])
def test_fit_circle2d_ransac_matches(max_radius):
    """A circle of radius 0.3 among outliers; capped at 0.2 the fit must
    settle for some smaller circle, the same on both sides."""
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 2 * np.pi, 300)
    xy = np.column_stack([0.2 + 0.3 * np.cos(a), -0.1 + 0.3 * np.sin(a)]) + rng.normal(0, 0.002, (300, 2))
    xy = np.concatenate([xy, rng.uniform(-1, 1, (80, 2))]).astype(np.float32)
    mask = np.ones(len(xy), bool)
    key, u = _key_and_u(10, (128, 3))
    kw = dict(num_hypotheses=128, min_radius=0.05, max_radius=max_radius)
    jc, ji = jit_call(jr.fit_circle2d_ransac, jnp.asarray(xy), jnp.asarray(mask), key, **kw)
    tc, ti = tr.fit_circle2d_ransac(torch.from_numpy(xy), torch.from_numpy(mask), u=u, **kw)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    jc = np.asarray(jc)
    _inliers_match(ti.numpy(), np.asarray(ji), np.abs(np.linalg.norm(xy - jc[:2], axis=1) - jc[2]), 0.01)
    if max_radius == np.inf:
        np.testing.assert_allclose(tc.numpy(), [0.2, -0.1, 0.3], atol=0.01)
    else:
        assert 0.05 <= float(tc[2]) <= 0.2
