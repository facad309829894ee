"""Port parity: ops/mls.py, fit/box.py and fit/cylinder.py against the JAX
package on the same numpy clusters (tests/test_pipeline_memory.py's
cylinder and box surfaces), the cylinder RANSAC with the JAX package's
uniforms carried across.

MLS ranks neighbours over matmul-form distances, which the two libraries
round differently, so a point may trade its k-th neighbour: at least 99%
of live points must have the same neighbour set, and on those the
smoothed points agree within 2e-5 and normals within 2e-3 (the 6×6
solve amplifies rounding).  The boxes agree within 1e-4 (the covariance
is summed in another order, and the PCA axes move by that rounding over
the eigenvalue gap).  On a clean cylinder many hypotheses score within
f32 rounding of each other (the JAX package itself picks another one
jitted than op by op), so the cylinder is compared as geometry: the axis
up to its sign within 1e-3, the radius, every point's distance to the
axis and the axial extent within 1e-3, and the inliers up to points
within 2e-3 of the threshold.  The meshes are host numpy and agree
within 1e-6."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import jit_call, uniforms_from_jax
from test_pipeline_memory import _box_points, _cylinder_points

from mapping_private_tpu.core.cloud import PointCloud as JCloud
from mapping_private_tpu.fit import box as jbox
from mapping_private_tpu.fit import cylinder as jcyl
from mapping_private_tpu.ops import neighbors as jnb
from mapping_private_tpu_torch.core.cloud import PointCloud as TCloud
from mapping_private_tpu_torch.fit import box as tbox
from mapping_private_tpu_torch.fit import cylinder as tcyl
from mapping_private_tpu_torch.ops import neighbors as tnb

# the JAX package's ops/__init__ exports a function named ``mls``
jmls = importlib.import_module("mapping_private_tpu.ops.mls")
tmls = importlib.import_module("mapping_private_tpu_torch.ops.mls")


def _clouds(pts, dead_every=0):
    jc = JCloud.from_numpy(pts)
    if dead_every:
        jc = jc.select(jnp.arange(jc.capacity) % dead_every != 1)
    return jc, TCloud.from_arrays(np.asarray(jc.xyz), np.asarray(jc.mask), device="cpu")


def _same_neighbours(jc, tc, k):
    xj, xt = jc.padded_xyz(), tc.padded_xyz()
    ij = np.asarray(jit_call(jnb.knn_bruteforce, xj, xj, jc.mask, k=k)[0])
    it = tnb.knn_bruteforce(xt, xt, tc.mask, k)[0].numpy()
    live = np.asarray(jc.mask)
    same = np.array([set(a) == set(b) for a, b in zip(ij, it)]) & live
    assert same.sum() >= 0.99 * live.sum()
    return same


@pytest.mark.parametrize("order, use_grid", [(2, False), (0, False), (2, True)])
def test_mls_matches(order, use_grid):
    jc, tc = _clouds(_cylinder_points(n=500), dead_every=9)
    kw = dict(search_radius=0.03, k=16, polynomial_order=order, use_grid=use_grid)
    jx, jn, jk = (np.asarray(a) for a in jit_call(jmls.mls_smooth, jc.padded_xyz(), jc.mask, **kw))
    tx, tn, tk = (a.numpy() for a in tmls.mls_smooth(tc.padded_xyz(), tc.mask, **kw))
    same = _same_neighbours(jc, tc, 16)
    np.testing.assert_allclose(tx[same], jx[same], rtol=0, atol=2e-5)
    np.testing.assert_allclose(tn[same], jn[same], rtol=0, atol=2e-3)
    np.testing.assert_allclose(tk[same], jk[same], rtol=0, atol=1e-4)
    dead = ~np.asarray(jc.mask)
    np.testing.assert_array_equal(tx[dead], np.asarray(jc.padded_xyz())[dead])


def test_mls_cloud_wrapper_matches():
    jc, tc = _clouds(_box_points(n=500))
    jout = jit_call(jmls.mls, jc, search_radius=0.02, k=16)
    tout = tmls.mls(tc, search_radius=0.02, k=16)
    same = _same_neighbours(jc, tc, 16)
    np.testing.assert_allclose(tout.xyz.numpy()[same], np.asarray(jout.xyz)[same], rtol=0, atol=2e-5)
    np.testing.assert_allclose(tout.channel("normal").numpy()[same], np.asarray(jout.channel("normal"))[same],
                               rtol=0, atol=2e-3)
    assert tout.channels.keys() == jout.channels.keys() == {"normal", "curvature"}


@pytest.mark.parametrize("fit", ["fit_box_zup", "fit_box_pca"])
def test_box_fits_match(fit):
    jc, tc = _clouds(_box_points(n=500, ext=(0.12, 0.05, 0.09)), dead_every=7)
    jb = jit_call(getattr(jbox, fit), jc.padded_xyz(), jc.mask)
    tb = getattr(tbox, fit)(tc.padded_xyz(), tc.mask)
    for f in ("center", "axes", "extents"):
        np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), rtol=0, atol=1e-4)
    jv, jt = jbox.box_mesh(jb.center, jb.axes, jb.extents)
    tv, tt = tbox.box_mesh(tb.center, tb.axes, tb.extents)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(sorted(tb.extents.numpy()), [0.05, 0.09, 0.12], atol=0.015)


@pytest.mark.parametrize("normal_weight", [0.1, 0.0])
def test_fit_cylinder_ransac_matches(normal_weight):
    jc, tc = _clouds(_cylinder_points(n=500, seed=4), dead_every=11)
    jc = jit_call(jmls.mls, jc, search_radius=0.02, k=16)
    nrm = np.asarray(jc.channel("normal"))
    xyz = np.asarray(jc.padded_xyz())
    key = jax.random.PRNGKey(3)
    (u,) = uniforms_from_jax(key, [(256, 2)])
    _, sub = jax.random.split(key)
    kw = dict(num_hypotheses=256, threshold=0.01, normal_weight=normal_weight, max_radius=0.5)
    jcy, ji = jit_call(jcyl.fit_cylinder_ransac, jnp.asarray(xyz), jnp.asarray(nrm), jc.mask, sub, **kw)
    tcy, ti = tcyl.fit_cylinder_ransac(torch.from_numpy(xyz), torch.from_numpy(nrm),
                                       torch.from_numpy(np.asarray(jc.mask)), u=torch.tensor(u), **kw)
    # the same cylinder, whichever near-equal hypothesis won and whichever
    # way its axis points
    ja, ta = np.asarray(jcy.axis), tcy.axis.numpy()
    assert np.linalg.norm(np.cross(ja, ta)) < 1e-3
    assert abs(float(tcy.radius) - float(jcy.radius)) < 1e-3
    live = np.asarray(jc.mask)
    d = np.asarray(jcyl.point_to_axis_distance(jnp.asarray(xyz), jcy.point, jcy.axis))
    td = tcyl.point_to_axis_distance(torch.from_numpy(xyz), tcy.point, tcy.axis).numpy()
    np.testing.assert_allclose(td[live], d[live], rtol=0, atol=1e-3)
    ends = lambda c, a: sorted(float(np.dot(np.asarray(c.point) + k * np.asarray(c.axis), ja))  # noqa: E731
                               for k in (float(c.k_min), float(c.k_max)))
    np.testing.assert_allclose(ends(tcy, ta), ends(jcy, ja), rtol=0, atol=1e-3)
    near = np.abs(np.abs(d - float(jcy.radius)) - 0.01) < 2e-3
    np.testing.assert_array_equal(ti.numpy()[~near], np.asarray(ji)[~near])
    assert abs(float(tcy.radius) - 0.04) < 0.01 and ti.sum() > 300

    jv, jt = jcyl.cylinder_mesh(np.asarray(jcy.point), np.asarray(jcy.axis), float(jcy.radius),
                                float(jcy.k_min), float(jcy.k_max))
    tv, tt = tcyl.cylinder_mesh(np.asarray(jcy.point), np.asarray(jcy.axis), float(jcy.radius),
                                float(jcy.k_min), float(jcy.k_max))
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tt, jt)
