"""Port parity: realtime/depth.py, render.py and segmentation.py against
the JAX package, on the same seeded numpy inputs at 48 × 64.

Tolerances, each stated where it is used:

- disparity conversions, unprojection, smoothing, the self-filter mask,
  ray/box casts and the lattice connected components: equal (the same f32
  operations; divisions by constants are by f32 tensors in the port, as
  JAX rounds them once);
- normals and the mean shift: 1e-6 absolute (unit vectors; XLA may fuse
  the cross product's multiply-adds);
- rasterised depth: hit masks equal and depth within 1e-5 relative
  (XLA fuses the edge functions' multiply-adds, the port does not, so
  the last bits differ); intensities within 1e-5 of the 255 range;
- multi-plane RANSAC with the JAX draws (``jax_ref.multi_plane_uniforms``):
  the same plane count, planes within 1e-5, labels equal on ≥ 99.9% of
  rows (a row within an ulp of the threshold can flip where the
  distance matmuls round differently).

Two behaviours are the JAX package's own and kept: the normals' and the
mean shift's neighbour shifts wrap around the image, and the connected
components stop after ``max_iters`` sweeps with a long component split.
One diverges and is shown: ``boxlist_ray_intersection`` with no boxes
raises in JAX and returns misses in the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import multi_plane_uniforms, one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.realtime import depth as jd, render as jr, segmentation as js
from mapping_private_tpu_torch.realtime import depth as td, render as tr, segmentation as ts

H, W = 48, 64
F = 60.0  # focal length (px) of the test camera


def t(a):
    return torch.from_numpy(np.array(a))


def scene_depth(seed=0, noise=0.0):
    """Three planes seen from the origin: a wall at z = 2 (left), a slanted
    wall (right) and a floor (bottom rows), with a hole of invalid pixels."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    x, y = (u - (W - 1) / 2) / F, (v - (H - 1) / 2) / F
    depth = np.where(u < W // 2, 2.0, 1.2 / np.maximum(0.3 + 0.5 * x, 1e-3))
    floor = 0.6 / np.maximum(y, 1e-6)  # the plane y = 0.6
    depth = np.where((y > 0) & (floor < depth), floor, depth)
    depth = depth + rng.normal(0, noise, depth.shape)
    depth[5:8, 10:13] = 0.0
    return depth.astype(np.float32)


def test_disparity_round_trip_matches():
    d = scene_depth(noise=0.003)
    for name in ("depth_to_disparity", "disparity_to_depth"):
        np.testing.assert_array_equal(getattr(td, name)(t(d)).numpy(), np.asarray(getattr(jd, name)(jnp.asarray(d))))
    disp = td.depth_to_disparity(t(d))
    assert td.BASELINE_FOCAL == 43.5 and float(disp[0, 0]) == np.float32(43.5) / np.float32(d[0, 0])


@pytest.mark.parametrize("dy,dx", [(-1, -1), (-1, 0), (0, 1), (1, 1), (1, -1), (0, 0)])
def test_shift2d_fills_as_jax(dy, dx):
    x = np.random.default_rng(1).normal(size=(6, 7)).astype(np.float32)
    np.testing.assert_array_equal(td._shift2d(t(x), dy, dx, -5.0).numpy(),
                                  np.asarray(jd._shift2d(jnp.asarray(x), dy, dx, -5.0)))


@pytest.mark.parametrize("iterations,tol", [(1, 1.0), (5, 1.0), (3, 0.25)])
def test_smooth_depth_image_matches(iterations, tol):
    d = scene_depth(noise=0.004)
    got = td.smooth_depth_image(t(d), iterations=iterations, disparity_tolerance=tol).numpy()
    want = np.asarray(jd.smooth_depth_image(jnp.asarray(d), iterations=iterations, disparity_tolerance=tol))
    np.testing.assert_array_equal(got, want)  # equal: the same f32 operations in the same order
    assert (got[d == 0] == 0).all()
    disp = 43.5 / d[d > 0].astype(np.float64)
    lo, hi = 43.5 / (disp + tol), 43.5 / np.maximum(disp - tol, 1e-3)
    assert ((got[d > 0] >= lo - 1e-5) & (got[d > 0] <= hi + 1e-5)).all()  # inside its clamp interval


def test_depth_to_cloud_and_background_subtract_match():
    d = scene_depth(noise=0.002)
    pt, vt = td.depth_to_cloud(t(d), fx=F, fy=F + 3, cx=30.5)
    pj, vj = jd.depth_to_cloud(jnp.asarray(d), fx=F, fy=F + 3, cx=30.5)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    rendered = np.zeros_like(d)
    rendered[4:30, 5:40] = 1.95  # the robot 5 cm in front of the wall at 2 m
    got = td.background_subtract(t(d), t(rendered), threshold=0.08).numpy()
    np.testing.assert_array_equal(got, np.asarray(jd.background_subtract(jnp.asarray(d), jnp.asarray(rendered), 0.08)))
    # cut: the wall within the threshold behind the robot; kept: the far
    # slanted wall behind it, pixels off the robot, invalid pixels
    assert not got[15, 8] and got[15, 36] and got[40, 8] and got[6, 11]


def random_mesh(seed, n_tri=300, z=3.0):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-1.2, 1.2, (n_tri, 1, 3)) + [0.0, 0.0, z]
    verts = (centres + rng.normal(0, 0.25, (n_tri, 3, 3))).reshape(-1, 3).astype(np.float32)
    verts[:3, 2] = 0.05  # one triangle behind the near plane
    return verts, np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)


def assert_depth_close(got, want):
    np.testing.assert_array_equal(got > 0, want > 0)  # the same hits
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("chunk", [64, 7, 1000])
def test_render_depth_mesh_matches(chunk):
    verts, tris = random_mesh(2)
    got = tr.render_depth_mesh(t(verts), t(tris), (H, W), fx=F, fy=F, chunk=chunk).numpy()
    want = np.asarray(jr.render_depth_mesh(verts, tris, (H, W), fx=F, fy=F, chunk=chunk))
    assert (want > 0).mean() > 0.3
    assert_depth_close(got, want)


def test_render_depth_mesh_with_pose_matches():
    verts, tris = random_mesh(3, n_tri=120, z=0.0)
    pose = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [0.1, -0.2, 3.0]
    got = tr.render_depth_mesh(t(verts), t(tris), (H, W), fx=F, fy=F, pose=t(pose)).numpy()
    want = np.asarray(jr.render_depth_mesh(verts, tris, (H, W), fx=F, fy=F, pose=jnp.asarray(pose)))
    assert (want > 0).mean() > 0.2
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)  # the pose matmul rounds its own way in each package


@pytest.mark.parametrize("chunk", [64, 1])
def test_render_intensity_ties_go_to_the_earlier_triangle(chunk):
    """Two copies of one triangle (exact depth ties) with different
    values: the first wins within a block (argmin) and across blocks
    (strict <), in both packages."""
    tri = np.array([[-1, -1, 2.0], [1, -1, 2.0], [0, 1.5, 2.5]], np.float32)
    verts = np.concatenate([tri, tri])
    tris = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    inten = np.array([10, 20, 30, 200, 200, 200], np.float32)
    got = tr.render_intensity_mesh(t(verts), t(tris), t(inten), (H, W), fx=F, fy=F, chunk=chunk).numpy()
    want = np.asarray(jr.render_intensity_mesh(verts, tris, inten, (H, W), fx=F, fy=F, chunk=chunk))
    hit = got > 0
    assert hit.sum() > 100 and got[hit].max() <= 30.0 + 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=255 * 1e-5)


def test_render_intensity_mesh_matches():
    verts, tris = random_mesh(4)
    inten = np.random.default_rng(5).uniform(0, 255, len(verts)).astype(np.float32)
    got = tr.render_intensity_mesh(t(verts), t(tris), t(inten), (H, W), fx=F, fy=F, background=7.0).numpy()
    want = np.asarray(jr.render_intensity_mesh(verts, tris, inten, (H, W), fx=F, fy=F, background=7.0))
    assert (want == 7.0).mean() < 0.7
    np.testing.assert_allclose(got, want, rtol=0, atol=255 * 1e-5)  # Gouraud sums: XLA fuses them


def boxes(seed, n=12):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    lo[:, 2] += 4
    lo[0] = [-0.5, -0.5, -0.5]  # the origin inside box 0
    hi = (lo + rng.uniform(0.2, 1.5, (n, 3))).astype(np.float32)
    lo[1], hi[1] = [0.0, -3.0, 3.0], [0.5, 3.0, 3.5]  # a slab plane through the origin (x = 0)
    lo[2], hi[2] = [-1.0, -1.0, -5.0], [1.0, 1.0, -4.0]  # wholly behind
    return lo, hi


def test_ray_box_tmin_matches():
    lo, hi = boxes(6)
    dirs = np.random.default_rng(7).normal(size=(500, 3)).astype(np.float32)
    dirs[:50, 0] = 0.0  # axis-parallel rays
    dirs[50:60, :2] = 0.0
    got = tr.ray_box_tmin(np.zeros(3, np.float32), t(dirs), t(lo), t(hi)).numpy()
    want = np.asarray(jr.ray_box_tmin(np.zeros(3, np.float32), jnp.asarray(dirs), lo, hi))
    np.testing.assert_array_equal(got, want)
    assert not np.isnan(got).any() and (got[:, 0] == 0).all()  # inside box 0: entry at 0
    assert np.isinf(got[dirs[:, 2] > 0, 2]).all() and np.isfinite(got[:, 2]).any()  # box 2 lies behind (−z)


def test_boxlist_ray_intersection_matches():
    lo, hi = boxes(8)
    origin = np.array([0.05, 0.02, 0.3], np.float32)
    it, dt = tr.boxlist_ray_intersection(t(lo[1:]), t(hi[1:]), origin, 50.0, W, H)
    ij, dj = jr.boxlist_ray_intersection(lo[1:], hi[1:], origin, 50.0, W, H)
    assert it.dtype == torch.int32 and it.shape == (H, W)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert 0.1 < (it.numpy() > 0).mean() < 1.0


def test_boxlist_ray_intersection_empty_list_diverges():
    """The documented divergence: JAX's argmin over an (R, 0) matrix
    raises; the port returns "miss everywhere" (ids 0, depth inf)."""
    empty = np.zeros((0, 3), np.float32)
    with pytest.raises(Exception):
        jr.boxlist_ray_intersection(empty, empty, np.zeros(3), 50.0, W, H)
    ids, depth = tr.boxlist_ray_intersection(t(empty), t(empty), np.zeros(3), 50.0, W, H)
    assert ids.shape == (H, W) and ids.dtype == torch.int32 and (ids == 0).all()
    assert depth.shape == (H, W) and torch.isinf(depth).all()


def organized(seed=0, noise=0.002):
    d = scene_depth(seed, noise)
    pj, vj = jd.depth_to_cloud(jnp.asarray(d), fx=F, fy=F)
    return np.asarray(pj), np.asarray(vj)


def test_fast_normals_image_matches_with_wrap_around():
    pts, valid = organized()
    got = ts.fast_normals_image(t(pts), t(valid)).numpy()
    want = np.asarray(js.fast_normals_image(jnp.asarray(pts), jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the border column's x neighbours wrap to the opposite border (kept, as in JAX)
    rolled = np.roll(pts, -1, 1)[:, -1] - np.roll(pts, 1, 1)[:, -1]
    np.testing.assert_allclose(rolled, pts[:, 0] - pts[:, -2])
    assert np.abs(got[:, -1]).sum() > 0


def planar_rows(seed=0):
    pts, valid = organized(seed)
    n = np.asarray(js.fast_normals_image(jnp.asarray(pts), jnp.asarray(valid)))
    ok = valid & (np.linalg.norm(n, axis=-1) > 0.5)
    return pts.reshape(-1, 3), n.reshape(-1, 3), ok.reshape(-1)


@pytest.mark.parametrize("seed,max_planes,thr,cov", [(0, 4, 0.02, 0.95), (1, 6, 0.05, 0.9), (2, 2, 0.02, 0.99)])
def test_multi_plane_ransac_matches_with_jax_draws(seed, max_planes, thr, cov):
    xyz, nrm, ok = planar_rows(seed)
    key = jax.random.PRNGKey(seed)
    hyp = 256
    pj, lj, cj = js.multi_plane_ransac(jnp.asarray(xyz), jnp.asarray(nrm), jnp.asarray(ok), key,
                                       num_hypotheses=hyp, max_planes=max_planes, threshold=thr, min_coverage=cov)
    u = multi_plane_uniforms(key, max_planes, hyp)
    pt, lt, ct = ts.multi_plane_ransac(t(xyz), t(nrm), t(ok), None, num_hypotheses=hyp, max_planes=max_planes,
                                       threshold=thr, min_coverage=cov, u=t(u))
    assert lt.dtype == torch.int32 and ct.dtype == torch.int32
    assert int(ct) == int(cj) >= 2
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    assert (lt.numpy() == np.asarray(lj)).mean() >= 0.999


def test_multi_plane_ransac_generator_finds_the_planes():
    xyz, nrm, ok = planar_rows(0)
    gen = torch.Generator().manual_seed(0)
    planes, labels, count = ts.multi_plane_ransac(t(xyz), t(nrm), t(ok), gen, num_hypotheses=256, max_planes=4,
                                                  threshold=0.02, min_coverage=0.95)
    assert int(count) >= 3  # wall, slanted wall, floor
    assert (labels.numpy()[ok] >= 0).mean() > 0.95


def snake(h=12, w=12):
    """A one-pixel path that winds through the whole image: its labels need
    about h·w sweeps to settle."""
    adj = np.zeros((h, w, 4), bool)
    for r in range(h):
        adj[r, :-1, 3] = adj[r, 1:, 2] = True  # each row connected left-right
        if r + 1 < h:
            c = w - 1 if r % 2 == 0 else 0  # down at alternating ends
            adj[r, c, 1] = adj[r + 1, c, 0] = True
    return adj


@pytest.mark.parametrize("max_iters", [3, 13, 256])
def test_connected_components_image_matches(max_iters):
    adj = snake()
    valid = np.ones(adj.shape[:2], bool)
    valid[11, 3] = False
    got = ts.connected_components_image(t(adj), t(valid), max_iters=max_iters).numpy()
    want = np.asarray(js.connected_components_image(jnp.asarray(adj), jnp.asarray(valid), max_iters=max_iters))
    np.testing.assert_array_equal(got, want)
    labels, sweeps = ts._components(t(adj), t(valid), max_iters)
    np.testing.assert_array_equal(labels.numpy(), got)
    assert sweeps <= max_iters
    if max_iters < 100:  # the cap leaves the snake split, in both packages
        assert len(np.unique(got[valid])) > 2


def test_connected_components_random_adjacency_matches():
    rng = np.random.default_rng(9)
    adj = rng.random((H, W, 4)) < 0.6
    valid = rng.random((H, W)) < 0.9
    got = ts.connected_components_image(t(adj), t(valid)).numpy()
    want = np.asarray(js.connected_components_image(jnp.asarray(adj), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == H * W).all()


def test_mean_shift_and_segment_normal_image_match():
    pts, valid = organized(3)
    n = np.asarray(js.fast_normals_image(jnp.asarray(pts), jnp.asarray(valid)))
    ok = valid & (np.linalg.norm(n, axis=-1) > 0.5)
    got = ts.mean_shift_normals(t(n), t(ok), 0.2).numpy()
    want = np.asarray(js.mean_shift_normals(jnp.asarray(n), jnp.asarray(ok), 0.2))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    seg_t = ts.segment_normal_image(t(n), t(ok), range_bandwidth=0.2).numpy()
    seg_j = np.asarray(js.segment_normal_image(jnp.asarray(n), jnp.asarray(ok), range_bandwidth=0.2))
    np.testing.assert_array_equal(seg_t, seg_j)
    assert len(np.unique(seg_t[seg_t < H * W])) >= 3
