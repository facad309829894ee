"""Port parity: registration/scan_to_map.py against the JAX package on
the synthetic world of tests/test_scan_to_map.py, same numpy scans
through both.

``integrate_scan`` is integer keys and two stable sorts: the maps must be
identical row by row.  The trackers run the same ICP (the JAX side with
``nn_backend="xla"``, the port with its exact argmin; both feed one GN):
poses within 1e-4, keyframe decisions and map sizes equal.  A checkpoint
written by the JAX tracker restores in the port (the ``.npz`` layout is
the state carried across the two packages) and the other way round."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_scan_to_map import _surface_scan

from mapping_private_tpu.core.se3 import se3_exp, se3_inverse
from mapping_private_tpu.registration import scan_to_map as js
from mapping_private_tpu_torch.registration import scan_to_map as ts


def _scan(k, n=1500, seed=0, step=0.06):
    xi = np.asarray([step * k, 0.01 * k, 0.0, 0.0, 0.0, 0.02 * k], np.float32)
    T = np.asarray(se3_exp(jnp.asarray(xi)))
    return tuple(np.asarray(a) for a in _surface_scan(T, n=n, seed=seed + k)), T


def _map_equal(mt: ts.VoxelMap, mj: js.VoxelMap):
    np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
    np.testing.assert_array_equal(mt.xyz.numpy(), np.asarray(mj.xyz))
    np.testing.assert_array_equal(mt.normals.numpy(), np.asarray(mj.normals))
    assert int(mt.count()) == int(mj.count())


@pytest.mark.parametrize("capacity,voxel", [(1024, 0.1), (64, 0.01), (4096, 0.02)])
def test_integrate_scan_matches_row_by_row(capacity, voxel):
    """Dedup, map-wins-ties, overflow (capacity 64) and negative cells."""
    rng = np.random.default_rng(0)
    mj = js.VoxelMap.empty(capacity, voxel)
    mt = ts.VoxelMap.empty(capacity, voxel, device="cpu")
    _map_equal(mt, mj)
    for k in range(3):
        pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
        nrm = rng.normal(size=(500, 3)).astype(np.float32)
        m = rng.uniform(size=500) > 0.1
        pts[~m] = 1e8
        if k == 2:  # re-insert the first scan's voxels: the map's rows win
            again = np.asarray(mj.xyz)[:min(200, capacity)] + np.float32(1e-4)
            pts[:len(again)] = again
        mj = js.integrate_scan(mj, jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(m))
        mt = ts.integrate_scan(mt, torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(m))
        _map_equal(mt, mj)
    assert int(mt.count()) <= capacity
    assert mt.to("cpu").xyz.shape == (capacity, 3)


def test_integrate_is_idempotent_and_bounded():
    pts = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (500, 3)).astype(np.float32))
    ones = torch.ones(500, dtype=torch.bool)
    vm = ts.integrate_scan(ts.VoxelMap.empty(1024, 0.1, device="cpu"), pts, torch.zeros_like(pts), ones)
    c1 = int(vm.count())
    assert 0 < c1 <= 500
    assert int(ts.integrate_scan(vm, pts, torch.zeros_like(pts), ones).count()) == c1


def _track_both(n_scans, cfg_kw, first=0, trackers=None):
    if trackers is None:
        tj = js.ScanToMapTracker(js.TrackerConfig(nn_backend="xla", **cfg_kw))
        tt = ts.ScanToMapTracker(ts.TrackerConfig(**cfg_kw), device="cpu")
    else:
        tj, tt = trackers
    out = []
    for k in range(first, first + n_scans):
        scan, T = _scan(k)
        pj, kj = tj.track(*[jnp.asarray(a) for a in scan])
        pt, kt = tt.track(*[torch.tensor(a) for a in scan])
        out.append((np.asarray(pj), pt.numpy(), kj, kt, T))
    return tj, tt, out


def test_tracker_trajectory_matches_jax():
    cfg = dict(map_capacity=8192, map_voxel=0.05, keyframe_trans=0.05, icp_iters=10)
    tj, tt, out = _track_both(5, cfg)
    for pj, pt, kj, kt, T in out:
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
        assert kj == kt
    assert np.linalg.norm(out[-1][1][:3, 3] - out[-1][4][:3, 3]) < 0.02  # tests/test_scan_to_map.py's bound
    assert len(tt.keyframe_poses) == len(tj.keyframe_poses) >= 2
    assert int(tt.map.count()) == int(tj.map.count()) > 1000
    assert [(i, j) for i, j, _ in tt.edges] == [(i, j) for i, j, _ in tj.edges]
    for (_, _, zt), (_, _, zj) in zip(tt.edges, tj.edges):
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-4)


def test_restore_from_jax_checkpoint_and_back(tmp_path):
    cfg = dict(map_capacity=4096, map_voxel=0.05, keyframe_trans=0.04, icp_iters=8)
    tj, tt, _ = _track_both(3, cfg)
    path = str(tmp_path / "jax_tracker.npz")
    tj.checkpoint(path)
    back = ts.ScanToMapTracker.restore(path, ts.TrackerConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(back.pose.numpy(), np.asarray(tj.pose))
    _map_equal(back.map, tj.map)
    assert len(back.keyframe_poses) == len(tj.keyframe_poses)
    assert [(i, j) for i, j, _ in back.edges] == [(i, j) for i, j, _ in tj.edges]
    assert back.pose.dtype == torch.float32 and back.map.mask.dtype == torch.bool
    # the restored port tracker goes on localizing, as the JAX one does
    _, _, out = _track_both(1, cfg, first=3, trackers=(tj, back))
    pj, pt, kj, kt, T = out[0]
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    assert kj == kt and np.linalg.norm(pt[:3, 3] - T[:3, 3]) < 0.02
    # the port's checkpoint has the same keys and restores in the JAX package
    path2 = str(tmp_path / "torch_tracker.npz")
    back.checkpoint(path2)
    with np.load(path) as a, np.load(path2) as b:
        assert set(a.files) == set(b.files)
    again = js.ScanToMapTracker.restore(path2, js.TrackerConfig(nn_backend="xla", **cfg))
    np.testing.assert_array_equal(np.asarray(again.pose), back.pose.numpy())
    _map_equal(back.map, again.map)


def test_checkpoint_before_first_scan(tmp_path):
    path = str(tmp_path / "empty.npz")
    ts.ScanToMapTracker(device="cpu").checkpoint(path)
    back = ts.ScanToMapTracker.restore(path, device="cpu")
    assert back.map is None and back.edges == [] and len(back.keyframe_poses) == 1


def test_relax_with_loop_closure_matches_jax():
    cfg = dict(map_capacity=4096, map_voxel=0.05, keyframe_trans=0.03, icp_iters=8)
    tj, tt, _ = _track_both(4, cfg)
    K = len(tt.keyframe_poses)
    assert K == len(tj.keyframe_poses) >= 3
    Z = np.asarray(se3_inverse(tj.keyframe_poses[0])) @ np.asarray(tj.keyframe_poses[-1])
    Z[0, 3] += 0.01  # a closure that disagrees with the odometry by 1 cm
    tj.add_loop_closure(0, K - 1, jnp.asarray(Z))
    tt.add_loop_closure(0, K - 1, torch.from_numpy(Z))
    rj, rt = np.asarray(tj.relax()), tt.relax().numpy()
    assert rt.shape == (K, 4, 4) and np.isfinite(rt).all()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tt.pose.numpy(), rt[-1])
    # nothing to relax: the keyframes come back unchanged
    fresh = ts.ScanToMapTracker(device="cpu")
    np.testing.assert_array_equal(fresh.relax().numpy(), np.eye(4, dtype=np.float32)[None])
