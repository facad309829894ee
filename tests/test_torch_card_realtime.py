"""Card tests of the realtime layer (marked ``cuda``; skipped without a
GPU).  Run on a machine with an NVIDIA GPU from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card_realtime.py

(``--noconftest``: tests/conftest.py imports jax; nothing here does.)

On phase 12's scene and robot at a quarter of the VGA frame (160 × 120,
fx = fy = 131.25), the card against the port on the CPU with the same
inputs: the scene's and the robot's depth images equal (the same f32
operations, one kernel each, no fused multiply-adds across them), the
smoothed depth within 1e-6 relative, the planes of ``multi_plane_ransac`` within 1e-4
with labels equal on ≥ 99.9% of rows (the distance matmuls may round
differently, flipping a row on the band), the segments equal on ≥ 99.9%
of pixels, and the ray/box ids and depths equal."""
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke
from mapping_private_tpu_torch.realtime import depth as rd, render as rr, segmentation as rs, urdf

SHAPE, F = (120, 160), 131.25


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def frame(dev):
    cam = chip_smoke.look_at(*chip_smoke.SF_CAMERA)
    sv, st, _ = chip_smoke.selffilter_scene()
    scene = rr.render_depth_mesh(torch.from_numpy(sv).to(dev), torch.from_numpy(st).to(dev), SHAPE, fx=F, fy=F,
                                 pose=torch.from_numpy(cam.astype(np.float32)).to(dev))
    with tempfile.TemporaryDirectory() as td:
        robot, cam_root, _ = chip_smoke.selffilter_robot(td, cam)
        robot_d = urdf.render_robot_depth(robot, cam_root, SHAPE, fx=F, fy=F, joint_values=chip_smoke.SF_JOINTS,
                                          device=dev)
    return scene.cpu().numpy(), robot_d


@pytest.mark.cuda
def test_self_filter_path_card_matches_cpu(cuda_device):
    cpu = torch.device("cpu")
    (scene_g, robot_g), (scene_c, robot_c) = frame(cuda_device), frame(cpu)
    np.testing.assert_array_equal(scene_g, scene_c)
    np.testing.assert_array_equal(robot_g, robot_c)
    meas, seen = chip_smoke.measured_frame(robot_c, scene_c)
    keep = rd.background_subtract(torch.from_numpy(meas), torch.from_numpy(robot_c), 0.05)
    assert not keep.numpy()[seen].any()
    filt = torch.where(keep, torch.from_numpy(meas), 0.0)
    sm = rd.smooth_depth_image(filt.to(cuda_device))
    torch.testing.assert_close(sm.cpu(), rd.smooth_depth_image(filt), rtol=1e-6, atol=0)
    pts, valid = rd.depth_to_cloud(sm, fx=F, fy=F)
    n = rs.fast_normals_image(pts, valid)
    mask = valid & (torch.linalg.vector_norm(n, dim=-1) > 0.5)
    u = torch.from_numpy(np.random.default_rng(0).random((6, 256), dtype=np.float32))
    # the CPU runs on the card's points and normals: the same inputs
    outs = [[t.cpu() for t in (*rs.multi_plane_ransac(p.reshape(-1, 3), m.reshape(-1, 3), k.reshape(-1), None,
                                                       num_hypotheses=256, threshold=0.01, u=u.to(p.device)),
                               rs.segment_normal_image(m, k))]
            for p, m, k in ((pts, n, mask), (pts.cpu(), n.cpu(), mask.cpu()))]
    (pl_g, lab_g, c_g, seg_g), (pl_c, lab_c, c_c, seg_c) = outs
    assert int(c_g) == int(c_c) >= 3
    torch.testing.assert_close(pl_g, pl_c, rtol=0, atol=1e-4)
    assert float((lab_g == lab_c).float().mean()) >= 0.999
    assert float((seg_g == seg_c).float().mean()) >= 0.999


@pytest.mark.cuda
def test_boxlist_ray_intersection_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(1)
    lo = rng.uniform(-2, 2, (60, 3)).astype(np.float32)
    lo[:, 2] += 4
    hi = lo + rng.uniform(0.05, 1.0, (60, 3)).astype(np.float32)
    got = rr.boxlist_ray_intersection(torch.from_numpy(lo).to(cuda_device), torch.from_numpy(hi).to(cuda_device),
                                      np.zeros(3, np.float32), 525.0, 640, 480)
    want = rr.boxlist_ray_intersection(torch.from_numpy(lo), torch.from_numpy(hi), np.zeros(3, np.float32),
                                       525.0, 640, 480)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
