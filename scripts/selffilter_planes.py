#!/usr/bin/env python3
"""How phase 12's plane gate depends on the camera and the RANSAC band.

The Kinect quantises disparity to 1/8 px, so a far wall seen at an angle
is a staircase of flat steps, and the 1-point-plane hypotheses of
``realtime.segmentation.multi_plane_ransac`` take their normals from
``fast_normals_image`` on it.  For two set-ups of ``chip_smoke.py``'s
self-filter scene (phase 7's wall 3 m from the camera, and phase 12's
wall behind the table 1.3 m from it), this prints the share of each
true surface's pixels whose normal lies within 1 and 2 degrees, and then
the normal error of the plane that ``multi_plane_ransac`` returns for
each surface (the phase's 1,024 hypotheses and 6 planes, numpy uniforms
of several seeds) at inlier bands of 1, 2 and 3 cm.  Full VGA frame, the
robot cut as in phase 12.

    python3 scripts/selffilter_planes.py [--device cuda] [--seeds 4]

Run it from the repository root; it needs no kernel build.
"""
import argparse
import pathlib
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SETUPS = {  # name: (camera position, point looked at, the wall slab's centre x)
    "phase 7's wall (camera 3.1 m from it)": ((-1.7, 0.0, 1.55), (0.2, 0.0, 0.55), 1.42),
    "phase 12's set-up (camera 1.3 m from the table)": ((-1.0, 0.0, 1.6), (0.2, 0.0, 0.5), 0.67),
}


def frame(torch, cs, dev, camera, wall_x):
    """Phase 12's smoothed normals for one set-up: (points, normals, mask,
    analytic depth, face ids, camera pose, the three planes)."""
    from mapping_private_tpu_torch.realtime import depth as rd, render as rr, segmentation as rs, urdf

    h, w = cs.VGA_SHAPE
    f = cs.KINECT_F
    cam = cs.look_at(*camera)
    sv, st, planes = cs.selffilter_scene()
    sv = sv.copy()
    sv[:8, 0] += wall_x - 0.67  # the wall slab is the scene's first 8 vertices
    planes[0] = ("wall", (1.0, 0.0, 0.0), -(wall_x - 0.02))
    scene = rr.render_depth_mesh(torch.from_numpy(sv).to(dev), torch.from_numpy(st).to(dev), (h, w), fx=f, fy=f,
                                 pose=torch.from_numpy(cam.astype(np.float32)).to(dev)).cpu().numpy()
    ref, face = cs.raycast_f64((sv.astype(np.float64) @ cam[:3, :3].T + cam[:3, 3]).astype(np.float32), st, (h, w), f)
    with tempfile.TemporaryDirectory() as td:
        robot, _, _ = cs.selffilter_robot(td, cam)
        robot_d = urdf.render_robot_depth(robot, cam @ cs.root_pose(), (h, w), fx=f, fy=f,
                                          joint_values=cs.SF_JOINTS, device=dev)
    meas = torch.from_numpy(cs.measured_frame(robot_d, scene)[0]).to(dev)
    keep = rd.background_subtract(meas, torch.from_numpy(robot_d).to(dev), 0.05)
    pts, valid = rd.depth_to_cloud(rd.smooth_depth_image(torch.where(keep, meas, 0.0)), fx=f, fy=f)
    n = rs.fast_normals_image(pts, valid)
    mask = valid & (torch.linalg.vector_norm(n, dim=-1) > 0.5)
    return pts, n, mask, ref, face, cam, planes


def main():
    import torch

    import chip_smoke as cs
    from mapping_private_tpu_torch.realtime import segmentation as rs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    for name, (eye, target, wall_x) in SETUPS.items():
        pts, n, mask, ref, face, cam, planes = frame(torch, cs, dev, (eye, target), wall_x)
        n_np = n.reshape(-1, 3).cpu().numpy()
        ok = mask.reshape(-1).cpu().numpy()
        print(f"== {name}: camera {eye} looking at {target}, wall front face at x = {wall_x - 0.02:.2f}")
        for si, (surf, n_w, _) in enumerate(planes):
            n_cam = cam[:3, :3] @ np.asarray(n_w)
            on = (face.reshape(-1) // 6 == si) & ok
            ang = np.degrees(np.arccos(np.clip(np.abs(n_np[on] @ n_cam), 0.0, 1.0)))
            print(f"  {surf}: {on.mean():.3f} of the pixels; normals within 1 deg {np.mean(ang < 1):.4f}, "
                  f"within 2 deg {np.mean(ang < 2):.4f}, median {np.median(ang):.2f} deg")
        for band in (0.01, 0.02, 0.03):
            for seed in range(args.seeds):
                u = torch.from_numpy(np.random.default_rng(seed).random((cs.SF_PLANES, cs.SF_HYPOTHESES),
                                                                        dtype=np.float32)).to(dev)
                pl, lab, cnt = rs.multi_plane_ransac(pts.reshape(-1, 3), n.reshape(-1, 3), mask.reshape(-1), None,
                                                     num_hypotheses=cs.SF_HYPOTHESES, max_planes=cs.SF_PLANES,
                                                     threshold=band, u=u)
                found, lab = pl[: int(cnt)].cpu().numpy().astype(np.float64), lab.cpu().numpy()
                errs = []
                for si, (surf, n_w, _) in enumerate(planes):
                    n_cam = cam[:3, :3] @ np.asarray(n_w)
                    on = face.reshape(-1) // 6 == si
                    cands = [np.degrees(np.arccos(min(abs(p[:3] @ n_cam) / np.linalg.norm(p[:3]), 1.0)))
                             for k, p in enumerate(found) if ((lab == k) & on).sum() >= 100]
                    errs.append(f"{surf} {min(cands):.2f}" if cands else f"{surf} none")
                print(f"  band {band} m, seed {seed}: {int(cnt)} planes; normal error deg: {', '.join(errs)}")


if __name__ == "__main__":
    main()
