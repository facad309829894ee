"""Tabletop pick-and-place planning — `ias_pr2_pick_and_place_demos`.

Counterpart of ``mapping_private_tpu/apps/clean_table.py``.  The
reference's clean_table.py drives a mobile manipulator to detect the
table and bin every object on it; the perception and planning part is
reproduced here: each detected cluster gets a top-down grasp at its
centroid (gripper yaw across the object's thinner box axis, a pregrasp
standoff above), and the plan orders objects nearest first.  Runs on ``--device`` (default cuda); with
no CUDA device it fails rather than run on the CPU.  The detector draws
from a generator seeded with 0.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def grasp_pose_for_cluster(points: np.ndarray, standoff: float = 0.10, *,
                           device: torch.device | str) -> dict:
    """Top-down grasp: above the centroid, the gripper's yaw across the
    object's thinner footprint axis (so the fingers straddle it)."""
    from mapping_private_tpu_torch.core.cloud import PointCloud
    from mapping_private_tpu_torch.fit.box import fit_box_zup

    cloud = PointCloud.from_numpy(np.asarray(points, np.float32), device=device)
    box = fit_box_zup(cloud.padded_xyz(), cloud.mask)
    center, axes, ext = (t.cpu().numpy() for t in (box.center, box.axes, box.extents))
    minor = axes[int(np.argmin(ext[:2]))]
    yaw = float(np.arctan2(minor[1], minor[0]))
    top_z = center[2] + ext[2] / 2
    return dict(
        position=[float(center[0]), float(center[1]), float(top_z)],
        pregrasp=[float(center[0]), float(center[1]), float(top_z + standoff)],
        yaw=yaw,
        width=float(np.min(ext[:2])),
        extents=ext.tolist(),
    )


def plan_clean_table(pcd_path: str, bin_position=(0.0, -0.6, 0.5), *,
                     device: torch.device | str) -> dict:
    from mapping_private_tpu_torch.io.pcd import load_pcd
    from mapping_private_tpu_torch.models.table_detector import TableDetectorConfig, detect_table

    cloud = load_pcd(pcd_path, capacity_bucket=2048, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    det, down = detect_table(cloud, gen, TableDetectorConfig())
    if not bool(det.found):
        return dict(table_found=False, grasps=[])
    xyz = down.xyz.cpu().numpy()
    masks, sizes = det.object_masks.cpu().numpy(), det.object_sizes.cpu().numpy()
    grasps = []
    for oi in range(len(sizes)):
        if sizes[oi] <= 0:
            continue
        g = grasp_pose_for_cluster(xyz[masks[oi]], device=device)
        g["object"] = oi
        g["place"] = list(bin_position)
        grasps.append(g)
    # nearest-first execution order (the demo's pick ordering)
    grasps.sort(key=lambda g: np.hypot(g["position"][0], g["position"][1]))
    return dict(table_found=True, table_height=float(det.table_min[2]), grasps=grasps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pcd")
    ap.add_argument("--bin", nargs=3, type=float, default=[0.0, -0.6, 0.5])
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    print(json.dumps(plan_clean_table(args.pcd, tuple(args.bin), device=device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
