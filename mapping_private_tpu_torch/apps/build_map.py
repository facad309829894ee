"""Incremental mapping CLI — scan-to-map SLAM over a PCD sequence.

Counterpart of ``mapping_private_tpu/apps/build_map.py``: each scan
registers against the accumulated voxel map
(registration/scan_to_map.py), keyframes enter a pose graph, an optional
final relaxation distributes loop error, and the map + trajectory are
written out.  Runs on ``--device`` (default cuda); with no CUDA device it
fails rather than run on the CPU.
"""
from __future__ import annotations

import argparse
import json

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pcds", nargs="+")
    ap.add_argument("--map-voxel", type=float, default=0.02)
    ap.add_argument("--map-capacity", type=int, default=65536)
    ap.add_argument("--icp-iters", type=int, default=10)
    ap.add_argument("--keyframe-trans", type=float, default=0.10)
    ap.add_argument("--out-map", default=None, help="write the voxel map PCD")
    ap.add_argument("--relax", action="store_true",
                    help="pose-graph relaxation at the end")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")

    from mapping_private_tpu_torch.io.pcd import load_pcd, save_pcd
    from mapping_private_tpu_torch.ops.normals import estimate_normals
    from mapping_private_tpu_torch.registration.scan_to_map import (
        ScanToMapTracker, TrackerConfig,
    )

    cfg = TrackerConfig(
        map_capacity=args.map_capacity, map_voxel=args.map_voxel,
        icp_iters=args.icp_iters, keyframe_trans=args.keyframe_trans,
    )
    tracker = ScanToMapTracker(cfg, device=device)
    trajectory = []
    for path in args.pcds:
        cloud = load_pcd(path, capacity_bucket=2048, device=device)
        cloud = estimate_normals(cloud, k=12)
        pose, kf = tracker.track(
            cloud.padded_xyz(), cloud.channel("normal"), cloud.mask
        )
        trajectory.append(pose.cpu().numpy())
        if not args.json:
            t = trajectory[-1][:3, 3]
            print(f"{path}: t=({t[0]:+.4f},{t[1]:+.4f},{t[2]:+.4f})"
                  f"{' [keyframe]' if kf else ''}")
    if args.relax:
        tracker.relax()
    if args.out_map and tracker.map is not None:
        m = tracker.map.mask.cpu().numpy()
        save_pcd(args.out_map, {"xyz": tracker.map.xyz.cpu().numpy()[m]})
    out = dict(
        trajectory=[p.tolist() for p in trajectory],
        keyframes=len(tracker.keyframe_poses),
        map_points=int(tracker.map.count()) if tracker.map is not None else 0,
    )
    if args.json:
        print(json.dumps(out))
    else:
        print(f"keyframes={out['keyframes']} map_points={out['map_points']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
