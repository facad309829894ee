"""Pairwise/sequence scan registration CLI — `cloud_algos Registration`.

Registers consecutive PCDs with point-to-plane ICP and (for 3+ scans)
relaxes the chain with the pose-graph optimizer; prints per-pair
transforms and the final trajectory.  Runs on ``--device`` (default
cuda); with no CUDA device it fails rather than run on the CPU.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mapping_private_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pcds", nargs="+")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--max-corr-dist", type=float, default=0.25)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = ap.parse_args(argv)
    if len(args.pcds) < 2:
        ap.error("need at least two PCDs")
    device = resolve_device(args.device)

    from mapping_private_tpu_torch.io.pcd import load_pcd
    from mapping_private_tpu_torch.ops.normals import estimate_normals
    from mapping_private_tpu_torch.registration.icp import icp_point_to_plane
    from mapping_private_tpu_torch.registration.pose_graph import optimize_pose_graph

    clouds = [load_pcd(p, device=device) for p in args.pcds]
    transforms = []
    for k in range(len(clouds) - 1):
        src, tgt = clouds[k + 1], clouds[k]
        tgt_n = estimate_normals(tgt, k=12)
        res = icp_point_to_plane(
            src.padded_xyz(), src.mask,
            tgt.padded_xyz(), tgt.mask, tgt_n.channel("normal"),
            iters=args.iters, max_corr_dist=args.max_corr_dist,
        )
        transforms.append(res.transform.cpu().numpy())  # the one sync per pair
    poses = [np.eye(4, dtype=np.float32)]
    for T in transforms:
        poses.append(poses[-1] @ T)
    if len(clouds) > 2:
        edges = torch.tensor(
            [[k, k + 1] for k in range(len(clouds) - 1)], dtype=torch.int64, device=device
        )
        meas = torch.as_tensor(np.stack(transforms), device=device)
        relaxed, _ = optimize_pose_graph(
            torch.as_tensor(np.stack(poses), device=device), edges, meas, iters=5
        )
        poses = list(relaxed.cpu().numpy())
    out = {
        "pairwise": [T.tolist() for T in transforms],
        "trajectory": [np.asarray(p).tolist() for p in poses],
    }
    if args.json:
        print(json.dumps(out))
    else:
        for k, p in enumerate(poses):
            t = np.asarray(p)[:3, 3]
            print(f"scan {k}: t = ({t[0]:+.4f}, {t[1]:+.4f}, {t[2]:+.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
