"""Room segmentation CLI — ``pointcloud_segmentation`` + ``wall_filter``.

Counterpart of ``mapping_private_tpu/apps/room_segment.py``: labels
floor, ceiling and walls in a room PCD and prints one JSON line (the
counts and the wall planes); optionally writes a labeled PCD with a
'segment' channel (the reference's PointSegmentation point type) and the
cloud with the walls removed (the wall_filter node's output).  Runs on
``--device`` (default cuda); with no CUDA device it fails rather than
run on the CPU.  The labels draw from a generator seeded with 0, the
wall filter from one seeded with 1.

    python -m mapping_private_tpu_torch.apps.room_segment room.pcd \\
        --out-labeled labeled.pcd --out-filtered nowalls.pcd
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mapping_private_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pcd")
    ap.add_argument("--z-floor", type=float, default=0.1)
    ap.add_argument("--z-ceiling", type=float, default=2.7)
    ap.add_argument("--max-walls", type=int, default=4)
    ap.add_argument("--out-labeled", default=None)
    ap.add_argument("--out-filtered", default=None, help="cloud with wall points removed (wall_filter)")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from mapping_private_tpu_torch.io.pcd import load_pcd, save_pcd
    from mapping_private_tpu_torch.models.room_segmentation import (
        RoomSegmentationConfig, segment_room, wall_filter,
    )

    cfg = RoomSegmentationConfig(z_floor=args.z_floor, z_ceiling=args.z_ceiling, max_walls=args.max_walls)
    cloud = load_pcd(args.pcd, capacity_bucket=2048, device=device)
    seg = segment_room(cloud, torch.Generator(device=device).manual_seed(0), cfg)
    lab = seg.labels.cpu().numpy()
    live = cloud.mask.cpu().numpy()
    counts = {
        "floor": int((lab[live] == 1).sum()),
        "ceiling": int((lab[live] == 2).sum()),
        "walls": int((lab[live] >= 3).sum()),
        "unlabeled": int((lab[live] == 0).sum()),
    }
    if args.out_labeled:
        xyz = cloud.xyz.cpu().numpy()[live]
        save_pcd(args.out_labeled, {"xyz": xyz, "segment": lab[live].astype(np.float32)})
    if args.out_filtered:
        filt = wall_filter(cloud, torch.Generator(device=device).manual_seed(1), cfg)
        save_pcd(args.out_filtered, {"xyz": filt.xyz.cpu().numpy()[filt.mask.cpu().numpy()]})
    print(json.dumps(dict(counts=counts, wall_planes=[p.cpu().numpy().tolist() for p in seg.wall_planes])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
