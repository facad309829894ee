"""Hough segmentation CLI — `hough_segmentation sequential_hough`.

Counterpart of ``mapping_private_tpu/apps/hough_segment.py``.  Per input
PCD: optional denoise, sequential cuboid/cylinder extraction with
parameter-space voting (or, with ``--by-voting``, cluster-first voting
and the cylinder-sizes table), size classification; optionally dumps
each segment as object-<class>_<n>.pcd like the reference (:3811-3826),
the marked cloud and viewer files.  Runs on ``--device`` (default cuda);
with no CUDA device it fails rather than run on the CPU.  One generator
seeded with 0 draws for every file in turn.

    python -m mapping_private_tpu_torch.apps.hough_segment scene.pcd --json \\
        --marked marked.pcd --by-voting --sizes-out sizes.txt
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from mapping_private_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pcds", nargs="+")
    ap.add_argument("--max-objects", type=int, default=5)
    ap.add_argument("--min-inliers", type=int, default=80)
    ap.add_argument("--line-threshold", type=float, default=0.01)
    ap.add_argument("--circle-threshold", type=float, default=0.01)
    ap.add_argument("--denoise", action="store_true")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--dump-viz", default=None, metavar="DIR",
                    help="write colored PLY + JSON markers per input (the RViz-marker analog, io/viz.py)")
    ap.add_argument("--marked", default=None, metavar="PCD",
                    help="write the hough_classification-style marked cloud (per-point class intensity)")
    ap.add_argument("--by-voting", action="store_true",
                    help="cluster-first per-object voting (segmentation_by_voting.cpp) instead of "
                         "sequential extraction")
    ap.add_argument("--sizes-out", default=None, metavar="TXT",
                    help="with --by-voting: write the cylinder-sizes table (the reference's "
                         "cylinder-sizes-hough-ransac.txt)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from mapping_private_tpu_torch.io.pcd import load_pcd, save_pcd
    from mapping_private_tpu_torch.models.hough_segmentation import (
        HoughConfig, VotingConfig, cylinder_sizes_text, hough_mark_classes, hough_segment, segment_by_voting,
    )
    from mapping_private_tpu_torch.ops.filters import remove_statistical_outliers

    cfg = HoughConfig(max_objects=args.max_objects, min_inliers=args.min_inliers,
                      line_threshold=args.line_threshold, circle_threshold=args.circle_threshold)
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    counters: dict = {}
    for path in args.pcds:
        cloud = load_pcd(path, device=device)
        if args.denoise:
            cloud, _ = remove_statistical_outliers(cloud, k=20, alpha=2.0)
        if args.by_voting:
            vcfg = VotingConfig(line_threshold=args.line_threshold, circle_threshold=args.circle_threshold)
            segs, sizes = segment_by_voting(cloud, gen, vcfg)
            if args.sizes_out:
                with open(args.sizes_out, "w") as f:
                    f.write(cylinder_sizes_text(sizes))
                if not args.json:
                    print(f"sizes table: {args.sizes_out}")
        else:
            segs = hough_segment(cloud, gen, cfg)
        out = []
        xyz = cloud.xyz.cpu().numpy()
        for s in segs:
            rec = dict(kind=s.kind, size_class=s.size_class, num_inliers=s.num_inliers, votes=s.votes)
            if s.box is not None:
                rec["box"] = dict(center=np.asarray(s.box.center).tolist(), extents=np.asarray(s.box.extents).tolist())
            if s.cylinder is not None:
                c, r, zmin, zmax = s.cylinder
                rec["cylinder"] = dict(center=np.asarray(c).tolist(), radius=r, z_min=zmin, z_max=zmax)
            out.append(rec)
            if args.out_dir:
                os.makedirs(args.out_dir, exist_ok=True)
                n = counters.get(s.size_class, 0) + 1
                counters[s.size_class] = n
                save_pcd(os.path.join(args.out_dir, f"object-{s.size_class}_{n:02d}.pcd"), {"xyz": xyz[s.inliers]})
        if args.marked:
            marks = hough_mark_classes(cloud, segs)
            live = cloud.mask.cpu().numpy()
            save_pcd(args.marked, {"xyz": cloud.padded_xyz().cpu().numpy()[live],
                                   "intensity": marks[live].astype(np.float32)})
            if not args.json:
                print(f"marked cloud: {args.marked}")
        if args.dump_viz:
            from mapping_private_tpu_torch.io.viz import dump_viz, hough_segments_viz

            vx, vc, mk = hough_segments_viz(cloud, segs)
            stem = os.path.splitext(os.path.basename(path))[0]
            paths = dump_viz(args.dump_viz, stem, vx, vc, mk)
            if not args.json:
                print(f"viz: {paths['ply']} {paths['markers']}")
        results[path] = out
        if not args.json:
            print(f"{path}: {len(segs)} segments")
            for rec in out:
                print(" ", rec)
    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
