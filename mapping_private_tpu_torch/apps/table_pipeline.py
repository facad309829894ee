"""Tabletop perception pipeline CLI — `dyn_obj_store/table_pipeline.launch`.

Counterpart of ``mapping_private_tpu/apps/table_pipeline.py``: the
reference's end-to-end chain on PCD files instead of ROS topics (SURVEY
§3.1): box filter → statistical denoise → table detection
(downsample/normals/z-gate/cluster/RANSAC/hull/objects) → TableMemory
update (matching, reconstruction, naming) → belief state out.  Runs on
``--device`` (default cuda); with no CUDA device it fails rather than run
on the CPU.  Its random draws come from one generator seeded with 0.
"""
from __future__ import annotations

import argparse
import json

import torch

from mapping_private_tpu_torch.utils.device import resolve_device


def run_pipeline(paths, box=None, checkpoint=None, resume=None, verbose=True, *,
                 device: torch.device | str):
    from mapping_private_tpu_torch.io.pcd import load_pcd
    from mapping_private_tpu_torch.models.table_detector import TableDetectorConfig, detect_table
    from mapping_private_tpu_torch.models.table_memory import TableMemory
    from mapping_private_tpu_torch.ops.filters import box_filter, remove_statistical_outliers

    mem = TableMemory.restore(resume, device=device) if resume else TableMemory(device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    cfg = TableDetectorConfig()
    for stamp, path in enumerate(paths):
        cloud = load_pcd(path, device=device)
        if box is not None:
            cloud = box_filter(cloud, box[:3], box[3:])
        cloud, valid = remove_statistical_outliers(cloud, k=20, alpha=2.0, min_nr_pts=100)
        if not bool(valid):
            if verbose:
                print(f"{path}: denoise output invalid, skipped")
            continue
        det, down = detect_table(cloud, gen, cfg)
        if not bool(det.found):
            if verbose:
                print(f"{path}: no table found")
            continue
        xyz = down.xyz.cpu().numpy()
        masks, sizes = det.object_masks.cpu().numpy(), det.object_sizes.cpu().numpy()
        clusters = [xyz[m] for m, s in zip(masks, sizes) if s > 0]
        hull_xy = xyz[det.table_inliers.cpu().numpy()][:, :2]
        height = float(det.table_min[2])
        tid = mem.update(hull_xy, height, clusters, stamp=float(stamp), generator=gen)
        if verbose:
            print(f"{path}: table {tid}, {len(clusters)} objects")
    if checkpoint:
        mem.checkpoint(checkpoint)
    return mem


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pcds", nargs="+")
    ap.add_argument("--box", nargs=6, type=float, default=None,
                    help="min_x min_y min_z max_x max_y max_z clip")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--dump-viz", default=None, metavar="DIR",
                    help="write the belief-state markers JSON (the analog "
                         "of TableMemory's PolygonalMap/PositionStringList "
                         "publications, table_memory.cpp:1222-1260)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mem = run_pipeline(args.pcds, args.box, args.checkpoint, args.resume,
                       verbose=not args.json, device=device)
    if args.dump_viz:
        import os

        from mapping_private_tpu_torch.io.viz import save_markers_json, table_memory_viz

        os.makedirs(args.dump_viz, exist_ok=True)
        mpath = os.path.join(args.dump_viz, "table_memory_markers.json")
        save_markers_json(mpath, table_memory_viz(mem))
        if not args.json:
            print(f"viz: {mpath}")
    print(json.dumps(mem.belief_state(), indent=None if args.json else 2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
