#!/usr/bin/env python3
"""The JAX package's Hough segmentation on chip_smoke.py's phase-11 cloud.

Phase 11 of ``chip_smoke.py`` takes the points of the four objects of
its tabletop frame (``tabletop_frame(seed, labels=True)``, labels 1-4),
table-relative, and segments them with the port.  This script runs the
JAX package (on the CPU) on the same cloud, with the CLI's settings and
``PRNGKey(seed)``, matches the segments against the four true objects
(``hough_eval.match_scene``) and prints, for ``hough_segment`` and
``segment_by_voting``, how many objects were detected and how many of
them with the right kind: the counts phase 11 must reach.

    JAX_PLATFORMS=cpu python3 scripts/hough_reference_count.py [--seed 0]
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from mapping_private_tpu.core import PointCloud
    from mapping_private_tpu.models import hough_eval, hough_segmentation as hs

    xyz, gts = chip_smoke.hough_cloud(args.seed)
    truth = [hough_eval.GroundTruthObject(**g) for g in gts]
    cloud = PointCloud.from_numpy(xyz)
    key = jax.random.PRNGKey(args.seed)
    runs = {
        "hough_segment": hs.hough_segment(cloud, key, hs.HoughConfig(**chip_smoke.HOUGH_CFG)),
        "segment_by_voting": hs.segment_by_voting(cloud, key)[0],
    }
    out = {}
    for name, segs in runs.items():
        res, _ = hough_eval.match_scene(segs, truth)
        out[name] = dict(detected=sum(r.segment is not None for r in res),
                         kind_correct=sum(r.kind_correct for r in res),
                         segments=[(s.kind, s.num_inliers) for s in segs])
    print(json.dumps(dict(seed=args.seed, points=len(xyz), **out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
