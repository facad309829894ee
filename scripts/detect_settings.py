#!/usr/bin/env python3
"""Sweep the detection settings of chip_smoke.py's phase 9 on the card.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/detect_settings.py [--seed 0]

The scene is phase 9's: phase 7's 307,200-point tabletop frame coloured
by surface, the scene PCA learned on two frames of other seeds, box 1's
object subspace on five views of it (two turned 90 degrees about z), all
at the detect_object CLI's 1 cm voxels and 4 cm blocks, with the
thresholds that learn-threshold finds on the frame.  For each --ranges
(box 1's size rounded up to 4 cm blocks, and the number of the scene's
4 cm blocks its points span), each --dim-model (1, 2, 5), each
--exist-threshold (the CLI's default of 10, and 0.5, 0.65, 0.8 of box 1's
occupied voxels) and with and without the scene PCA, one line: whether
the top box holds box 1's centroid, and the ranked scores.  The last line
is one JSON object {"card": ..., "settings": N, "top box holds the
centroid": n}.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    import chip_smoke as cs
    from mapping_private_tpu_torch.apps import detect_object as D
    from mapping_private_tpu_torch.io.pcd import save_pcd

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("detect_settings: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    seed = args.seed
    n_settings = n_inside = 0
    with tempfile.TemporaryDirectory() as td:
        scene, truth, lab = cs.coloured_frame(seed)
        save_pcd(f"{td}/scene.pcd", scene)
        for k in (1, 2):
            save_pcd(f"{td}/env{k}.pcd", cs.coloured_frame(seed + k)[0])
        views = [f"{td}/view{k}.pcd" for k in range(5)]
        for k, path in enumerate(views):
            save_pcd(path, cs.box_view(seed + 10 + k, turn=k >= 3))
        span, _, voxels = cs.detect_settings(scene, lab, views, dev)
        size = [int(np.ceil(round(v / (cs.DETECT_BLOCK * 0.01), 6))) for v in cs.TABLE_OBJECTS[0][3]]
        centroid = np.asarray(truth[0][1])
        thr = f"{td}/color_threshold.txt"
        D.learn_threshold([f"{td}/scene.pcd"], thr, device=dev)
        D.learn_scene([f"{td}/env1.pcd", f"{td}/env2.pcd"], f"{td}/scene.pca", cs.DETECT_BLOCK, 50, thr, device=dev)
        print(f"box 1: size in blocks {size}, span in the scene's blocks {span}, views' occupied voxels {voxels}",
              flush=True)
        for ranges in (size, span):
            for dim_model in (1, 2, 5):
                D.learn_object(views, f"{td}/obj.pca", dim_model, thr, device=dev)
                for frac in (0.0, 0.5, 0.65, 0.8):
                    exist = max(10.0, frac * float(np.median(voxels)))
                    for scene_pca in (None, f"{td}/scene.pca"):
                        dets = D.detect(f"{td}/scene.pcd", f"{td}/obj.pca", ranges, cs.DETECT_BLOCK, 50, dim_model,
                                        scene_pca, 5, exist, thr, device=dev)
                        inside = bool(dets) and bool(np.all(np.asarray(dets[0]["box_min"]) <= centroid)
                                                     and np.all(centroid <= np.asarray(dets[0]["box_max"])))
                        n_settings += 1
                        n_inside += inside
                        print(f"ranges {ranges} dim_model {dim_model} exist {exist:.1f} scene PCA "
                              f"{scene_pca is not None}: {len(dets)} boxes, top holds the centroid: {inside}; "
                              f"scores {[round(d['score'], 7) for d in dets]}", flush=True)
    print(json.dumps({"card": card, "settings": n_settings, "top box holds the centroid": n_inside}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
