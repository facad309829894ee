"""Sliding-box object detection CLI — ``color_voxel_recognition detect_object``.

Counterpart of ``mapping_private_tpu/apps/detect_object.py``: the
reference's two-stage workflow (demos/SH/learn_env.sh + learn_obj.sh →
detect_object):

  learn-threshold  scene PCDs → RGB binarization thresholds
                   (color_threshold.txt, calc_scene_auto_threshold)
  learn-scene      PCDs → per-subdivision C3-HLAC features → scene PCA
                   compression axis
  learn-object     PCDs → whole-object features → object PCA subspace
  detect           scene PCD + object subspace (+ scene axis) → ranked
                   boxes, one JSON line
  variance-show    eigenvalues / contribution rates of a PCA file

The PCA files and color_threshold.txt are the reference's formats, so
either package (or the reference's tools) reads what the other writes.
Runs on ``--device`` (default cuda); with no CUDA device it fails rather
than run on the CPU.

    python -m mapping_private_tpu_torch.apps.detect_object detect scene.pcd \\
        --object-pca obj.pca --ranges 3 2 4 --block-size 4 --device cuda
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mapping_private_tpu_torch.utils.device import resolve_device

VOXEL_SIZE = 0.01


def _grid(cloud, dims=None):
    from mapping_private_tpu_torch.core.voxelgrid import voxelize

    xyz = cloud.to_numpy()["xyz"]
    mn = np.floor(xyz.min(0) / VOXEL_SIZE) * VOXEL_SIZE
    if dims is None:
        dims = tuple(
            (np.floor(xyz.max(0) / VOXEL_SIZE) - np.floor(xyz.min(0) / VOXEL_SIZE)).astype(int) + 1
        )
    grid = voxelize(cloud, VOXEL_SIZE, torch.tensor(mn, dtype=torch.float32), dims, channels=("r", "g", "b"))
    return grid, mn, dims


def _load(path, device):
    from mapping_private_tpu_torch.io.pcd import load_pcd

    return load_pcd(path, device=device)


def learn_threshold(pcds, out_path=None, *, device: torch.device | str):
    """Learn the scene's RGB binarization thresholds (the reference's
    calc_scene_auto_threshold tool); writes the ``r g b\\n``
    color_threshold.txt that Param::readColorThreshold reads
    (param.cpp:144-150)."""
    from mapping_private_tpu_torch.features import calc_scene_auto_threshold

    thr = calc_scene_auto_threshold(_grid(_load(p, device))[0] for p in pcds)
    if out_path:
        with open(out_path, "w") as fp:
            fp.write("%d %d %d\n" % thr)
    return thr


def read_color_threshold(path) -> tuple:
    """Read a color_threshold.txt written by learn_threshold or by the
    reference tool (param.cpp:144-150)."""
    with open(path) as fp:
        r, g, b = (int(v) for v in fp.read().split()[:3])
    for v in (r, g, b):
        if not 0 <= v <= 254:
            raise ValueError(f"invalid RGB threshold in {path}: {(r, g, b)}")
    return (r, g, b)


def _thresholds(color_threshold_path):
    if color_threshold_path is None:
        return (127, 127, 127)
    return read_color_threshold(color_threshold_path)


def learn_scene(pcds, out_path, block_size, dim, color_threshold=None, *, device: torch.device | str):
    from mapping_private_tpu_torch.features import colorchlac117_subdiv
    from mapping_private_tpu_torch.recognition import pca_fit, write_pca

    thr = _thresholds(color_threshold)
    feats = []
    for p in pcds:
        grid, _, _ = _grid(_load(p, device))
        f = colorchlac117_subdiv(grid, block_size, thresholds=thr)
        feats.append(f.reshape(-1, f.shape[-1]))
    allf = torch.cat(feats)
    allf = allf[torch.linalg.norm(allf, dim=1) > 1e-6]  # occupied subdivisions
    pca = pca_fit(allf)
    write_pca(out_path, pca)
    return pca


def learn_object(pcds, out_path, dim_model, color_threshold=None, *, device: torch.device | str):
    from mapping_private_tpu_torch.features import colorchlac117
    from mapping_private_tpu_torch.recognition import pca_fit, write_pca

    thr = _thresholds(color_threshold)
    feats = [colorchlac117(_grid(_load(p, device))[0], thresholds=thr) for p in pcds]
    pca = pca_fit(torch.stack(feats))
    write_pca(out_path, pca)
    return pca


def detect(scene_pcd, object_pca_path, ranges, block_size, dim, dim_model,
           scene_pca_path=None, rank_num=5, exist_threshold=10.0,
           color_threshold=None, *, device: torch.device | str):
    from mapping_private_tpu_torch.features import colorchlac117_subdiv, occupied_count_subdiv
    from mapping_private_tpu_torch.recognition import build_scene_data, read_pca, search_object, subspace_axis

    grid, origin, _ = _grid(_load(scene_pcd, device))
    sub = colorchlac117_subdiv(grid, block_size, thresholds=_thresholds(color_threshold))
    exist = occupied_count_subdiv(grid, block_size)
    scene_axis = None
    if scene_pca_path:
        scene_axis = subspace_axis(read_pca(scene_pca_path), dim)
    scene = build_scene_data(sub, exist, scene_axis=scene_axis)
    axis_q = subspace_axis(read_pca(object_pca_path), dim_model)
    if scene_axis is not None and axis_q.shape[1] != scene_axis.shape[0]:
        # an object subspace learned in the raw feature space, expressed in
        # the scene-compressed space (project the basis rows, renormalize)
        axis_q = axis_q @ scene_axis.T  # (dim_model, dim)
        norms = np.linalg.norm(axis_q, axis=1, keepdims=True)
        axis_q = axis_q / np.maximum(norms, 1e-12)
    dets = search_object(scene, axis_q, ranges, rank_num=rank_num, exist_threshold=exist_threshold)
    box = block_size * VOXEL_SIZE
    out = []
    for d in dets:
        world = origin + np.array([d.x, d.y, d.z]) * box
        out.append(dict(
            score=d.score, mode=d.mode,
            box_min=world.tolist(),
            box_max=(world + np.array([d.xrange, d.yrange, d.zrange]) * box).tolist(),
        ))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    on_device = argparse.ArgumentParser(add_help=False)
    on_device.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    sub = ap.add_subparsers(dest="command", required=True)

    lt = sub.add_parser("learn-threshold", parents=[on_device],
                        help="learn RGB binarization thresholds from scene PCDs "
                             "(calc_scene_auto_threshold counterpart)")
    lt.add_argument("pcds", nargs="+")
    lt.add_argument("--out", default=None, help="write color_threshold.txt here")

    ls = sub.add_parser("learn-scene", parents=[on_device])
    ls.add_argument("pcds", nargs="+")
    ls.add_argument("--out", required=True)
    ls.add_argument("--block-size", type=int, default=10)
    ls.add_argument("--dim", type=int, default=50)
    ls.add_argument("--color-threshold", default=None, help="color_threshold.txt from learn-threshold")

    lo = sub.add_parser("learn-object", parents=[on_device])
    lo.add_argument("pcds", nargs="+")
    lo.add_argument("--out", required=True)
    lo.add_argument("--dim-model", type=int, default=5)
    lo.add_argument("--color-threshold", default=None)

    de = sub.add_parser("detect", parents=[on_device])
    de.add_argument("scene")
    de.add_argument("--object-pca", required=True)
    de.add_argument("--scene-pca", default=None)
    de.add_argument("--ranges", nargs=3, type=int, required=True)
    de.add_argument("--block-size", type=int, default=10)
    de.add_argument("--dim", type=int, default=50)
    de.add_argument("--dim-model", type=int, default=5)
    de.add_argument("--rank", type=int, default=5)
    de.add_argument("--exist-threshold", type=float, default=10.0)
    de.add_argument("--color-threshold", default=None)

    vs = sub.add_parser("variance-show", help="subspace eigenvalue / contribution-rate inspection "
                                              "(variance_show counterpart)")
    vs.add_argument("pca")
    vs.add_argument("--dim", type=int, default=None)
    vs.add_argument("-d", "--contrib-dim", type=int, default=None)
    vs.add_argument("-c", "--contrib-rate", type=float, default=None)

    args = ap.parse_args(argv)
    if args.command == "variance-show":
        from mapping_private_tpu_torch.recognition import read_pca, variance_report

        out = variance_report(read_pca(args.pca), args.dim, args.contrib_dim, args.contrib_rate)
        if args.contrib_dim is not None:
            print(f"{out:f}")
        elif args.contrib_rate is not None:
            print(out)
        else:
            for v in out:
                print(f"{v:f}")
        return 0
    device = resolve_device(args.device)
    if args.command == "learn-threshold":
        thr = learn_threshold(args.pcds, args.out, device=device)
        print("threshold: %d %d %d" % thr)
    elif args.command == "learn-scene":
        learn_scene(args.pcds, args.out, args.block_size, args.dim, args.color_threshold, device=device)
        print(f"scene axis written to {args.out}")
    elif args.command == "learn-object":
        learn_object(args.pcds, args.out, args.dim_model, args.color_threshold, device=device)
        print(f"object subspace written to {args.out}")
    else:
        dets = detect(args.scene, args.object_pca, tuple(args.ranges), args.block_size, args.dim,
                      args.dim_model, args.scene_pca, args.rank, args.exist_threshold,
                      args.color_threshold, device=device)
        print(json.dumps(dets))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
