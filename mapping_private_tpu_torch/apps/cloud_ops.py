"""Batch PCD utility CLI — the hough workflows' cloud-preparation tools.

Counterpart of ``mapping_private_tpu/apps/cloud_ops.py``, itself the
counterpart of the reference's three batch utilities:
- ``rot_trans_scale.cpp:1-584`` — rigid transform (x y z roll pitch yaw)
  and multi-cloud merge over PCD lists (``--scale`` is an added
  convenience, NOT in the reference tool: points map to
  scale*R@x + t, i.e. the translation is applied after scaling);
- ``cloud_operations.cpp:1-220`` — the same transform core as a one-shot
  tool;
- ``process_clouds.cpp:1-829`` — pass-through band filters, statistical
  outlier removal, and xOy-plane projection used to prep scans for
  sequential_hough.

One CLI, a subcommand per operation, each mapping a list of input PCDs
through one vectorized transform on ``--device`` (the reference loops
per point; default cuda, and with no CUDA device it fails rather than
run on the CPU); ``concat`` only merges files on the host.  The
transform is taken in float64 as in the JAX package, the denoise is
``ops.filters.statistical_outlier_mask``:

  python -m mapping_private_tpu_torch.apps.cloud_ops transform --x .1 --yaw .5 \\
      --scale 2 --out-dir out/ in/*.pcd
  python -m mapping_private_tpu_torch.apps.cloud_ops crop --axis z --min 0.1 \\
      --max 1.2 --out-dir out/ in/*.pcd
  python -m mapping_private_tpu_torch.apps.cloud_ops denoise --mean-k 25 \\
      --std-mul 1.0 --out-dir out/ in/*.pcd
  python -m mapping_private_tpu_torch.apps.cloud_ops project --out-dir out/ \\
      in/*.pcd
  python -m mapping_private_tpu_torch.apps.cloud_ops concat --out merged.pcd \\
      in/*.pcd
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mapping_private_tpu_torch.utils.device import resolve_device


def _euler_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Z·Y·X Euler composition (the reference feeds r/p/y to
    pcl::getTransformation, which uses this order)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _out_path(out_dir: str, src_path: str, suffix: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(src_path))[0]
    return os.path.join(out_dir, f"{base}_{suffix}.pcd")


def _load(path):
    from mapping_private_tpu_torch.io.pcd import load_pcd_arrays

    a = load_pcd_arrays(path)
    xyz = np.stack([a["x"], a["y"], a["z"]], 1).astype(np.float32)
    extra = {k: v for k, v in a.items() if k not in ("x", "y", "z")}
    return xyz, extra


def _device(args) -> torch.device:
    return resolve_device(args.device)


def _save(path, xyz, extra):
    from mapping_private_tpu_torch.io.pcd import save_pcd

    save_pcd(path, {"xyz": xyz, **extra})


def cmd_transform(args) -> int:
    device = _device(args)
    R = torch.from_numpy(_euler_matrix(args.roll, args.pitch, args.yaw) * args.scale).to(device)
    t = torch.tensor([args.x, args.y, args.z], dtype=torch.float64, device=device)
    for p in args.pcds:
        xyz, extra = _load(p)
        x = torch.from_numpy(xyz).to(device, torch.float64)
        out = (x @ R.T + t).to(torch.float32).cpu().numpy()
        dst = _out_path(args.out_dir, p, "tf")
        _save(dst, out, extra)
        print(f"{p} -> {dst} ({len(out)} pts)")
    return 0


def cmd_crop(args) -> int:
    device = _device(args)
    ax = {"x": 0, "y": 1, "z": 2}[args.axis]
    for p in args.pcds:
        xyz, extra = _load(p)
        col = torch.from_numpy(xyz[:, ax].copy()).to(device)
        keep = ((col >= args.min) & (col <= args.max)).cpu().numpy()
        dst = _out_path(args.out_dir, p, f"crop_{args.axis}")
        _save(dst, xyz[keep], {k: v[keep] for k, v in extra.items()})
        print(f"{p} -> {dst} ({int(keep.sum())}/{len(xyz)} pts)")
    return 0


def cmd_denoise(args) -> int:
    from mapping_private_tpu_torch.ops.filters import statistical_outlier_mask

    device = _device(args)
    for p in args.pcds:
        xyz, extra = _load(p)
        keep = statistical_outlier_mask(
            torch.from_numpy(xyz).to(device), torch.ones((len(xyz),), dtype=torch.bool, device=device),
            k=args.mean_k, alpha=args.std_mul).cpu().numpy()
        dst = _out_path(args.out_dir, p, "denoised")
        _save(dst, xyz[keep], {k: v[keep] for k, v in extra.items()})
        print(f"{p} -> {dst} ({int(keep.sum())}/{len(xyz)} pts)")
    return 0


def cmd_project(args) -> int:
    # process_clouds' ProjectInliers onto the xOy plane (:479-486)
    device = _device(args)
    for p in args.pcds:
        xyz, extra = _load(p)
        out = torch.from_numpy(xyz).to(device)
        out = torch.cat([out[:, :2], torch.zeros_like(out[:, 2:])], dim=1).cpu().numpy()
        dst = _out_path(args.out_dir, p, "proj")
        _save(dst, out, extra)
        print(f"{p} -> {dst}")
    return 0


def cmd_concat(args) -> int:
    xs, extras = [], []
    keys = None
    for p in args.pcds:
        xyz, extra = _load(p)
        xs.append(xyz)
        extras.append(extra)
        keys = set(extra) if keys is None else keys & set(extra)
    xyz = np.concatenate(xs)
    merged = {k: np.concatenate([e[k] for e in extras]) for k in (keys or ())}
    _save(args.out, xyz, merged)
    print(f"{len(args.pcds)} clouds -> {args.out} ({len(xyz)} pts)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    tf = sub.add_parser("transform", help="rigid transform + scale")
    for f in ("x", "y", "z", "roll", "pitch", "yaw"):
        tf.add_argument(f"--{f}", type=float, default=0.0)
    tf.add_argument("--scale", type=float, default=1.0)
    tf.add_argument("--out-dir", default=".")
    tf.add_argument("pcds", nargs="+")
    tf.set_defaults(fn=cmd_transform)

    cr = sub.add_parser("crop", help="axis pass-through band")
    cr.add_argument("--axis", choices=("x", "y", "z"), default="z")
    cr.add_argument("--min", type=float, required=True)
    cr.add_argument("--max", type=float, required=True)
    cr.add_argument("--out-dir", default=".")
    cr.add_argument("pcds", nargs="+")
    cr.set_defaults(fn=cmd_crop)

    dn = sub.add_parser("denoise", help="statistical outlier removal")
    dn.add_argument("--mean-k", type=int, default=25)
    dn.add_argument("--std-mul", type=float, default=1.0)
    dn.add_argument("--out-dir", default=".")
    dn.add_argument("pcds", nargs="+")
    dn.set_defaults(fn=cmd_denoise)

    pj = sub.add_parser("project", help="project onto the xOy plane")
    pj.add_argument("--out-dir", default=".")
    pj.add_argument("pcds", nargs="+")
    pj.set_defaults(fn=cmd_project)

    cc = sub.add_parser("concat", help="merge clouds into one PCD")
    cc.add_argument("--out", required=True)
    cc.add_argument("pcds", nargs="+")
    cc.set_defaults(fn=cmd_concat)

    for p in (tf, cr, dn, pj):
        p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
