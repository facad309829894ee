"""Object-classification benchmark CLI — ``color_feature_classification``.

Counterpart of ``mapping_private_tpu/apps/classify.py``: in place of the
reference's computeFeature / computeSubspace_from_file /
test_classify_from_file executables and the calcRate.sh scripts, compute
per-view features over a corpus (one ``obj*`` directory of PCD views per
object), train one PCA subspace per object, classify every view by its
largest subspace projection and report the rates.

Feature types (test/computeFeature.cpp:40-160):
  c → ColorCHLAC-981 (rotation-variant)
  d → GRSD-20 ++ ColorCHLAC-981 (1001)
  g → GRSD-20
  r → GRSD-20 ++ ColorCHLAC-117 (137, rotation-invariant)

Runs on ``--device`` (default cuda); with no CUDA device it fails rather
than run on the CPU.  ``--data-dir`` has no default (the JAX CLI's is
where its reference corpus was unpacked).

    python -m mapping_private_tpu_torch.apps.classify rate --data-dir corpus \\
        --feature r --leave-one-out --json
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.utils.device import resolve_device

def compute_feature(path: str, feature_type: str = "d", *, device: torch.device | str) -> np.ndarray:
    from mapping_private_tpu_torch.classify.evaluate import compute_feature as _compute

    return _compute(path, feature_type, device=device)


def corpus_views(data_dir: str, objects: Optional[Sequence[str]] = None, max_views: int = 0
                 ) -> Dict[str, List[str]]:
    dirs = sorted(d for d in os.listdir(data_dir) if d.startswith("obj"))
    if objects:
        dirs = [d for d in dirs if d in set(objects)]
    out = {}
    for d in dirs:
        views = sorted(glob.glob(os.path.join(data_dir, d, "*.pcd")))
        if max_views:
            views = views[:max_views]
        out[d] = views
    return out


def classification_rate(
    data_dir: str,
    feature_type: str = "d",
    dim_subspace: int = 5,
    objects: Optional[Sequence[str]] = None,
    max_views: int = 0,
    leave_one_out: bool = False,
    verbose: bool = False,
    *,
    device: torch.device | str,
) -> Tuple[float, Dict[str, float]]:
    """Train per-object subspaces and classify every view on ``device``.

    Returns (overall rate, per-object rates).  leave_one_out leaves the
    query view out of its class's training set (2.leave_one_out.sh)."""
    from mapping_private_tpu_torch.classify import classify_subspace, train_subspaces

    views = corpus_views(data_dir, objects, max_views)
    names = sorted(views)
    feats = {n: np.stack([compute_feature(p, feature_type, device=device) for p in views[n]]) for n in names}
    per_obj: Dict[str, float] = {}
    correct_total = count_total = 0
    if not leave_one_out:
        clf = train_subspaces([feats[n] for n in names], dim_subspace, device=device)
        for ci, n in enumerate(names):
            pred, _ = classify_subspace(clf, torch.as_tensor(feats[n], device=device))
            ok = int((pred.cpu().numpy() == ci).sum())
            per_obj[n] = ok / len(feats[n])
            correct_total += ok
            count_total += len(feats[n])
    else:
        for ci, n in enumerate(names):
            ok = 0
            for vi in range(len(feats[n])):
                train = [np.delete(feats[m], vi, axis=0) if m == n else feats[m] for m in names]
                clf = train_subspaces(train, dim_subspace, device=device)
                pred, _ = classify_subspace(clf, torch.as_tensor(feats[n][vi:vi + 1], device=device))
                ok += int(pred.cpu().numpy()[0] == ci)
            per_obj[n] = ok / len(feats[n])
            correct_total += ok
            count_total += len(feats[n])
    rate = correct_total / max(count_total, 1)
    if verbose:
        for n in names:
            print(f"{n}: {per_obj[n] * 100:.1f}%")
        print(f"overall: {rate * 100:.2f}% ({correct_total}/{count_total})")
    return rate, per_obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("command", choices=["rate"])
    ap.add_argument("--data-dir", required=True, help="the corpus: one obj* directory of PCD views per object")
    ap.add_argument("--feature", default="d", choices=list("cdgr"))
    ap.add_argument("--dim", type=int, default=5)
    ap.add_argument("--objects", nargs="*", default=None)
    ap.add_argument("--max-views", type=int, default=0)
    ap.add_argument("--leave-one-out", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rate, per_obj = classification_rate(
        args.data_dir, args.feature, args.dim, args.objects, args.max_views, args.leave_one_out,
        verbose=not args.json, device=device,
    )
    if args.json:
        print(json.dumps({"rate": rate, "per_object": per_obj}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
