"""Hough-segmentation evaluation harness.

Counterpart of ``mapping_private_tpu/models/hough_eval.py``, host numpy
throughout (the reference's analysis/statistics executables:
``analyze_sequential_hough.cpp``, ``analyze_hough_classification.cpp``
and ``assemble_statistics_file.cpp``, which matches models by centroid
distance with per-shape thresholds, :47-48, and writes "match
found"/"match not found" per run, :416-430).

Segments are matched against GROUND-TRUTH object annotations by
centroid and aggregated, per scene and overall: object counts,
per-shape precision/recall, size-class confusion, centroid error,
dimension error, and multi-run repeatability.  ``to_markdown`` writes
the same report, byte for byte, as the JAX package's from the same
statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mapping_private_tpu_torch.models.hough_segmentation import HoughSegment

# the reference parses these as CLI thresholds
# (assemble_statistics_file.cpp:112-113); its readme recipes use values
# of a few cm — the defaults here
THRESHOLD_CENTROIDS_CUBOIDS = 0.10
THRESHOLD_CENTROIDS_CYLINDERS = 0.10

SIZE_CLASSES = ("flat", "short", "medium", "tall")


@dataclasses.dataclass
class GroundTruthObject:
    """One annotated object in a scene."""
    name: str
    kind: str  # 'cylinder' | 'cuboid'
    centroid: np.ndarray  # (3,) object centroid in scene frame
    size_class: str
    radius: Optional[float] = None  # cylinders
    extents: Optional[np.ndarray] = None  # cuboids, (3,) full widths
    height: Optional[float] = None
    point_range: Optional[Tuple[int, int]] = None  # [lo, hi) rows in scene


def segment_centroid(seg: HoughSegment) -> Optional[np.ndarray]:
    """3-D centroid of a segment's fitted model (the quantity the
    reference's statistics files record per model, c1 c2 c3)."""
    if seg.kind == "cylinder" and seg.cylinder is not None:
        center, _r, zmin, zmax = seg.cylinder
        c = np.asarray(center, np.float64)
        return np.array([c[0], c[1], 0.5 * (zmin + zmax)])
    if seg.box is not None:
        return np.asarray(seg.box.center, np.float64)
    return None


@dataclasses.dataclass
class MatchResult:
    gt: GroundTruthObject
    segment: Optional[HoughSegment]  # None → missed
    centroid_error: float = float("inf")
    kind_correct: bool = False
    size_class_correct: bool = False
    dimension_error: float = float("nan")


def _centroid_threshold(kind: str) -> float:
    return (THRESHOLD_CENTROIDS_CYLINDERS if kind == "cylinder"
            else THRESHOLD_CENTROIDS_CUBOIDS)


def match_scene(
    segments: Sequence[HoughSegment],
    gts: Sequence[GroundTruthObject],
) -> Tuple[List[MatchResult], List[HoughSegment]]:
    """Greedy nearest-centroid matching of segments to ground truth —
    each GT object takes the closest unclaimed segment within its
    shape's threshold (assemble_statistics_file.cpp:416 semantics, with
    GT objects in place of the other run's models).

    Returns (per-GT match results, unmatched segments = false positives).
    """
    seg_cents = [segment_centroid(s) for s in segments]
    claimed = [False] * len(segments)
    results: List[MatchResult] = []
    # match in order of best available distance so a single segment
    # cannot be stolen by a farther GT first
    pairs = []
    for gi, gt in enumerate(gts):
        for si, c in enumerate(seg_cents):
            if c is None:
                continue
            d = float(np.linalg.norm(c - gt.centroid))
            if d < _centroid_threshold(gt.kind):
                pairs.append((d, gi, si))
    pairs.sort()
    gt_match: Dict[int, int] = {}
    for d, gi, si in pairs:
        if gi in gt_match or claimed[si]:
            continue
        gt_match[gi] = si
        claimed[si] = True

    for gi, gt in enumerate(gts):
        if gi not in gt_match:
            results.append(MatchResult(gt=gt, segment=None))
            continue
        seg = segments[gt_match[gi]]
        cerr = float(np.linalg.norm(seg_cents[gt_match[gi]] - gt.centroid))
        kind_ok = seg.kind == gt.kind or (
            # the rest-of-points PCA 'box' counts as a cuboid detection
            gt.kind == "cuboid" and seg.kind == "box")
        dim_err = float("nan")
        if gt.kind == "cylinder" and seg.cylinder is not None \
                and gt.radius is not None:
            dim_err = abs(float(seg.cylinder[1]) - gt.radius)
        elif gt.extents is not None and seg.box is not None:
            dim_err = float(np.max(np.abs(
                np.sort(np.asarray(seg.box.extents))
                - np.sort(np.asarray(gt.extents)))))
        results.append(MatchResult(
            gt=gt, segment=seg, centroid_error=cerr, kind_correct=kind_ok,
            size_class_correct=(seg.size_class == gt.size_class),
            dimension_error=dim_err,
        ))
    false_pos = [s for s, c in zip(segments, claimed) if not c]
    return results, false_pos


@dataclasses.dataclass
class SceneStats:
    scene: str
    n_gt: int
    n_segments: int
    n_detected: int
    n_kind_correct: int
    n_size_correct: int
    n_false_pos: int
    centroid_errors: List[float]
    dimension_errors: List[float]
    confusion: Dict[str, Dict[str, int]]  # gt size class → seg size class
    per_object: Dict[str, bool]  # name → detected (kind-correct)


def evaluate_scene(
    scene: str,
    segments: Sequence[HoughSegment],
    gts: Sequence[GroundTruthObject],
) -> SceneStats:
    results, false_pos = match_scene(segments, gts)
    conf: Dict[str, Dict[str, int]] = {}
    cerrs, derrs = [], []
    per_object = {}
    for r in results:
        per_object[r.gt.name] = r.segment is not None and r.kind_correct
        if r.segment is None:
            continue
        conf.setdefault(r.gt.size_class, {})
        conf[r.gt.size_class][r.segment.size_class] = (
            conf[r.gt.size_class].get(r.segment.size_class, 0) + 1)
        cerrs.append(r.centroid_error)
        if np.isfinite(r.dimension_error):
            derrs.append(r.dimension_error)
    return SceneStats(
        scene=scene,
        n_gt=len(gts),
        n_segments=len(segments),
        n_detected=sum(r.segment is not None for r in results),
        n_kind_correct=sum(r.kind_correct for r in results),
        n_size_correct=sum(
            r.size_class_correct for r in results if r.segment is not None),
        n_false_pos=len(false_pos),
        centroid_errors=cerrs,
        dimension_errors=derrs,
        confusion=conf,
        per_object=per_object,
    )


def aggregate(stats: Sequence[SceneStats]) -> dict:
    """The assembled statistics table (assemble_statistics_file.cpp's
    output, as precision/recall instead of raw match lines)."""
    n_gt = sum(s.n_gt for s in stats)
    n_seg = sum(s.n_segments for s in stats)
    n_det = sum(s.n_detected for s in stats)
    n_kind = sum(s.n_kind_correct for s in stats)
    n_size = sum(s.n_size_correct for s in stats)
    n_fp = sum(s.n_false_pos for s in stats)
    cerrs = [e for s in stats for e in s.centroid_errors]
    derrs = [e for s in stats for e in s.dimension_errors]
    conf: Dict[str, Dict[str, int]] = {}
    for s in stats:
        for g, row in s.confusion.items():
            conf.setdefault(g, {})
            for p, n in row.items():
                conf[g][p] = conf[g].get(p, 0) + n
    return dict(
        scenes=len(stats),
        gt_objects=n_gt,
        segments=n_seg,
        detected=n_det,
        recall=round(n_det / max(n_gt, 1), 4),
        kind_recall=round(n_kind / max(n_gt, 1), 4),
        precision=round((n_seg - n_fp) / max(n_seg, 1), 4),
        size_class_accuracy=round(n_size / max(n_det, 1), 4),
        centroid_error_mean=round(float(np.mean(cerrs)), 4) if cerrs else None,
        centroid_error_max=round(float(np.max(cerrs)), 4) if cerrs else None,
        dimension_error_mean=(
            round(float(np.mean(derrs)), 4) if derrs else None),
        size_class_confusion=conf,
    )


def repeatability(
    run_fn: Callable[[int], Sequence[HoughSegment]],
    gts: Sequence[GroundTruthObject],
    runs: int = 3,
) -> Dict[str, float]:
    """The reference's per-run match table (assemble_statistics_file.cpp
    :394-430 loops runs and prints match found/not per model): fraction
    of runs in which each GT object was detected kind-correctly."""
    found: Dict[str, int] = {g.name: 0 for g in gts}
    for r in range(runs):
        segs = run_fn(r)
        results, _ = match_scene(segs, gts)
        for res in results:
            if res.segment is not None and res.kind_correct:
                found[res.gt.name] += 1
    return {k: v / runs for k, v in found.items()}


def to_markdown(agg: dict, stats: Sequence[SceneStats],
                repeat: Optional[Dict[str, Dict[str, float]]] = None) -> str:
    lines = [
        "# HOUGH_EVAL — segmentation quality harness",
        "",
        "Counterpart of `analyze_sequential_hough.cpp` + "
        "`assemble_statistics_file.cpp` (centroid-threshold matching, "
        "per-shape statistics), run against ground-truth annotations on "
        "the real-scan + synthetic scene suite.  Regenerate with "
        "`python scripts/run_hough_eval.py`.",
        "",
        "## Aggregate",
        "",
        "| metric | value |",
        "|---|---|",
    ]
    for k in ("scenes", "gt_objects", "segments", "detected", "recall",
              "kind_recall", "precision", "size_class_accuracy",
              "centroid_error_mean", "centroid_error_max",
              "dimension_error_mean"):
        lines.append(f"| {k} | {agg[k]} |")
    lines += ["", "## Size-class confusion (rows = ground truth)", ""]
    classes = [c for c in SIZE_CLASSES
               if c in agg["size_class_confusion"]
               or any(c in r for r in agg["size_class_confusion"].values())]
    lines.append("| gt \\ seg | " + " | ".join(classes) + " |")
    lines.append("|---|" + "---|" * len(classes))
    for g in classes:
        row = agg["size_class_confusion"].get(g, {})
        lines.append(
            f"| {g} | " + " | ".join(str(row.get(p, 0)) for p in classes)
            + " |")
    lines += ["", "## Per scene", "",
              "| scene | gt | segments | detected | kind ok | false pos | "
              "centroid err (mean) |", "|---|---|---|---|---|---|---|"]
    for s in stats:
        ce = (f"{np.mean(s.centroid_errors):.4f}"
              if s.centroid_errors else "—")
        lines.append(
            f"| {s.scene} | {s.n_gt} | {s.n_segments} | {s.n_detected} | "
            f"{s.n_kind_correct} | {s.n_false_pos} | {ce} |")
    if repeat:
        lines += ["", "## Repeatability (fraction of runs detected, "
                      "per object)", "", "| scene | object | rate |",
                  "|---|---|---|"]
        for scene, objs in repeat.items():
            for name, rate in objs.items():
                lines.append(f"| {scene} | {name} | {rate:.2f} |")
    lines.append("")
    return "\n".join(lines)
