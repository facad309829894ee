"""Visualization plane — the RViz-marker analog.

Counterpart of ``mapping_private_tpu/io/viz.py`` (host numpy).  The
reference publishes RViz markers and coloured clouds
(``publish_model_rviz`` cloud_algos/src/cylinder_fit_algo.cpp:117-122,
``TableMemory``'s PolygonalMap + PositionStringList
dyn_obj_store/src/table_memory.cpp:1222-1260, the hough viewer shapes
sequential_hough.cpp:1675-1700); this module writes files any viewer
opens:

  - coloured PLY point clouds (``save_ply``), per-segment colours;
  - a marker list (``Marker``, ``save_markers_json``) with the primitive
    vocabulary of visualization_msgs::Marker (cube, cylinder, line-strip
    polygon, text) and its pose/scale/colour;
  - adapters from the result types (``hough_segments_viz``,
    ``table_detection_viz``, ``table_memory_viz``), which read tensors
    on any device through ``.cpu()``.

Apps expose it via --dump-viz DIR.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# distinct segment colors (RGB 0-255), cycled
PALETTE = np.array([
    [230, 60, 60], [60, 170, 230], [70, 200, 120], [240, 180, 50],
    [170, 110, 230], [240, 120, 180], [130, 220, 220], [250, 140, 70],
], np.uint8)


def _np(x) -> np.ndarray:
    """A host numpy copy of a tensor (any device) or array-like."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_ply(path: str, xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
             normals: Optional[np.ndarray] = None) -> None:
    """ASCII PLY with optional per-vertex uchar colors / float normals."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    cols = None if rgb is None else np.asarray(rgb, np.uint8)
    nrm = None if normals is None else np.asarray(normals, np.float32)
    with open(path, "w") as fp:
        fp.write("ply\nformat ascii 1.0\n")
        fp.write(f"element vertex {n}\n")
        fp.write("property float x\nproperty float y\nproperty float z\n")
        if nrm is not None:
            fp.write("property float nx\nproperty float ny\nproperty float nz\n")
        if cols is not None:
            fp.write("property uchar red\nproperty uchar green\n"
                     "property uchar blue\n")
        fp.write("end_header\n")
        for i in range(n):
            row = [f"{v:.6f}" for v in xyz[i]]
            if nrm is not None:
                row += [f"{v:.4f}" for v in nrm[i]]
            if cols is not None:
                row += [str(int(v)) for v in cols[i]]
            fp.write(" ".join(row) + "\n")


@dataclasses.dataclass
class Marker:
    """visualization_msgs::Marker analog (type, pose, scale, color)."""
    kind: str            # 'cube' | 'cylinder' | 'polygon' | 'text' | 'sphere'
    center: Tuple[float, float, float]
    scale: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # rotation matrix rows (identity if axis-aligned)
    axes: Optional[List[List[float]]] = None
    color: Tuple[int, int, int] = (255, 255, 255)
    label: str = ""
    points: Optional[List[List[float]]] = None  # polygon / line_strip


def save_markers_json(path: str, markers: Sequence[Marker]) -> None:
    with open(path, "w") as fp:
        json.dump([dataclasses.asdict(m) for m in markers], fp, indent=1)


def load_markers_json(path: str) -> List[Marker]:
    with open(path) as fp:
        return [Marker(**d) for d in json.load(fp)]


def _f3(v) -> Tuple[float, float, float]:
    a = _np(v).astype(np.float64).reshape(-1)
    return (float(a[0]), float(a[1]), float(a[2]))


def hough_segments_viz(cloud, segments) -> Tuple[np.ndarray, np.ndarray,
                                                 List[Marker]]:
    """(xyz, rgb, markers) for a hough_segment result — the analog of the
    sequential_hough viewer shapes (:1675-1700)."""
    xyz = _np(cloud.padded_xyz())
    mask = _np(cloud.mask)
    rgb = np.full((len(xyz), 3), 160, np.uint8)  # unclaimed = grey
    markers: List[Marker] = []
    for i, s in enumerate(segments):
        col = PALETTE[i % len(PALETTE)]
        rgb[s.inliers] = col
        if s.cylinder is not None:
            c, r, z0, z1 = s.cylinder
            cx, cy = float(_np(c)[0]), float(_np(c)[1])
            markers.append(Marker(
                kind="cylinder",
                center=(cx, cy, (float(z0) + float(z1)) / 2),
                scale=(2 * float(r), 2 * float(r), float(z1) - float(z0)),
                color=tuple(int(v) for v in col),
                label=f"{s.kind}/{s.size_class}",
            ))
        elif s.box is not None:
            markers.append(Marker(
                kind="cube",
                center=_f3(s.box.center),
                scale=_f3(s.box.extents),
                axes=_np(s.box.axes).astype(np.float64).tolist(),
                color=tuple(int(v) for v in col),
                label=f"{s.kind}/{s.size_class}",
            ))
    return xyz[mask], rgb[mask], markers


def table_detection_viz(det, down) -> Tuple[np.ndarray, np.ndarray,
                                            List[Marker]]:
    """(xyz, rgb, markers) for a detect_table result — table inliers,
    hull polygon, per-object cubes (table_object_detector_passive's
    published TableWithObjects rendered RViz-style)."""
    xyz = _np(down.padded_xyz())
    mask = _np(down.mask)
    rgb = np.full((len(xyz), 3), 150, np.uint8)
    rgb[_np(det.table_inliers)] = [110, 80, 50]  # table = brown
    markers: List[Marker] = []
    # hull polygon at table height (RadialHull: per-angular-bin radius)
    hc = _np(det.hull.center)
    hr = _np(det.hull.radii)
    zt = float(_np(det.table_max)[2])
    ang = (np.arange(len(hr)) + 0.5) / len(hr) * 2 * np.pi
    ok = hr > 0
    if ok.any():
        pts = [[float(hc[0] + r * np.cos(a)), float(hc[1] + r * np.sin(a)), zt]
               for r, a in zip(hr[ok], ang[ok])]
        markers.append(Marker(kind="polygon",
                              center=(float(hc[0]), float(hc[1]), zt),
                              color=(110, 80, 50), points=pts,
                              label="table_hull"))
    sizes = _np(det.object_sizes)
    centers = _np(det.object_centers)
    mins = _np(det.object_min)
    maxs = _np(det.object_max)
    oi = 0
    for o in range(len(sizes)):
        if sizes[o] <= 0:
            continue
        col = PALETTE[oi % len(PALETTE)]
        oi += 1
        rgb[_np(det.object_masks[o])] = col
        markers.append(Marker(
            kind="cube", center=_f3(centers[o]),
            scale=_f3(maxs[o] - mins[o]),
            color=tuple(int(v) for v in col), label=f"object_{oi}",
        ))
    return xyz[mask], rgb[mask], markers


def table_memory_viz(mem) -> List[Marker]:
    """Markers for a TableMemory belief state — polygon per table + text
    names per object (table_memory.cpp publish_mem_state :1222-1260)."""
    markers: List[Marker] = []
    for t in getattr(mem, "tables", []):
        poly = _np(t.polygon)
        z = float(t.height)
        if len(poly):
            pts = [[float(x), float(y), z] for x, y in poly]
            markers.append(Marker(kind="polygon", center=_f3(t.center),
                                  color=(110, 80, 50), points=pts,
                                  label=f"table_{t.table_id}"))
        insts = getattr(t, "instances", [])
        objs = insts[-1].objects if insts else []
        for obj in objs:
            markers.append(Marker(kind="text", center=_f3(obj.center),
                                  color=(255, 255, 255),
                                  label=str(obj.name or "object")))
    return markers


def dump_viz(out_dir: str, name: str, xyz: np.ndarray, rgb: np.ndarray,
             markers: Sequence[Marker]) -> Dict[str, str]:
    """Write <name>.ply + <name>_markers.json into out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    ply = os.path.join(out_dir, f"{name}.ply")
    mj = os.path.join(out_dir, f"{name}_markers.json")
    save_ply(ply, xyz, rgb)
    save_markers_json(mj, markers)
    return {"ply": ply, "markers": mj}
