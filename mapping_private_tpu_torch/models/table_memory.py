"""TableMemory — the persistent semantic world model.

Counterpart of ``mapping_private_tpu/models/table_memory.py`` (the
reference's ``dyn_obj_store/src/table_memory.cpp``): it (a) matches each
table observation against the known tables by polygon intersection (the
``/intersect_poly`` service with its >50% area rule and a centre-in-polygon
fallback, compare_table :286-330); (b) appends a ``TableStateInstance``
per observation (:47-128); (c) runs the reconstruction chain over each
object cluster, MLS → cylinder fit against a box fit
(reconstruct_table_objects :843-1000); (d) names objects across
observations (name_table_objects) and reports the belief state
(:1220-1260).

Polygon clipping is host numpy (``ops/hull.py``); the reconstruction runs
on the memory's device.  The memory checkpoints its whole state to an
``.npz`` archive in the JAX package's layout, so either package restores
the other's.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.fit.box import fit_box_zup
from mapping_private_tpu_torch.fit.cylinder import fit_cylinder_ransac
from mapping_private_tpu_torch.ops.hull import (
    convex_hull_2d,
    convex_polygon_intersection,
    point_in_polygon,
    polygon_area,
)
from mapping_private_tpu_torch.ops.mls import mls
from mapping_private_tpu_torch.utils.metrics import metrics

CYLINDER_HYPOTHESES = 512  # fit_cylinder_ransac's default, the uniforms a cluster draws


@dataclasses.dataclass
class TableObject:
    """One reconstructed object cluster (table_memory.cpp TableObject :47-76)."""

    center: np.ndarray  # (3,)
    points: np.ndarray  # (P, 3) live points
    name: str = ""
    object_type: str = ""  # 'cylinder' | 'box'
    semantic_class: str = ""  # classifier label (table_memory_grsd variant)
    box: Optional[dict] = None  # center/axes/extents
    cylinder: Optional[dict] = None  # point/axis/radius/k_min/k_max
    fit_quality: float = 0.0  # inlier fraction of the winning model


@dataclasses.dataclass
class TableStateInstance:
    """One observation of a table (:78-95)."""

    stamp: float
    objects: List[TableObject] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Table:
    """A known table: id, polygon, observation history (:97-128)."""

    table_id: int
    center: np.ndarray  # (3,)
    polygon: np.ndarray  # (V, 2) convex hull in table plane
    height: float
    instances: List[TableStateInstance] = dataclasses.field(default_factory=list)

    def latest(self) -> Optional[TableStateInstance]:
        return self.instances[-1] if self.instances else None


def tables_match(old_polygon: np.ndarray, old_area: float,
                 new_polygon: np.ndarray, new_center: np.ndarray) -> bool:
    """compare_table semantics (:286-330): intersection area > 50% of
    either polygon, else center-of-new inside old."""
    if len(old_polygon) > 2 and len(new_polygon) > 2:
        clip = convex_polygon_intersection(old_polygon, new_polygon)
        if len(clip) > 2:
            area_clip = polygon_area(clip)
            area_new = polygon_area(new_polygon)
            if area_clip / max(old_area, 1e-9) > 0.5 or \
               area_clip / max(area_new, 1e-9) > 0.5:
                return True
    if len(old_polygon) > 2:
        return bool(point_in_polygon(old_polygon, new_center[None, :2])[0])
    return False


def _reconstruct_object(points: np.ndarray, generator: Optional[torch.Generator],
                        sac_threshold: float = 0.01, *, device: torch.device | str,
                        u: Optional[torch.Tensor] = None) -> TableObject:
    """The per-cluster reconstruction chain (reconstruct_table_objects
    :843-1000): MLS smoothing (with its normals) → cylinder fit against a
    robust box fit; the cylinder wins above 80% inliers.  The cylinder's
    RANSAC draws (CYLINDER_HYPOTHESES, 2) uniforms from ``generator`` or
    takes them as ``u``.  The MLS ranks neighbours by direct differences,
    as the detector does: the matmul form's float32 rounding swaps
    near-tied neighbours of the voxel grid and tilts the normals the
    cylinder is fitted to."""
    center = points.mean(0)
    obj = TableObject(center=center, points=points)
    if len(points) < 12:
        obj.object_type = "box"
        obj.fit_quality = 0.0
        return obj
    cloud = mls(PointCloud.from_numpy(points.astype(np.float32), device=device),
                search_radius=0.02, k=16, direct=True)
    cyl, inl = fit_cylinder_ransac(
        cloud.padded_xyz(), cloud.channel("normal"), cloud.mask, generator,
        num_hypotheses=CYLINDER_HYPOTHESES, threshold=sac_threshold, max_radius=0.5, u=u,
    )
    box = fit_box_zup(cloud.padded_xyz(), cloud.mask)
    cyl_frac = float(torch.sum(inl)) / max(int(cloud.count()), 1)
    if cyl_frac > 0.8:
        obj.object_type = "cylinder"
        obj.cylinder = dict(point=cyl.point.cpu().numpy(), axis=cyl.axis.cpu().numpy(),
                            radius=float(cyl.radius), k_min=float(cyl.k_min), k_max=float(cyl.k_max))
        obj.fit_quality = cyl_frac
    else:
        obj.object_type = "box"
        obj.fit_quality = 1.0
    obj.box = dict(center=box.center.cpu().numpy(), axes=box.axes.cpu().numpy(),
                   extents=box.extents.cpu().numpy())
    return obj


class TableMemory:
    """The stateful store.  Feed observations via update(); query tables.

    classify_fn: optional callable (points (P,3) → str) run on every
    reconstructed cluster and stored as its semantic class — the
    `table_memory_grsd` variant's GlobalRSD+SVM cluster classification
    (src/table_memory_grsd.cpp:852-1000).
    """

    def __init__(self, sac_threshold: float = 0.01, classify_fn=None, *,
                 device: torch.device | str):
        self.tables: List[Table] = []
        self._next_object_id = 0
        self.sac_threshold = sac_threshold
        self.classify_fn = classify_fn
        self.device = torch.device(device)

    # -- observation ingest ------------------------------------------------
    def update(
        self,
        table_hull_xy: np.ndarray,
        table_height: float,
        object_clusters: List[np.ndarray],
        stamp: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> int:
        """Ingest one TableWithObjects-equivalent observation
        (table_cb orchestration, table_memory.cpp:1151-1219).  The
        reconstruction draws from ``generator`` (default: a new one on the
        memory's device seeded with 0), one cluster after another.

        Returns the table id the observation was merged into."""
        with metrics.span("table_memory"):
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            polygon = convex_hull_2d(np.asarray(table_hull_xy))
            center = np.concatenate([
                polygon.mean(0) if len(polygon) else np.zeros(2), [table_height]
            ])

            table = None
            for t in self.tables:
                if tables_match(t.polygon, polygon_area(t.polygon), polygon, center):
                    table = t
                    break
            if table is None:
                table = Table(
                    table_id=len(self.tables), center=center,
                    polygon=polygon, height=float(table_height),
                )
                self.tables.append(table)
            else:
                # merge polygon: hull of union (update_table RobustBoxEstimation
                # over the merged contour, :437-444)
                merged = np.vstack([table.polygon, polygon])
                table.polygon = convex_hull_2d(merged)
                table.center = np.concatenate([table.polygon.mean(0), [table.height]])

            inst = TableStateInstance(stamp=stamp)
            for pts in object_clusters:
                with metrics.span("table_memory.object"):
                    obj = _reconstruct_object(np.asarray(pts, np.float32), generator,
                                              self.sac_threshold, device=self.device)
                    if self.classify_fn is not None:
                        try:
                            obj.semantic_class = str(self.classify_fn(obj.points))
                        except Exception:
                            obj.semantic_class = ""
                inst.objects.append(obj)
            self._name_objects(table, inst)
            table.instances.append(inst)
            return table.table_id

    def _name_objects(self, table: Table, inst: TableStateInstance,
                      match_dist: float = 0.08) -> None:
        """Persistent names by nearest-centroid matching against the
        previous instance (name_table_objects)."""
        prev = table.latest()
        taken = set()
        for obj in inst.objects:
            best = None
            if prev is not None:
                dists = [
                    (np.linalg.norm(obj.center - p.center), p)
                    for p in prev.objects if p.name not in taken
                ]
                dists.sort(key=lambda t: t[0])
                if dists and dists[0][0] < match_dist:
                    best = dists[0][1]
            if best is not None:
                obj.name = best.name
                taken.add(best.name)
            else:
                obj.name = f"object_{self._next_object_id}"
                self._next_object_id += 1

    # -- queries (the table_memory_clusters_service analog, :274) -----------
    def belief_state(self) -> Dict[str, list]:
        """Current world snapshot: per table, the latest named objects."""
        out = {}
        for t in self.tables:
            inst = t.latest()
            out[f"table_{t.table_id}"] = [
                dict(name=o.name, type=o.object_type, center=o.center.tolist(),
                     fit_quality=o.fit_quality, semantic_class=o.semantic_class)
                for o in (inst.objects if inst else [])
            ]
        return out

    # -- checkpoint / resume (new capability; the reference loses state on
    # crash, SURVEY §5.3) ----------------------------------------------------
    def checkpoint(self, path: str) -> None:
        arrays: Dict[str, np.ndarray] = {}
        meta: list = []
        for t in self.tables:
            arrays[f"poly_{t.table_id}"] = t.polygon
            tmeta = dict(table_id=t.table_id, height=t.height,
                         center=t.center.tolist(), instances=[])
            for ii, inst in enumerate(t.instances):
                imeta = dict(stamp=inst.stamp, objects=[])
                for oi, o in enumerate(inst.objects):
                    pid = f"pts_{t.table_id}_{ii}_{oi}"
                    arrays[pid] = o.points
                    imeta["objects"].append(dict(
                        name=o.name, type=o.object_type,
                        semantic_class=o.semantic_class,
                        center=o.center.tolist(), fit_quality=o.fit_quality,
                        box={k: np.asarray(v).tolist() for k, v in (o.box or {}).items()},
                        cylinder={k: (np.asarray(v).tolist() if hasattr(v, "__len__") else v)
                                  for k, v in (o.cylinder or {}).items()} or None,
                        points_key=pid,
                    ))
                tmeta["instances"].append(imeta)
            meta.append(tmeta)
        arrays["__meta__"] = np.frombuffer(
            json.dumps(dict(tables=meta, next_object_id=self._next_object_id)
                       ).encode(), dtype=np.uint8,
        )
        np.savez_compressed(path, **arrays)

    @staticmethod
    def restore(path: str, *, device: torch.device | str) -> "TableMemory":
        with np.load(path, allow_pickle=False) as data:
            return TableMemory._from_archive(data, device)

    @staticmethod
    def _from_archive(data, device) -> "TableMemory":
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        mem = TableMemory(device=device)
        mem._next_object_id = meta["next_object_id"]
        for tmeta in meta["tables"]:
            t = Table(
                table_id=tmeta["table_id"],
                center=np.asarray(tmeta["center"]),
                polygon=data[f"poly_{tmeta['table_id']}"],
                height=tmeta["height"],
            )
            for imeta in tmeta["instances"]:
                inst = TableStateInstance(stamp=imeta["stamp"])
                for ometa in imeta["objects"]:
                    obj = TableObject(
                        center=np.asarray(ometa["center"]),
                        points=data[ometa["points_key"]],
                        name=ometa["name"], object_type=ometa["type"],
                        semantic_class=ometa.get("semantic_class", ""),
                        fit_quality=ometa["fit_quality"],
                        box={k: np.asarray(v) for k, v in (ometa["box"] or {}).items()} or None,
                        cylinder=ometa["cylinder"],
                    )
                    inst.objects.append(obj)
                t.instances.append(inst)
            mem.tables.append(t)
        return mem
