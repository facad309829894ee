"""Tabletop detector — the end-to-end perception slice.

Counterpart of ``mapping_private_tpu/models/table_detector.py`` (the
reference's ``table_object_detector_passive``,
cloud_tools/src/table_object_detector_passive.cpp): z-band filter → voxel
downsample (:372) → kNN normals (:392) → z-parallel normal gate (:396) →
Euclidean clustering with normal-angle edges (:401) → a RANSAC plane per
candidate (:415) → hull (:485) → object clusters above the table (:528,
findObjectClusters :254-341).

Every stage is a masked dense tensor op.  The candidate tables are fitted
together, as one batch over the candidate axis (the JAX package vmaps a
per-candidate fit), and so are the objects' statistics.  The only host
reads are the convergence tests of the two label propagations.

The k-NN searches (normals, both clusterings) rank by direct differences,
not the JAX package's matmul form: at a table 0.8 m from the sensor the
matmul form's float32 rounding swaps neighbours whose d² lie within ~5e-5
of each other, and a voxel's normal, with it the candidates and the
plane, then follows its centroid's last bits.

Default parameters are the reference's ROS defaults (constructor
:150-210): leaf 0.03, k=10, eps_angle 15°, region angle 30°, cluster
tolerance 0.5 m / min 10 points, object tolerance 0.05 m / min 30 points,
SAC threshold 0.03, delta_z 0.03, support distance 0.10, min table
inliers 100, z band [0.5, 1.5].
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from mapping_private_tpu_torch.core.cloud import PAD_COORD, PointCloud
from mapping_private_tpu_torch.core.linalg import f32_of
from mapping_private_tpu_torch.fit.ransac import fit_plane_ransac
from mapping_private_tpu_torch.ops.cluster import euclidean_cluster, top_clusters
from mapping_private_tpu_torch.ops.hull import RadialHull, in_radial_hull, radial_hull
from mapping_private_tpu_torch.ops.normals import estimate_normals
from mapping_private_tpu_torch.ops.voxel import voxel_downsample
from mapping_private_tpu_torch.utils.metrics import metrics


@dataclasses.dataclass(frozen=True)
class TableDetectorConfig:
    table_min_height: float = 0.5
    table_max_height: float = 1.5
    leaf_size: float = 0.03
    k_normals: int = 10
    eps_angle: float = 15.0 * math.pi / 180.0
    region_angle_threshold: float = 30.0 * math.pi / 180.0
    clusters_growing_tolerance: float = 0.5
    clusters_min_pts: int = 10
    object_cluster_tolerance: float = 0.05
    object_cluster_min_pts: int = 30
    sac_distance_threshold: float = 0.03
    sac_hypotheses: int = 256
    delta_z: float = 0.03
    object_min_distance_from_table: float = 0.10
    min_table_inliers: int = 100
    # `one_table` wanted-table gating
    # (table_object_detector_passive_one_table.cpp:201-206, :434-445):
    # when set, a candidate plane is accepted only if its inlier centroid
    # lies within sqrt(max_sqr_dist_to_wanted_table) of this (x, y).
    wanted_table_center: Optional[Tuple[float, float]] = None
    max_sqr_dist_to_wanted_table: float = 1.0
    # capacities
    down_capacity: int = 8192
    max_table_candidates: int = 4
    max_objects: int = 16
    hull_bins: int = 72
    cluster_knn: int = 16


@dataclasses.dataclass(frozen=True)
class TableDetection:
    """All tensors refer to rows of the downsampled cloud (M rows)."""

    found: torch.Tensor  # () bool
    plane: torch.Tensor  # (4,) [n, d]
    table_inliers: torch.Tensor  # (M,) bool
    table_min: torch.Tensor  # (3,)
    table_max: torch.Tensor  # (3,)
    hull: RadialHull
    object_masks: torch.Tensor  # (O, M) bool
    object_sizes: torch.Tensor  # (O,) int32
    object_centers: torch.Tensor  # (O, 3)
    object_min: torch.Tensor  # (O, 3)
    object_max: torch.Tensor  # (O, 3)

    def num_objects(self) -> torch.Tensor:
        return torch.sum(self.object_sizes > 0, dtype=torch.int32)


def _masked_minmax(xyz: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-axis min and max over the rows of ``mask`` (..., M) of xyz (M, 3):
    (..., 3) each; ±PAD_COORD where the mask is empty."""
    m = mask[..., None]
    return (torch.amin(torch.where(m, xyz, PAD_COORD), dim=-2),
            torch.amax(torch.where(m, xyz, -PAD_COORD), dim=-2))


def table_uniforms_shape(config: TableDetectorConfig) -> Tuple[int, int, int]:
    """Shape of the uniforms ``detect_table`` draws: one (hypotheses, 3)
    block per table candidate."""
    return (config.max_table_candidates, config.sac_hypotheses, 3)


def detect_table(
    cloud: PointCloud,
    generator: Optional[torch.Generator] = None,
    config: TableDetectorConfig = TableDetectorConfig(),
    u: Optional[torch.Tensor] = None,
) -> Tuple[TableDetection, PointCloud]:
    """Run the detector.  Returns (detection, downsampled cloud).

    The candidates' RANSAC draws ``table_uniforms_shape(config)`` uniforms
    from ``generator``, or takes them as ``u``."""
    cfg = config
    dev = cloud.xyz.device
    with metrics.span("detect_table"):
        cos_eps = f32_of(torch.cos, cfg.eps_angle, dev)
        with metrics.span("detect_table.downsample"):
            # 1. z-band filter (reference cloud_cb :353-363)
            band = (cloud.xyz[:, 2] >= cfg.table_min_height) & (cloud.xyz[:, 2] <= cfg.table_max_height)

            # 2. voxel downsample (:372)
            down = voxel_downsample(cloud.select(band), cfg.leaf_size, cfg.down_capacity)

        with metrics.span("detect_table.candidates"):
            # 3. normals (:392)
            down = estimate_normals(down, k=cfg.k_normals, viewpoint=torch.zeros(3, device=dev), direct=True)
            normals = down.channel("normal")
            xyz = down.padded_xyz()

            # 4. z-parallel normal selection (:396)
            cand_mask = down.mask & (torch.abs(normals[:, 2]) >= cos_eps)

            # 5. cluster candidate surface points (:401)
            labels = euclidean_cluster(xyz, cand_mask, cfg.clusters_growing_tolerance, k=cfg.cluster_knn,
                                       normals=normals, angle_threshold=cfg.region_angle_threshold,
                                       direct=True)
            members, _ = top_clusters(labels, cand_mask, cfg.max_table_candidates,
                                      min_size=cfg.clusters_min_pts)

        with metrics.span("detect_table.ransac"):
            # 6. a RANSAC plane per candidate, all candidates in one batch
            if u is None:
                u = torch.rand(table_uniforms_shape(cfg), generator=generator, device=dev)
            planes, inlier_sets = fit_plane_ransac(xyz, members, u=u, num_hypotheses=cfg.sac_hypotheses,
                                                   threshold=cfg.sac_distance_threshold)
            ok = torch.abs(planes[:, 2]) >= cos_eps
            if cfg.wanted_table_center is not None:
                # one_table gate: the candidate's inlier centroid near the wanted table
                w = inlier_sets.to(torch.float32)[..., None]
                centroid = torch.sum(xyz[:, :2] * w, dim=1) / torch.clamp_min(torch.sum(w, dim=1), 1.0)
                want = torch.tensor(cfg.wanted_table_center, dtype=torch.float32, device=dev)
                ok &= torch.sum((centroid - want) ** 2, dim=-1) < cfg.max_sqr_dist_to_wanted_table
            counts = torch.where(ok, torch.sum(inlier_sets, dim=1, dtype=torch.int32), -1)
            best = torch.argmax(counts)
            plane = planes[best]
            # orient the plane normal +z for a consistent "above the table" side
            flip = torch.sign(plane[2])
            plane = plane * torch.where(flip == 0, 1.0, flip)
            table_inliers = inlier_sets[best]
            found = counts[best] >= cfg.min_table_inliers

        with metrics.span("detect_table.objects"):
            # 7. table bounds + hull (:485)
            t_min, t_max = _masked_minmax(down.xyz, table_inliers)
            hull = radial_hull(down.xyz[:, :2], table_inliers, num_bins=cfg.hull_bins)

            # 8. object candidates above the table (findObjectClusters :254-341)
            above = (down.mask
                     & (xyz[:, 0] > t_min[0]) & (xyz[:, 0] < t_max[0])
                     & (xyz[:, 1] > t_min[1]) & (xyz[:, 1] < t_max[1])
                     & (xyz[:, 2] > t_max[2] + cfg.delta_z))
            dist_to_plane = xyz @ plane[:3] + plane[3]
            proj = xyz - dist_to_plane[:, None] * plane[:3][None, :]
            above &= in_radial_hull(hull, proj[:, :2])

            # 9. cluster objects
            obj_labels = euclidean_cluster(xyz, above, cfg.object_cluster_tolerance, k=cfg.cluster_knn,
                                           direct=True)
            obj_masks, obj_sizes = top_clusters(obj_labels, above, cfg.max_objects,
                                                min_size=cfg.object_cluster_min_pts)

            # 10. support check: a cluster must start near the table surface
            obj_min, obj_max = _masked_minmax(down.xyz, obj_masks)
            w = obj_masks.to(torch.float32)[..., None]
            obj_centers = torch.sum(down.xyz * w, dim=1) / torch.clamp_min(torch.sum(w, dim=1), 1.0)
            supported = obj_min[:, 2] <= t_max[2] + cfg.object_min_distance_from_table
            keep = supported & (obj_sizes > 0) & found

            det = TableDetection(
                found=found,
                plane=plane,
                table_inliers=table_inliers & found,
                table_min=t_min,
                table_max=t_max,
                hull=hull,
                object_masks=obj_masks & keep[:, None],
                object_sizes=torch.where(keep, obj_sizes, 0),
                object_centers=obj_centers,
                object_min=obj_min,
                object_max=obj_max,
            )
        return det, down
