"""Room-scale structural segmentation — ``pointcloud_segmentation``.

Counterpart of ``mapping_private_tpu/models/room_segmentation.py``
(pointcloud_segmentation/src/pointcloud_segmentation.cpp): floor = points
below z_floor (segmentFloor :255+), ceiling = points above z_ceiling
(segmentCeiling :206-252), walls = repeated RANSAC extraction of planes
whose normals are perpendicular to z (segmentVerticalPlanes :161-203).
The per-point label is 0 unlabeled, 1 floor, 2 ceiling, 3+ walls.

Also ``wall_filter`` (cloud_tools/src/wall_filter.cpp): drop every point
within the SAC distance of a detected dominant vertical plane.

Randomness: one ``torch.Generator`` is threaded through the walls, or
``u`` gives each wall's (num_hypotheses, 3) uniforms in turn (the JAX
package draws each wall from its own ``jax.random.split``).  The wall
loop reads two scalars a wall on the host (the inlier count and the
verticality), as the JAX loop does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.core.linalg import f32_of
from mapping_private_tpu_torch.fit.ransac import fit_plane_ransac

FLOOR, CEILING, FIRST_WALL = 1, 2, 3


@dataclasses.dataclass(frozen=True)
class RoomSegmentationConfig:
    z_floor: float = 0.1  # segmentFloor threshold
    z_ceiling: float = 2.7  # segmentCeiling threshold
    max_walls: int = 4
    sac_threshold: float = 0.03  # wall_filter sac_distance_threshold (:155)
    eps_angle: float = 15.0 * 3.14159265 / 180.0  # normal_eps_angle (:142)
    min_wall_inliers: int = 300
    num_hypotheses: int = 256


@dataclasses.dataclass
class RoomSegmentation:
    labels: torch.Tensor  # (N,) int32 segment ids
    wall_planes: List[torch.Tensor]  # (4,) plane coefficients each


def segment_room(
    cloud: PointCloud,
    generator: Optional[torch.Generator] = None,
    cfg: RoomSegmentationConfig = RoomSegmentationConfig(),
    u: Optional[Sequence[torch.Tensor]] = None,
) -> RoomSegmentation:
    """Label floor/ceiling/walls.  Walls are extracted in turn: fit a plane
    on the remaining unlabeled points, claim its inliers, repeat up to
    max_walls or until a fit falls under min_wall_inliers or is not
    vertical (the dominant plane is then horizontal, e.g. a table)."""
    xyz = cloud.padded_xyz()
    dev = xyz.device
    labels = torch.zeros((cloud.capacity,), dtype=torch.int32, device=dev)
    floor = cloud.mask & (xyz[:, 2] < cfg.z_floor)
    ceiling = cloud.mask & (xyz[:, 2] > cfg.z_ceiling)
    labels = torch.where(floor, FLOOR, labels)
    labels = torch.where(ceiling, CEILING, labels)
    live = cloud.mask & ~floor & ~ceiling

    sin_eps = f32_of(torch.sin, cfg.eps_angle, dev)
    walls: List[torch.Tensor] = []
    for wi in range(cfg.max_walls):
        # free planes, non-vertical winners rejected (the reference checks
        # the plane-to-z angle ≈ 90°, wall_filter.cpp:262)
        plane, inl = fit_plane_ransac(
            xyz, live, generator, num_hypotheses=cfg.num_hypotheses,
            threshold=cfg.sac_threshold, u=None if u is None else u[wi])
        count, vertical = torch.stack([
            torch.sum(inl, dtype=torch.int32),
            (torch.abs(plane[2]) <= sin_eps).to(torch.int32)]).tolist()
        if count < cfg.min_wall_inliers or not vertical:
            break
        labels = torch.where(inl, FIRST_WALL + wi, labels)
        live = live & ~inl
        walls.append(plane)
    return RoomSegmentation(labels=labels, wall_planes=walls)


def wall_filter(
    cloud: PointCloud,
    generator: Optional[torch.Generator] = None,
    cfg: RoomSegmentationConfig = RoomSegmentationConfig(),
    u: Optional[Sequence[torch.Tensor]] = None,
) -> PointCloud:
    """Remove dominant vertical planes (cloud_tools wall_filter node):
    every point within sac_threshold of a detected wall plane is dropped
    from the ORIGINAL cloud (the reference filters cloud_in_ by
    pointToPlaneDistance, wall_filter.cpp:268)."""
    seg = segment_room(cloud, generator, cfg, u)
    keep = cloud.mask
    xyz = cloud.padded_xyz()
    for plane in seg.wall_planes:
        keep = keep & (torch.abs(xyz @ plane[:3] + plane[3]) >= cfg.sac_threshold)
    return cloud.select(keep)
