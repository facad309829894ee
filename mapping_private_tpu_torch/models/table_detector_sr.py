"""Organized-cloud table detector — ``table_object_detector_sr``.

Counterpart of ``mapping_private_tpu/models/table_detector_sr.py``.  The
reference's SwissRanger variant (cloud_tools/src/
table_object_detector_sr.cpp:1-482) works on ORGANIZED range images
(176×144, :72-73): organized-neighbourhood normals with jump-edge
filtering (``computeOrganizedPointCloudNormalsWithFiltering``, :254),
z-parallel normal selection (:259), one RANSAC plane (:264), a jump-edge
filter pass over the full-resolution cloud (``filterJumpEdges``, :269),
plane refinement by point-to-plane distance (:272-280), the 2-D hull of
the downsampled inliers (:287) and the object clusters the table
supports (``findObjectClusters``, :340+).  The filters are dense
shifted-window image ops: one (2k+1)² shift loop, no per-pixel search.

``split_table_detection`` is the ``table_msg_split.cpp:1-115``
counterpart (the table polygon and one cloud per object cluster).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.core.linalg import f32_of
from mapping_private_tpu_torch.fit.ransac import fit_plane_ransac
from mapping_private_tpu_torch.ops.cluster import euclidean_cluster, top_clusters
from mapping_private_tpu_torch.ops.hull import in_radial_hull, radial_hull
from mapping_private_tpu_torch.ops.normals import smallest_eigenvector_3x3


def _shift2d(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``a`` (H, W, ...) shifted by (dy, dx): out[y, x] = a[y − dy, x − dx],
    zero where that falls outside the image (a roll without the wrap)."""
    H, W = a.shape[0], a.shape[1]
    out = torch.zeros_like(a)
    if abs(dy) >= H or abs(dx) >= W:
        return out
    ys, yd = (slice(0, H - dy), slice(dy, H)) if dy >= 0 else (slice(-dy, H), slice(0, H + dy))
    xs, xd = (slice(0, W - dx), slice(dx, W)) if dx >= 0 else (slice(-dx, W), slice(0, W + dx))
    out[yd, xd] = a[ys, xs]
    return out


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of 3-vectors, summed in order."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _cos_deg(deg: float, device) -> torch.Tensor:
    return f32_of(lambda t: torch.cos(torch.deg2rad(t)), deg, device)


def jump_edge_keep_mask(
    points: torch.Tensor,  # (H, W, 3)
    valid: torch.Tensor,  # (H, W)
    viewpoint: torch.Tensor,  # (3,)
    min_angle_deg: float = 10.0,
    max_angle_deg: float = 170.0,
    step: int = 1,
) -> torch.Tensor:
    """True where a point is NOT a jump edge (``filterJumpEdges``): for
    each of the 4 image neighbours at ``step``, the angle between the
    viewpoint ray and the segment to the neighbour must stay inside
    [min_angle, max_angle] — a segment nearly parallel to the line of
    sight is a depth discontinuity, not surface."""
    ray = points - viewpoint
    rn = _norm(ray)
    cmin, cmax = _cos_deg(min_angle_deg, points.device), _cos_deg(max_angle_deg, points.device)
    keep = valid
    for dy, dx in ((0, step), (0, -step), (step, 0), (-step, 0)):
        seg = _shift2d(points, dy, dx) - points
        sn = _norm(seg)
        c = torch.sum(ray * seg, -1) / torch.clamp_min(rn * sn, 1e-12)
        # angle < min (c > cos(min)) or angle > max (c < cos(max))
        edge = _shift2d(valid, dy, dx) & ((c > cmin) | (c < cmax)) & (sn > 1e-9)
        keep = keep & ~edge
    return keep


def _filtered_normals(points, keep, viewpoint, k, max_z):
    """Windowed-PCA normals over the pixels ``keep`` marks, neighbours
    beyond a ``max_z`` depth gap excluded, oriented toward the viewpoint."""
    w0 = keep.to(points.dtype)
    z = points[..., 2]
    S0 = torch.zeros_like(w0)
    S1 = torch.zeros_like(points)
    S2 = torch.zeros(points.shape[:2] + (3, 3), dtype=points.dtype, device=points.device)
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            nb = _shift2d(points, dy, dx)
            wn = _shift2d(w0, dy, dx) * (torch.abs(nb[..., 2] - z) <= max_z)
            S0 = S0 + wn
            S1 = S1 + nb * wn[..., None]
            S2 = S2 + (nb[..., :, None] * nb[..., None, :]) * wn[..., None, None]
    cnt = torch.clamp_min(S0, 1.0)
    mean = S1 / cnt[..., None]
    cov = S2 / cnt[..., None, None] - mean[..., :, None] * mean[..., None, :]
    _, vec = smallest_eigenvector_3x3(cov.reshape(-1, 3, 3))
    nrm = vec.reshape(points.shape)
    flip = torch.where(torch.sum(nrm * (viewpoint - points), -1, keepdim=True) < 0, -1.0, 1.0)
    ok = keep & (S0 >= 3)
    return torch.where(ok[..., None], nrm * flip, 0.0), ok


def organized_normals_filtered(
    points: torch.Tensor,  # (H, W, 3)
    valid: torch.Tensor,  # (H, W)
    viewpoint: torch.Tensor,
    k: int = 2,
    max_z: float = 0.03,
    min_angle_deg: float = 10.0,
    max_angle_deg: float = 170.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed-PCA normals over the organized grid with filtering
    (``computeOrganizedPointCloudNormalsWithFiltering``): neighbours
    beyond a ``max_z`` depth gap are excluded from each window, jump-edge
    pixels are excluded entirely, normals orient toward the viewpoint.

    Returns (normals (H,W,3), ok (H,W))."""
    keep = jump_edge_keep_mask(points, valid, viewpoint, min_angle_deg, max_angle_deg)
    return _filtered_normals(points, keep, viewpoint, k, max_z)


@dataclasses.dataclass(frozen=True)
class SRDetectorConfig:
    """Defaults = the reference's parameter-server defaults
    (table_object_detector_sr.cpp:135-163)."""

    downsample_factor: int = 4  # :135
    k_neighbors: int = 2  # search_k_closest window radius :136
    max_z: float = 0.03  # k_max_z :137
    eps_angle: float = 15.0  # degrees :139
    min_angle: float = 10.0  # filtering_min_angle :156
    max_angle: float = 170.0  # filtering_max_angle :157
    sac_distance_threshold: float = 0.03  # :163
    sac_hypotheses: int = 256
    object_cluster_tolerance: float = 0.07  # :142
    object_cluster_min_pts: int = 30  # :143
    delta_z: float = 0.05  # :145
    object_min_distance_from_table: float = 0.10  # :146
    min_table_inliers: int = 50
    max_objects: int = 8
    hull_bins: int = 72
    cluster_knn: int = 16


@dataclasses.dataclass(frozen=True)
class SRPlaneClusters:
    """GetPlaneClusters.srv-shaped result (the plane equation and the
    object clusters; mapping_srvs/srv/GetPlaneClusters.srv)."""

    found: torch.Tensor  # () bool
    plane: torch.Tensor  # (4,) [n, d], n_z >= 0
    table_inliers: torch.Tensor  # (H, W) bool, full resolution
    keep_mask: torch.Tensor  # (H, W) bool — jump-edge filter result
    table_min: torch.Tensor  # (3,)
    table_max: torch.Tensor  # (3,)
    object_masks: torch.Tensor  # (O, H*W) bool over the flattened image
    object_sizes: torch.Tensor  # (O,) int32
    object_centers: torch.Tensor  # (O, 3)


def detect_table_sr(
    points: torch.Tensor,  # (H, W, 3) organized cloud, z-up frame
    valid: torch.Tensor,  # (H, W)
    viewpoint: torch.Tensor,  # (3,) sensor origin in the same frame
    generator: Optional[torch.Generator] = None,
    cfg: SRDetectorConfig = SRDetectorConfig(),
    u: Optional[torch.Tensor] = None,
) -> SRPlaneClusters:
    """The detectTable pipeline (table_object_detector_sr.cpp:196-340).
    ``u`` (sac_hypotheses, 3) replaces the generator's uniforms of the
    plane fit.  Reads nothing back to the host but the clustering's
    convergence checks."""
    f = cfg.downsample_factor
    dev = points.device
    viewpoint = torch.as_tensor(viewpoint, dtype=points.dtype, device=dev)
    # 1. filtered organized normals, downsampled (:254); the jump-edge
    #    mask is the one step 4 uses on the full cloud (:269)
    keep = jump_edge_keep_mask(points, valid, viewpoint, cfg.min_angle, cfg.max_angle)
    nrm, n_ok = _filtered_normals(points, keep, viewpoint, cfg.k_neighbors, cfg.max_z)
    dpts = points[::f, ::f].reshape(-1, 3)
    dnrm = nrm[::f, ::f].reshape(-1, 3)
    dok = n_ok[::f, ::f].reshape(-1)

    # 2. z-parallel normal selection (:259)
    sel = dok & (torch.abs(dnrm[:, 2]) >= _cos_deg(cfg.eps_angle, dev))

    # 3. RANSAC plane on the selected downsampled points (:264)
    plane, inl_down = fit_plane_ransac(
        dpts, sel, generator, num_hypotheses=cfg.sac_hypotheses,
        threshold=cfg.sac_distance_threshold, u=u)
    flip = torch.sign(plane[2])
    plane = plane * torch.where(flip == 0, 1.0, flip)
    found = torch.sum(inl_down, dtype=torch.int32) >= cfg.min_table_inliers

    # 4. plane refinement by raw distance over the jump-edge-filtered
    #    full cloud (:272-280)
    flat = points.reshape(-1, 3)
    kflat = keep.reshape(-1)
    dist = flat @ plane[:3] + plane[3]
    table_full = kflat & (torch.abs(dist) < cfg.sac_distance_threshold)

    # 5. hull of the DOWNSAMPLED inliers (:287 uses cloud_down_)
    hull = radial_hull(dpts[:, :2], inl_down, num_bins=cfg.hull_bins)
    big = 1e8
    t_min = torch.where(table_full[:, None], flat, big).amin(dim=0)
    t_max = torch.where(table_full[:, None], flat, -big).amax(dim=0)

    # 6. object clusters above the table (findObjectClusters :340+)
    above = (kflat
             & (flat[:, 0] > t_min[0]) & (flat[:, 0] < t_max[0])
             & (flat[:, 1] > t_min[1]) & (flat[:, 1] < t_max[1])
             & (dist > cfg.delta_z))
    proj = flat - dist[:, None] * plane[:3][None, :]
    above = above & in_radial_hull(hull, proj[:, :2])
    labels = euclidean_cluster(flat, above, cfg.object_cluster_tolerance, k=cfg.cluster_knn)
    obj_masks, obj_sizes = top_clusters(labels, above, cfg.max_objects, min_size=cfg.object_cluster_min_pts)

    # per-object centre and lowest z, all objects at once
    w = obj_masks.to(flat.dtype)  # (O, N)
    obj_centers = torch.sum(w[:, :, None] * flat[None], dim=1) / torch.clamp_min(w.sum(1, keepdim=True), 1.0)
    obj_zmin = torch.where(obj_masks, flat[None, :, 2], big).amin(dim=1)
    kept = (obj_zmin <= t_max[2] + cfg.object_min_distance_from_table) & (obj_sizes > 0) & found
    return SRPlaneClusters(
        found=found, plane=plane,
        table_inliers=(table_full & found).reshape(points.shape[:2]),
        keep_mask=keep, table_min=t_min, table_max=t_max,
        object_masks=obj_masks & kept[:, None], object_sizes=torch.where(kept, obj_sizes, 0),
        object_centers=obj_centers,
    )


def split_table_detection(
    det: SRPlaneClusters,
    points: torch.Tensor,  # (H, W, 3) the same organized cloud
) -> Tuple[np.ndarray, List[PointCloud]]:
    """``table_msg_split.cpp`` counterpart: a TableWithObjects-shaped
    result splits into the table polygon and one PointCloud per object
    cluster (the node republishes table->table as a PolygonStamped and
    each objects[i].points as its own cloud, :81-95).  The clouds live on
    ``points``' device."""
    flat = points.reshape(-1, 3).cpu().numpy()
    table_pts = flat[det.table_inliers.reshape(-1).cpu().numpy()]
    # polygon: xy hull vertices of the table inliers (convex, CCW)
    if len(table_pts):
        from scipy.spatial import ConvexHull

        try:
            poly = table_pts[ConvexHull(table_pts[:, :2]).vertices][:, :2]
        except Exception:  # degenerate footprint (collinear or < 3 points)
            poly = table_pts[:1, :2]
    else:
        poly = np.zeros((0, 2), np.float32)
    clouds = []
    for m, sz in zip(det.object_masks.cpu().numpy(), det.object_sizes.cpu().numpy()):
        if sz > 0:
            clouds.append(PointCloud.from_numpy(flat[m], device=points.device))
    return poly, clouds
