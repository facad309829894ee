"""Point-cloud filters — noise removal, box clipping, normal-direction gates.

Counterpart of ``mapping_private_tpu/ops/filters.py``:

- ``StatisticalNoiseRemoval`` (reference noise_removal.cpp:73-150): mean
  distance to the k nearest neighbours, kept within mean ± alpha·std over
  the live points, with the reference's minimum-output validity flag;
- the ``box_filter`` node (cloud_tools/src/box_filter.cpp);
- the axis-parallel / axis-perpendicular normal gates of
  ``cloud_geometry`` (table_object_detector_passive.cpp:396,
  wall_filter.cpp:228), the height band, channel equality and the depth
  limit of the training-capture tool.

All filters are mask transforms: shapes stay.  Inside the statistical
filter the live rows are compacted for the search, and its mask is over
every row.
Angle thresholds are taken in float32, as the JAX package takes them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.core.linalg import f32_of
from mapping_private_tpu_torch.ops.knn_kbest import K_MAX, knn_kbest, live_rows
from mapping_private_tpu_torch.ops.neighbors import build_grid_hash, knn_bruteforce, knn_grid
from mapping_private_tpu_torch.utils.metrics import metrics


def statistical_outlier_mask(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    k: int = 30,
    alpha: float = 1.0,
    use_grid: bool = False,
    cell_size: float = 0.05,
) -> torch.Tensor:
    """Keep-mask for the mean-kNN-distance outlier filter.

    Per point: mean distance to its k nearest live neighbours (self
    excluded, as noise_removal.cpp:104 skips index 0).  Globally: keep
    |d_i − mean| < alpha · std over the live points (noise_removal.cpp:130).
    Brute force searches the live rows only, through ``knn_kbest`` (the
    kernel on the card) for k ≤ K_MAX; a larger k runs over every row of
    ``xyz``, dead ones included.
    """
    if use_grid:
        grid = build_grid_hash(xyz, mask, cell_size)
        self_idx = torch.arange(xyz.shape[0], dtype=torch.int32, device=xyz.device)
        idx, sq = knn_grid(grid, xyz, k=k, self_idx=self_idx)
        avg = _mean_dist(sq, (idx >= 0) & torch.isfinite(sq))
    elif k <= K_MAX:
        rows, rt = live_rows(xyz, mask)
        _count_pairs(rows.shape[0], mask)
        with metrics.span("knn"):
            sq = knn_kbest(rt, k)
        avg = torch.zeros(xyz.shape[0], dtype=torch.float32, device=xyz.device)
        avg.index_put_((rows,), _mean_dist(sq, torch.isfinite(sq)))
    else:
        _count_pairs(xyz.shape[0], mask)
        idx, sq = knn_bruteforce(xyz, xyz, mask, k=k, exclude_self=True)
        avg = _mean_dist(sq, (idx >= 0) & torch.isfinite(sq))

    live = mask.to(torch.float32)
    n_live = torch.clamp_min(torch.sum(live), 1.0)
    mean = torch.sum(avg * live) / n_live
    var = torch.sum(avg * avg * live) / n_live - mean * mean
    std = torch.sqrt(torch.clamp_min(var, 0.0))
    return mask & (torch.abs(avg - mean) < alpha * std)


def _count_pairs(searched: int, mask: torch.Tensor) -> None:
    """The brute search's pairs (``searched`` rows against as many), and
    of those the ones that join two live points."""
    metrics.count("denoise.pairs", searched * searched)
    if metrics.on():
        metrics.count("denoise.live_pairs", torch.sum(mask, dtype=torch.int64) ** 2)


def _mean_dist(sq: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, k) squared distances -> (N,) mean distance over the valid slots
    (0 where none is)."""
    d = torch.where(valid, torch.sqrt(torch.clamp_min(sq, 0.0)), 0.0)
    cnt = torch.clamp_min(torch.sum(valid, dim=1, dtype=torch.float32), 1.0)
    return torch.sum(d, dim=1) / cnt


def remove_statistical_outliers(
    cloud: PointCloud,
    k: int = 30,
    alpha: float = 1.0,
    min_nr_pts: int = 0,
    use_grid: bool = False,
    cell_size: float = 0.05,
) -> Tuple[PointCloud, torch.Tensor]:
    """Filtered cloud + validity flag (a 0-d bool tensor: count ≥
    min_nr_pts, the reference's output gate at noise_removal.cpp:145-150)."""
    with metrics.span("denoise"):
        keep = statistical_outlier_mask(cloud.padded_xyz(), cloud.mask, k=k, alpha=alpha,
                                        use_grid=use_grid, cell_size=cell_size)
        out = cloud.select(keep)
        return out, out.count() >= min_nr_pts


def box_filter_mask(xyz: torch.Tensor, mask: torch.Tensor, min_corner, max_corner) -> torch.Tensor:
    """Axis-aligned box clip, faces included (cloud_tools box_filter node)."""
    lo = torch.as_tensor(min_corner, dtype=xyz.dtype, device=xyz.device)
    hi = torch.as_tensor(max_corner, dtype=xyz.dtype, device=xyz.device)
    return mask & torch.all((xyz >= lo) & (xyz <= hi), dim=-1)


def box_filter(cloud: PointCloud, min_corner, max_corner) -> PointCloud:
    with metrics.span("box_filter"):
        return cloud.select(box_filter_mask(cloud.xyz, cloud.mask, min_corner, max_corner))


def _axis_cos(normals: torch.Tensor, axis) -> torch.Tensor:
    a = torch.as_tensor(axis, dtype=normals.dtype, device=normals.device)
    return torch.abs(normals @ (a / torch.linalg.norm(a)))


def axis_parallel_normal_mask(normals: torch.Tensor, mask: torch.Tensor, axis,
                              eps_angle: float) -> torch.Tensor:
    """Points whose normal is within eps_angle of ±axis
    (getPointIndicesAxisParallelNormals)."""
    return mask & (_axis_cos(normals, axis) >= f32_of(torch.cos, eps_angle, normals.device))


def axis_perpendicular_normal_mask(normals: torch.Tensor, mask: torch.Tensor, axis,
                                   eps_angle: float) -> torch.Tensor:
    """Points whose normal is within eps_angle of the plane ⊥ axis
    (getPointIndicesAxisPerpendicularNormals, wall_filter.cpp:228):
    |cos(angle to axis)| = sin(angle to the plane)."""
    return mask & (_axis_cos(normals, axis) <= f32_of(torch.sin, eps_angle, normals.device))


def z_band_mask(xyz: torch.Tensor, mask: torch.Tensor, z_min: float, z_max: float) -> torch.Tensor:
    """Height-band filter (table_object_detector_passive.cpp:353-363)."""
    return mask & (xyz[:, 2] >= z_min) & (xyz[:, 2] <= z_max)


def channel_equal_mask(cloud: PointCloud, name: str, value: float, atol: float = 0.0) -> torch.Tensor:
    """Points whose named channel equals ``value`` (the RegionGrowing
    ``setExtraDimensionIgnore`` gate, region_growing.cpp:42-43)."""
    ch = cloud.channel(name)
    ok = ch == value if atol == 0.0 else torch.abs(ch - value) <= atol
    return cloud.mask & ok


def depth_limit_mask(xyz: torch.Tensor, mask: torch.Tensor, distance_th: float,
                     relative: bool = False) -> torch.Tensor:
    """Depth limit of the training-capture tool
    (color_voxel_recognition/test/save_data.cpp:67-83 limitPoint): keep
    z < distance_th or, in its relative mode, z < min live z + distance_th."""
    z = xyz[:, 2]
    th = torch.tensor(distance_th, dtype=torch.float32, device=xyz.device)
    if relative:
        th = torch.min(torch.where(mask, z, 3.4e38)) + th
    return mask & (z < th)
