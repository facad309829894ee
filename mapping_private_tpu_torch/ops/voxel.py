"""Voxel-grid downsampling — sort-based segment means per occupied cell.

Counterpart of ``mapping_private_tpu/ops/voxel.py`` (the reference's
``cloud_geometry::downsamplePointCloud`` / ``pcl::VoxelGrid``).  Points
sort stably by a packed cell key; runs of equal keys become output slots
(cumsum of run-start flags); coordinates and channels are summed into the
fixed-capacity output with ``index_add_`` into ``out_capacity + 1`` rows,
the last one a spill row for points past the capacity.  ``voxel_downsample``
sums in float64 and rounds each mean to float32 once: the centroid is then
the nearest float32 to the exact mean, whatever order the card's atomic
adds take, where float32 sums move it by up to ~4e-7 m from run to run.  Output rows are in
ascending key order, as in the JAX package, and carry a ``vox_count``
channel.

The JAX package carries the coordinates through ``lax.sort`` (a TPU
choice); here the stable sort returns the permutation and one gather
moves every column.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from mapping_private_tpu_torch.core.cloud import PAD_COORD, PointCloud
from mapping_private_tpu_torch.ops.neighbors import _KEY_SENTINEL, _cell_key


def _columns(cloud: PointCloud) -> Tuple[torch.Tensor, List[Tuple[str, int]]]:
    """(N, 3 + C) float32 values (xyz, then every channel's columns) and
    each channel's (name, column count; 0 for a 1-D channel)."""
    cols, layout = [cloud.xyz], []
    for name, v in cloud.channels.items():
        layout.append((name, 0 if v.ndim == 1 else v.shape[1]))
        cols.append(v.reshape(v.shape[0], -1).to(torch.float32))
    return torch.cat(cols, dim=1), layout


def _channels(mean: torch.Tensor, layout: List[Tuple[str, int]]) -> dict:
    out, c0 = {}, 3
    for name, ncols in layout:
        width = max(ncols, 1)
        block = mean[:, c0 : c0 + width]
        out[name] = block[:, 0] if ncols == 0 else block
        c0 += width
    return out


def voxel_downsample(cloud: PointCloud, voxel_size: float, out_capacity: int) -> PointCloud:
    """Downsample to per-voxel centroids.

    Args:
      cloud: input PointCloud (capacity N).
      voxel_size: cell edge length.
      out_capacity: capacity of the result; occupied voxels beyond this
        many (in key order) are dropped.

    Returns:
      PointCloud of voxel centroids with channel means carried over and a
      ``vox_count`` channel (points per voxel, float32).
    """
    dev = cloud.xyz.device
    cs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    cell = torch.floor(cloud.xyz / cs).to(torch.int32)
    keys = torch.where(cloud.mask, _cell_key(cell), _KEY_SENTINEL)
    skeys, order = torch.sort(keys, stable=True)
    vals, layout = _columns(cloud)
    live = skeys != _KEY_SENTINEL

    first = torch.ones_like(live)
    first[1:] = skeys[1:] != skeys[:-1]
    first &= live
    slot = torch.cumsum(first, 0, dtype=torch.int64) - 1
    slot = torch.where(live & (slot < out_capacity), slot, out_capacity)  # spill row

    sums = torch.zeros((out_capacity + 1, vals.shape[1]), dtype=torch.float64, device=dev)
    sums.index_add_(0, slot, torch.where(live[:, None], vals[order], 0.0).to(torch.float64))
    cnt = torch.zeros((out_capacity + 1,), dtype=torch.int32, device=dev)
    cnt.index_add_(0, slot, live.to(torch.int32))
    sums, cnt = sums[:out_capacity], cnt[:out_capacity]

    mean = (sums / torch.clamp_min(cnt, 1).to(torch.float64)[:, None]).to(torch.float32)
    out_mask = cnt > 0
    out_xyz = torch.where(out_mask[:, None], mean[:, :3], PAD_COORD)
    channels = _channels(mean, layout)
    channels["vox_count"] = cnt.to(torch.float32)
    return PointCloud(xyz=out_xyz, mask=out_mask, channels=channels)


def voxel_downsample_dense(
    cloud: PointCloud,
    voxel_size: float,
    origin,
    dims: Tuple[int, int, int],
    out_capacity: int,
) -> PointCloud:
    """Sort-free voxel downsample for bounded scenes: sums and counts are
    scattered into a dense (dx·dy·dz) cell array, and occupied cells are
    compacted by a cumsum.  Output rows are in linear cell order (x-major);
    points outside the grid are dropped; cells beyond ``out_capacity``
    spill, as in ``voxel_downsample``.  No ``vox_count`` channel."""
    dev = cloud.xyz.device
    dx, dy, dz = dims
    D = dx * dy * dz
    o = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    rel = (cloud.xyz - o) / torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    idx = torch.floor(rel).to(torch.int64)
    in_range = (cloud.mask & torch.all(idx >= 0, dim=-1)
                & (idx[:, 0] < dx) & (idx[:, 1] < dy) & (idx[:, 2] < dz))
    lin = torch.where(in_range, idx[:, 0] * (dy * dz) + idx[:, 1] * dz + idx[:, 2], D)

    vals, layout = _columns(cloud)
    sums = torch.zeros((D + 1, vals.shape[1]), dtype=torch.float32, device=dev)
    sums.index_add_(0, lin, torch.where(in_range[:, None], vals, 0.0))
    cnt = torch.zeros((D + 1,), dtype=torch.int32, device=dev)
    cnt.index_add_(0, lin, in_range.to(torch.int32))
    occ = cnt[:D] > 0
    slot = torch.cumsum(occ, 0, dtype=torch.int64) - 1
    slot = torch.where(occ & (slot < out_capacity), slot, out_capacity)
    # only the spill row receives more than one cell, and it is cut off
    out_sums = torch.zeros((out_capacity + 1, vals.shape[1]), dtype=torch.float32, device=dev)
    out_sums[slot] = sums[:D]
    out_cnt = torch.zeros((out_capacity + 1,), dtype=torch.int32, device=dev)
    out_cnt[slot] = cnt[:D]
    out_sums, out_cnt = out_sums[:out_capacity], out_cnt[:out_capacity]

    mask = out_cnt > 0
    mean = out_sums / torch.clamp_min(out_cnt, 1).to(torch.float32)[:, None]
    xyz = torch.where(mask[:, None], mean[:, :3], PAD_COORD)
    return PointCloud(xyz=xyz, mask=mask, channels=_channels(mean, layout))
