"""VoxelGrid — dense fixed-shape voxelization of a PointCloud.

Counterpart of ``mapping_private_tpu/core/voxelgrid.py`` (the reference's
``pcl::VoxelGrid`` as the C3-HLAC extractor and the sliding-box search use
it).  Every point adds its count and channels into one dense
(Dx, Dy, Dz) grid with ``index_add_``; dead and out-of-range rows go to a
spill voxel that is sliced off.

Counts and integer colour sums are exact in f32.  Other sums (the
``_xyz`` centroid sums) are not: ``index_add_`` on CUDA is atomic, so its
order, and the last bits of such a sum, vary from run to run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from mapping_private_tpu_torch.core.cloud import PointCloud


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Dense voxel grid.

    Attributes:
      origin: (3,) grid origin in world coordinates.
      voxel_size: scalar edge length.
      count: (Dx, Dy, Dz) int32 points-per-voxel.
      sums:  dict of per-voxel channel accumulators, each (Dx, Dy, Dz) or
             (Dx, Dy, Dz, C); divide by count for means.
    """

    origin: torch.Tensor
    voxel_size: torch.Tensor
    count: torch.Tensor
    sums: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(self.count.shape)  # type: ignore[return-value]

    def occupancy(self) -> torch.Tensor:
        return self.count > 0

    def mean(self, name: str) -> torch.Tensor:
        c = torch.clamp_min(self.count, 1).to(torch.float32)
        s = self.sums[name]
        if s.ndim == 4:
            c = c[..., None]
        return s / c


def voxelize(
    cloud: PointCloud,
    voxel_size: float,
    origin,
    dims: Tuple[int, int, int],
    channels: Tuple[str, ...] = (),
) -> VoxelGrid:
    """Scatter points into a dense grid of ``dims`` voxels.

    Points outside [origin, origin + dims*voxel_size) and dead rows go to
    a spill voxel that is sliced off before returning, so the result only
    holds in-range mass.
    """
    dx, dy, dz = (int(d) for d in dims)
    dev = cloud.xyz.device
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    idx = torch.floor((cloud.xyz - origin) / voxel_size)
    in_range = (
        cloud.mask
        & torch.all(idx >= 0, dim=-1)
        & (idx[:, 0] < dx)
        & (idx[:, 1] < dy)
        & (idx[:, 2] < dz)
    )
    # dead rows hold PAD_COORD: clamp before the cast so no cast overflows
    idx = torch.where(in_range[:, None], idx, 0.0).to(torch.int64)
    spill = dx * dy * dz
    lin = torch.where(in_range, idx[:, 0] * (dy * dz) + idx[:, 1] * dz + idx[:, 2], spill)

    count = torch.zeros(spill + 1, dtype=torch.int32, device=dev)
    count.index_add_(0, lin, in_range.to(torch.int32))
    sums = {}
    for name in channels:
        v = cloud.channels[name]
        v2 = v[:, None] if v.ndim == 1 else v
        acc = torch.zeros((spill + 1, v2.shape[1]), dtype=v2.dtype, device=dev)
        acc.index_add_(0, lin, torch.where(in_range[:, None], v2, 0))
        acc = acc[:spill]
        sums[name] = acc.reshape((dx, dy, dz) + tuple(v.shape[1:]))
    return VoxelGrid(
        origin=origin,
        voxel_size=torch.tensor(voxel_size, dtype=torch.float32, device=dev),
        count=count[:spill].reshape(dx, dy, dz),
        sums=sums,
    )
