"""End-to-end feature extraction pipelines (cloud → descriptor vectors).

Counterpart of ``mapping_private_tpu/features/extract.py`` (the
reference's example_GRSD_CCHLAC.cpp:9-86 and computeFeature.cpp:40-160):
normals → voxelize at 0.01 m → RSD → surface types → GRSD-20 +
ColorCHLAC-117/981 → concat.

``legacy_zeroth_scale`` halves bins [0:6] and [63:69] of the 117 part,
the doubled 0th-order normalizers of the build that wrote the
reference's golden corpus (color_chlac.h:22-29).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.core.voxelgrid import VoxelGrid, voxelize
from mapping_private_tpu_torch.features.colorchlac import (
    colorchlac117,
    colorchlac981,
    to_reference_layout_981,
)
from mapping_private_tpu_torch.features.rsd import (
    ERA_NORMALS_RADIUS,
    ERA_NR_SUBDIV,
    get_type,
    get_type_era,
    grsd20_era,
    rsd_radii_pcl,
)
from mapping_private_tpu_torch.ops.normals import estimate_normals_radius

VOXEL_SIZE = 0.01  # example_GRSD_CCHLAC.cpp:15
RSD_RADIUS = max(0.01, VOXEL_SIZE / 2 * float(np.sqrt(3)))  # tools.hpp:170
NORMALS_RADIUS = 0.02  # grsd_colorCHLAC_tools.h:28


def voxelize_for_features(
    cloud: PointCloud, voxel_size: float = VOXEL_SIZE, dim_bucket: int = 8,
    dim_floor: int = 0,
) -> VoxelGrid:
    """PCL-compatible grid: origin at floor(min/leaf)*leaf, dims to the
    max, rounded up to a multiple of ``dim_bucket`` and at least
    ``dim_floor`` a side.  The extra voxels are empty, and every feature
    downstream is invariant to them (out-of-grid and empty neighbours
    count alike); the parameters are the JAX package's, whose compiler
    reused one program across similar grids.  The ``_xyz`` sums give the
    voxel centroids (the RSD query points) as grid.mean("_xyz")."""
    xyz = cloud.to_numpy()["xyz"]
    mn = np.floor(xyz.min(0) / voxel_size) * voxel_size
    dims = (np.floor(xyz.max(0) / voxel_size) - np.floor(xyz.min(0) / voxel_size)).astype(int) + 1
    if dim_bucket > 1:
        dims = -(-dims // dim_bucket) * dim_bucket
    if dim_floor:
        dims = np.maximum(dims, dim_floor)
    cloud = cloud.with_channel("_xyz", cloud.padded_xyz())
    return voxelize(
        cloud, voxel_size, torch.tensor(mn, dtype=torch.float32), tuple(int(d) for d in dims),
        channels=("r", "g", "b", "_xyz"),
    )


def _centroid_radii(cloud: PointCloud, grid: VoxelGrid, normals_radius: float, k_normals: int,
                    k_rsd: int, nr_subdiv: int):
    k_normals = min(k_normals, cloud.capacity)
    k_rsd = min(k_rsd, cloud.capacity)
    normals = estimate_normals_radius(cloud, radius=normals_radius, k_cap=k_normals).channel("normal")
    # only the occupied voxels are queried (each query row is independent,
    # and an empty voxel's radii are (0, 0)); the JAX package queries
    # every voxel of its fixed-shape grid
    occ = torch.nonzero(grid.occupancy().reshape(-1))[:, 0]
    centroids = grid.mean("_xyz").reshape(-1, 3)[occ]
    r_occ = rsd_radii_pcl(centroids, torch.ones_like(occ, dtype=torch.bool), cloud.padded_xyz(), cloud.mask,
                          normals, radius=RSD_RADIUS, k=k_rsd, nr_subdiv=nr_subdiv)
    out = []
    for r in r_occ:
        full = torch.zeros(grid.count.numel(), dtype=r.dtype, device=r.device)
        full[occ] = r
        out.append(full)
    return out


def voxel_types(
    cloud: PointCloud,
    grid: VoxelGrid,
    voxel_size: float = VOXEL_SIZE,
    k_normals: int = 544,
    k_rsd: int = 192,
) -> torch.Tensor:
    """(X,Y,Z) int32 surface-type grid by per-voxel RSD, the reference
    snapshot's chain: normals by radius search 0.02 on the full cloud
    (computeNormal, tools.hpp:157-186), RSD per occupied voxel centroid
    against the full cloud at radius max(0.01, leaf/2·√3)
    (``rsd_radii_pcl``).  ``voxel_types_era`` is the golden corpus's
    chain.  ``k_normals``/``k_rsd`` cap the neighbour gathers."""
    r_min, r_max = _centroid_radii(cloud, grid, NORMALS_RADIUS, k_normals, k_rsd, 5)
    return get_type(r_min, r_max).reshape(grid.dims)


def voxel_types_era(
    cloud: PointCloud,
    grid: VoxelGrid,
    k_normals: int = 544,
    k_rsd: int = 192,
) -> torch.Tensor:
    """(X,Y,Z) int32 era surface-type grid, the golden-corpus generation
    build's chain: normals radius 0.01, RSD with nr_subdiv=4, classifier
    get_type_era."""
    r_min, r_max = _centroid_radii(cloud, grid, ERA_NORMALS_RADIUS, k_normals, k_rsd, ERA_NR_SUBDIV)
    return get_type_era(r_min, r_max).reshape(grid.dims)


def _halve_zeroth(c: torch.Tensor) -> torch.Tensor:
    c = c.clone()
    c[0:6] *= 0.5
    c[63:69] *= 0.5
    return c


def extract_grsd_cchlac(
    cloud: PointCloud,
    voxel_size: float = VOXEL_SIZE,
    thresholds: Tuple[int, int, int] = (127, 127, 127),
    legacy_zeroth_scale: bool = False,
) -> torch.Tensor:
    """(137,) = GRSD-20 ++ ColorCHLAC-117, the golden-file format (its
    GRSD part in the era convention, see grsd20_era)."""
    grid = voxelize_for_features(cloud, voxel_size)
    types = voxel_types_era(cloud, grid)
    g = grsd20_era(types, grid.occupancy())
    c = colorchlac117(grid, thresholds)
    if legacy_zeroth_scale:
        c = _halve_zeroth(c)
    return torch.cat([g, c])


def extract_colorchlac117(
    cloud: PointCloud,
    voxel_size: float = VOXEL_SIZE,
    thresholds: Tuple[int, int, int] = (127, 127, 127),
    legacy_zeroth_scale: bool = False,
) -> torch.Tensor:
    grid = voxelize_for_features(cloud, voxel_size)
    c = colorchlac117(grid, thresholds)
    return _halve_zeroth(c) if legacy_zeroth_scale else c


def extract_colorchlac981(
    cloud: PointCloud,
    voxel_size: float = VOXEL_SIZE,
    thresholds: Tuple[int, int, int] = (127, 127, 127),
    layout: str = "own",
) -> torch.Tensor:
    """981-dim rotation-variant C3-HLAC; layout="reference" returns the
    reference's interleaved bin order."""
    grid = voxelize_for_features(cloud, voxel_size)
    f = colorchlac981(grid, thresholds)
    return to_reference_layout_981(f) if layout == "reference" else f
