"""Neighbour search, normals, the NN kernels and the 1-NN front door,
voxel downsampling, filters, region growing and MLS smoothing."""
from mapping_private_tpu_torch.ops.filters import (
    axis_parallel_normal_mask,
    axis_perpendicular_normal_mask,
    box_filter,
    box_filter_mask,
    channel_equal_mask,
    remove_statistical_outliers,
    statistical_outlier_mask,
    z_band_mask,
)
from mapping_private_tpu_torch.ops.mls import mls, mls_smooth
from mapping_private_tpu_torch.ops.neighbors import (
    GridHash,
    build_grid_hash,
    knn_bruteforce,
    knn_grid,
    pairwise_sq_dists,
    radius_count_grid,
)
from mapping_private_tpu_torch.ops.nn_dispatch import choose_nn_engine, nn_1nn
from mapping_private_tpu_torch.ops.normals import estimate_normals, smallest_eigenvector_3x3
from mapping_private_tpu_torch.ops.region_growing import region_grow
from mapping_private_tpu_torch.ops.voxel import voxel_downsample

__all__ = [
    "pairwise_sq_dists",
    "knn_bruteforce",
    "GridHash",
    "build_grid_hash",
    "knn_grid",
    "radius_count_grid",
    "voxel_downsample",
    "estimate_normals",
    "smallest_eigenvector_3x3",
    "statistical_outlier_mask",
    "remove_statistical_outliers",
    "box_filter_mask",
    "box_filter",
    "axis_parallel_normal_mask",
    "axis_perpendicular_normal_mask",
    "z_band_mask",
    "channel_equal_mask",
    "region_grow",
    "mls",
    "mls_smooth",
    "nn_1nn",
    "choose_nn_engine",
]
