"""Neighbour search, normals, the NN kernels and the 1-NN front door."""
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

__all__ = [
    "pairwise_sq_dists",
    "knn_bruteforce",
    "GridHash",
    "build_grid_hash",
    "knn_grid",
    "radius_count_grid",
    "estimate_normals",
    "smallest_eigenvector_3x3",
    "nn_1nn",
    "choose_nn_engine",
]
