"""Typed tensors: PointCloud, the dense VoxelGrid, SE(3) poses, small fixed-size solves."""
from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.core.se3 import (
    se3_apply,
    se3_compose,
    se3_exp,
    se3_identity,
    se3_inverse,
    se3_log,
)
from mapping_private_tpu_torch.core.voxelgrid import VoxelGrid

__all__ = [
    "PointCloud",
    "VoxelGrid",
    "se3_exp",
    "se3_log",
    "se3_identity",
    "se3_compose",
    "se3_inverse",
    "se3_apply",
]
