"""Scan registration: point-to-plane ICP, scan-to-map tracking and
pose-graph relaxation."""
from mapping_private_tpu_torch.registration.icp import (
    ICPResult,
    ate_rmse,
    icp_point_to_plane,
)
from mapping_private_tpu_torch.registration.pose_graph import (
    build_normal_equations,
    edge_residual,
    optimize_pose_graph,
)

__all__ = [
    "ICPResult",
    "icp_point_to_plane",
    "ate_rmse",
    "edge_residual",
    "build_normal_equations",
    "optimize_pose_graph",
]
