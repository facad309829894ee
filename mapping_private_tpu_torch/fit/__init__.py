"""Model fitting: batched-hypothesis RANSAC (planes, 2-D lines and
circles, cylinders) and oriented boxes."""
from mapping_private_tpu_torch.fit.box import OrientedBox, box_mesh, fit_box_pca, fit_box_zup
from mapping_private_tpu_torch.fit.cylinder import (
    Cylinder,
    cylinder_mesh,
    fit_cylinder_ransac,
    point_to_axis_distance,
)
from mapping_private_tpu_torch.fit.ransac import (
    fit_circle2d_ransac,
    fit_line2d_ransac,
    fit_plane_ransac,
    sample_live_indices,
    score_hypotheses,
)

__all__ = [
    "fit_plane_ransac",
    "fit_line2d_ransac",
    "fit_circle2d_ransac",
    "sample_live_indices",
    "score_hypotheses",
    "Cylinder",
    "fit_cylinder_ransac",
    "cylinder_mesh",
    "point_to_axis_distance",
    "OrientedBox",
    "fit_box_zup",
    "fit_box_pca",
    "box_mesh",
]
