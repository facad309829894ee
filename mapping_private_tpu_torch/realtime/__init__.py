"""Realtime Kinect layer: depth smoothing, mesh and URDF rendering, the
robot self-filter and organized-image segmentation (counterpart of
``mapping_private_tpu/realtime``)."""
from mapping_private_tpu_torch.realtime.depth import (
    depth_to_disparity,
    disparity_to_depth,
    smooth_depth_image,
    depth_to_cloud,
    background_subtract,
)
from mapping_private_tpu_torch.realtime.render import (
    boxlist_ray_intersection,
    ray_box_tmin,
    render_depth_mesh,
    render_intensity_mesh,
)
from mapping_private_tpu_torch.realtime.urdf import (
    RobotModel,
    parse_urdf,
    load_stl,
    render_robot_depth,
)
from mapping_private_tpu_torch.realtime.segmentation import (
    fast_normals_image,
    multi_plane_ransac,
    connected_components_image,
    mean_shift_normals,
    segment_normal_image,
)

__all__ = [
    "depth_to_disparity",
    "disparity_to_depth",
    "smooth_depth_image",
    "depth_to_cloud",
    "background_subtract",
    "render_depth_mesh",
    "render_intensity_mesh",
    "boxlist_ray_intersection",
    "ray_box_tmin",
    "RobotModel",
    "parse_urdf",
    "load_stl",
    "render_robot_depth",
    "fast_normals_image",
    "multi_plane_ransac",
    "connected_components_image",
    "mean_shift_normals",
    "segment_normal_image",
]
