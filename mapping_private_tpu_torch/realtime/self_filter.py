"""The robot self-filter and segmentation of one Kinect frame.

The per-frame body of realtime_perception's ``KinectURDFSegmentation``
node (realtime_segmentation.cpp:73-106,252-295): the robot's meshes are
loaded once, when the filter is made (``URDFRenderer``'s start-up); each
frame then

1. forward-kinematics the links for the frame's joint state, moves the
   meshes into the camera frame and rasterises them on the device
   (``render_depth_mesh``, as ``render_robot_depth`` does);
2. cuts the robot's pixels from the frame (``background_subtract``,
   urdf_filtering.cu:30-47), smooths the rest, unprojects it and takes its
   image normals;
3. splits the live pixels into planes (``multi_plane_ransac``, 1-point
   hypotheses, :265-295) with uniforms drawn from the caller's generator;
4. segments the normal image (``segment_normal_image``, :259).

Everything stays on the device; the caller reads back what it needs.
Spans (``utils/metrics.py``): ``selffilter`` around the frame, and
``selffilter.render``, ``selffilter.cut`` (the cut, smoothing,
unprojection and normals), ``selffilter.ransac`` and
``selffilter.segment``; counter ``selffilter.ransac_rounds`` (rounds of
the plane search, a host int).

Not exported from ``realtime`` (its ``__all__`` mirrors the JAX package,
which has no such entry): import ``mapping_private_tpu_torch.realtime.self_filter``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.realtime.depth import background_subtract, depth_to_cloud, smooth_depth_image
from mapping_private_tpu_torch.realtime.render import render_depth_mesh
from mapping_private_tpu_torch.realtime.segmentation import (
    _multi_plane_ransac, fast_normals_image, segment_normal_image)
from mapping_private_tpu_torch.realtime.urdf import RobotModel, _link_meshes, _mesh_triangles, _posed_vertices
from mapping_private_tpu_torch.utils.device import resolve_device
from mapping_private_tpu_torch.utils.metrics import metrics


@dataclasses.dataclass(frozen=True)
class SelfFilterSettings:
    """The node's settings (the reference's defaults where it has them)."""

    margin_m: float = 0.05  # a measurement this far behind the robot's surface is still the robot
    smooth_iterations: int = 5
    num_hypotheses: int = 1024
    max_planes: int = 6
    plane_threshold_m: float = 0.01
    min_coverage: float = 0.9
    range_bandwidth: float = 0.3
    min_segment_px: int = 30


@dataclasses.dataclass
class SelfFilterFrame:
    """One frame's results, on the device.  Images are (H, W); rows of the
    planes' labels are the image's pixels in raster order."""

    robot_depth: torch.Tensor  # the rendered robot, 0 where it is not seen
    keep: torch.Tensor  # bool, False where the robot was cut
    depth: torch.Tensor  # the cut frame smoothed, 0 = invalid
    normals: torch.Tensor  # (H, W, 3) image normals, 0 where undefined
    mask: torch.Tensor  # bool: valid with a normal, the planes' and segments' pixels
    uniforms: torch.Tensor  # (max_planes, num_hypotheses) the planes' draws
    planes: torch.Tensor  # (max_planes, 4) [n, d], zeros in unused slots
    plane_labels: torch.Tensor  # (H·W,) int32, -1 = in no plane
    plane_count: torch.Tensor  # 0-d int32
    plane_seeds: torch.Tensor  # (max_planes,) int64: each plane's hypothesis pixel, -1 in unused slots
    segments: torch.Tensor  # int32: the least pixel of the segment, H·W for none


class KinectSelfFilter:
    """``KinectURDFSegmentation`` for a stream of frames of one camera."""

    def __init__(
        self,
        robot: RobotModel,
        camera_from_root: np.ndarray,
        image_shape: Tuple[int, int] = (480, 640),
        fx: float = 525.0,
        fy: float = 525.0,
        settings: Optional[SelfFilterSettings] = None,
        *,
        device: torch.device | str = "cuda",
    ):
        self.device = resolve_device(device)
        self.robot, self.image_shape, self.fx, self.fy = robot, tuple(image_shape), fx, fy
        self.settings = settings or SelfFilterSettings()
        self.camera_from_root = np.asarray(camera_from_root, np.float64)
        # which links the kinematic tree reaches does not depend on the joint state
        self._meshes = _link_meshes(robot, robot.forward_kinematics())
        self._triangles = (torch.from_numpy(_mesh_triangles(self._meshes)).to(self.device)
                           if self._meshes else None)

    def _render(self, joint_values: Optional[Dict[str, float]]) -> torch.Tensor:
        """The robot's (H, W) depth image for a joint state, 0 where it is not seen."""
        if self._triangles is None:
            return torch.zeros(self.image_shape, dtype=torch.float32, device=self.device)
        poses = self.robot.forward_kinematics(joint_values)
        verts = torch.from_numpy(_posed_vertices(self._meshes, poses, self.camera_from_root)).to(self.device)
        return render_depth_mesh(verts, self._triangles, self.image_shape, fx=self.fx, fy=self.fy)

    def process(self, depth_m: np.ndarray, joint_values: Optional[Dict[str, float]],
                generator: Optional[torch.Generator]) -> SelfFilterFrame:
        """One frame: ``depth_m`` (H, W) metres on the host (0 = no
        reading) and the joint state it was taken at."""
        s = self.settings
        with metrics.span("selffilter"):
            with metrics.span("selffilter.render"):
                robot = self._render(joint_values)
            with metrics.span("selffilter.cut"):
                meas = torch.as_tensor(depth_m, dtype=torch.float32).to(self.device)
                keep = background_subtract(meas, robot, s.margin_m)
                depth = smooth_depth_image(torch.where(keep, meas, 0.0), s.smooth_iterations)
                points, valid = depth_to_cloud(depth, fx=self.fx, fy=self.fy)
                normals = fast_normals_image(points, valid)
                mask = valid & (torch.linalg.vector_norm(normals, dim=-1) > 0.5)  # a unit normal, not 0
            with metrics.span("selffilter.ransac"):
                u = torch.rand((s.max_planes, s.num_hypotheses), generator=generator, device=self.device)
                planes, labels, count, seeds, rounds = _multi_plane_ransac(
                    points.reshape(-1, 3), normals.reshape(-1, 3), mask.reshape(-1), None, s.num_hypotheses,
                    s.max_planes, s.plane_threshold_m, s.min_coverage, u)
                metrics.count("selffilter.ransac_rounds", rounds)
            with metrics.span("selffilter.segment"):
                segments = segment_normal_image(normals, mask, s.range_bandwidth, s.min_segment_px)
        return SelfFilterFrame(robot, keep, depth, normals, mask, u, planes, labels, count, seeds, segments)
