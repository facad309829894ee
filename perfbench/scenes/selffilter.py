"""A robot's head Kinect watching its own arm over a table, as a closed ring.

The static scene (a wall, the floor, a table top with two boxes and two
cylinders) is rendered once; the robot is rendered for each of the
``ring_frames`` joint states, a reach out and back along ``trajectory``
(frame k at min(k, R - k) / (R / 2) of the way), each moving joint
jittered from the seed by up to ``jitter_rad``.  A frame is what the
Kinect reads: the nearer of robot and scene, its disparity rounded to the
sensor's step.  Everything is made by the reference's own float64
rasteriser (``perfbench/references/selffilter_frames.py``), on the card
where there is one, and the robot's images are kept for the check.  Every
ring frame shows the robot on at least ``min_robot_share`` of its pixels.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.references import selffilter_frames as ref


def make_ring(cfg: dict, seed: int) -> dict:
    """{"frames": [(H, W) float32 depth images], "joints": [{joint: value}], "robot_depth",
    "robot_part": the reference's robot images, "camera_from_root": (4, 4),
    "meshes": {path: (T, 3, 3) float32 triangles of an STL file}}."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    files = ref.mesh_files(cfg)
    robot = ref.Robot("\n".join(cfg["robot"]["urdf"]), files)
    scene = ref.render_scene(cfg, torch.float64, device)
    rng = np.random.default_rng([seed, 18])
    R = cfg["ring_frames"]
    ring = {"frames": [], "joints": [], "robot_depth": [], "robot_part": [],
            "camera_from_root": ref.camera_from_root(cfg), "meshes": files}
    for k in range(R):
        t = min(k, R - k) / (R / 2)
        q = {name: a + t * (b - a) for name, (a, b) in cfg["trajectory"].items()}
        for name, amp in cfg["jitter_rad"].items():
            q[name] += float(rng.uniform(-amp, amp))
        depth, part = ref.render_robot(cfg, robot, q, torch.float64, device)
        frame = ref.kinect_frame(cfg, depth, scene)
        seen = float(((depth > 0) & ((depth <= scene) | (scene == 0))).double().mean())
        if seen < cfg["min_robot_share"]:
            raise ValueError(f"ring frame {k}: the robot shows on {seen:.4f} of the pixels, "
                             f"under {cfg['min_robot_share']}")
        ring["frames"].append(frame)
        ring["joints"].append(q)
        ring["robot_depth"].append(depth.cpu().numpy())
        ring["robot_part"].append(part.cpu().numpy())
    return ring
