"""A moving depth sensor's scans of one surface, as a closed ring.

The world is a height field z = a sin(fx x) + b cos(fy y) over a square
patch.  The sensor follows a closed loop (a circle in x, y with a
vertical and a rotational wobble) whose phases come from the seed and
whose sizes come from the configuration, so every seed does the same
work.  Each frame is a fresh sampling of the world surface expressed in
the sensor's frame: no two scans share a point.
"""
from __future__ import annotations

import numpy as np


def surface_points(cfg: dict, rng: np.random.Generator) -> np.ndarray:
    """``points_per_scan`` points of the world surface (float64, world frame)."""
    s = cfg["surface"]
    half = s["extent_m"] / 2
    xy = rng.uniform(-half, half, (cfg["points_per_scan"], 2))
    z = s["a"] * np.sin(s["fx"] * xy[:, 0]) + s["b"] * np.cos(s["fy"] * xy[:, 1])
    return np.column_stack([xy, z])


def rotation(rv: np.ndarray) -> np.ndarray:
    """Rodrigues: rotation vector (3,) -> (3, 3)."""
    th = np.linalg.norm(rv)
    if th < 1e-15:
        return np.eye(3)
    k = rv / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def ring_poses(cfg: dict, seed: int) -> np.ndarray:
    """(R, 4, 4) float64 sensor-to-world poses around the closed loop."""
    t = cfg["trajectory"]
    ph = np.random.default_rng([seed, 0]).uniform(0, 2 * np.pi, 5)
    R = cfg["ring_frames"]
    poses = np.tile(np.eye(4), (R, 1, 1))
    for j in range(R):
        th = 2 * np.pi * j / R
        r = t["radius_m"]
        poses[j, :3, 3] = [r * (np.cos(th + ph[0]) - np.cos(ph[0])),
                           r * (np.sin(th + ph[0]) - np.sin(ph[0])),
                           t["heave_m"] * np.sin(th + ph[1])]
        poses[j, :3, :3] = rotation(t["tilt_rad"] * np.sin(th + ph[2:5]))
    return poses


def make_ring(cfg: dict, seed: int) -> dict:
    """{"frames": [(N, 3) float32 scans in the sensor frame], "poses":
    (R, 4, 4) float64}.  Scan j is world points seen from pose j."""
    poses = ring_poses(cfg, seed)
    frames = []
    for j, P in enumerate(poses):
        world = surface_points(cfg, np.random.default_rng([seed, 1, j]))
        frames.append(((world - P[:3, 3]) @ P[:3, :3]).astype(np.float32))
    return {"frames": frames, "poses": poses}
