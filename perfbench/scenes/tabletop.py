"""A Kinect's VGA frames of a table with objects, as a closed ring.

Each frame is ``points_per_frame`` points on the table top (with depth
noise), on the objects (boxes: top and four sides; cylinders: the
mantle), on the floor and on a wall, each surface's share of the points
in proportion to its area, shuffled.  Frame k of the ring is moved in x,
y by min(k, R - k) times ``shift_per_frame_m``: out and back, so that
consecutive frames, the wrap included, are one step apart and the table
memory keeps matching one table.  Every frame is a fresh sampling.
"""
from __future__ import annotations

import numpy as np


def frame(cfg: dict, rng: np.random.Generator, shift) -> np.ndarray:
    """(N, 3) float32 points of one frame, moved by ``shift`` (x, y)."""
    s = cfg["scene_geometry"]
    n_all = cfg["points_per_frame"]
    hx, hy = s["table_half_m"]
    tz = s["table_z_m"]
    sides = lambda dx, dy, h: (dx + dy) * 2 * h  # noqa: E731
    areas = [4 * hx * hy]
    for ob in s["objects"]:
        size = ob["size_m"]
        areas.append(size[0] * size[1] + sides(*size) if ob["kind"] == "box"
                     else 2 * np.pi * size[0] * size[1])
    fl, wl = s["floor_half_m"], s["wall"]
    areas += [4 * fl * fl, 2 * wl["half_width_m"] * wl["height_m"]]
    counts = np.floor(n_all * np.asarray(areas) / sum(areas)).astype(int)
    counts[-1] += n_all - counts.sum()
    top = np.column_stack([rng.uniform(-1, 1, (counts[0], 2)) * [hx, hy],
                           tz + rng.normal(0, s["depth_noise_m"], counts[0])])
    parts = [top]
    for ob, n in zip(s["objects"], counts[1:]):
        if ob["kind"] == "box":
            dx, dy, h = ob["size_m"]
            # a face by area, then a uniform point on it: top, -x, +x, -y, +y
            face = rng.choice(5, n, p=np.array([dx * dy, dy * h, dy * h, dx * h, dx * h])
                              / (dx * dy + sides(dx, dy, h)))
            p = rng.uniform(-0.5, 0.5, (n, 3)) * [dx, dy, h] + [0.0, 0.0, 0.5 * h]
            p[face == 0, 2] = h
            for f, (ax, v) in enumerate([(0, -dx / 2), (0, dx / 2), (1, -dy / 2), (1, dy / 2)], start=1):
                p[face == f, ax] = v
        else:
            r, h = ob["size_m"]
            th = rng.uniform(0, 2 * np.pi, n)
            p = np.column_stack([r * np.cos(th), r * np.sin(th), rng.uniform(0, h, n)])
        parts.append(p + [ob["x_m"], ob["y_m"], tz])
    n_floor, n_wall = counts[-2], counts[-1]
    parts.append(np.column_stack([rng.uniform(-fl, fl, (n_floor, 2)), np.zeros(n_floor)]))
    parts.append(np.column_stack([np.full(n_wall, wl["x_m"]),
                                  rng.uniform(-wl["half_width_m"], wl["half_width_m"], n_wall),
                                  rng.uniform(0, wl["height_m"], n_wall)]))
    xyz = np.concatenate(parts) + [shift[0], shift[1], 0.0]
    return xyz[rng.permutation(n_all)].astype(np.float32)


def make_ring(cfg: dict, seed: int) -> dict:
    """{"frames": [(N, 3) float32], "shifts": (R, 2)}."""
    R = cfg["ring_frames"]
    step = np.asarray(cfg["shift_per_frame_m"], np.float64)
    shifts = np.array([min(k, R - k) * step for k in range(R)])
    frames = [frame(cfg, np.random.default_rng([seed, 2, k]), shifts[k]) for k in range(R)]
    return {"frames": frames, "shifts": shifts}
