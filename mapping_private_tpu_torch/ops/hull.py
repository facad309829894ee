"""2-D hulls and point-in-region tests with static shapes.

Counterpart of ``mapping_private_tpu/ops/hull.py`` (the reference's
``cloud_geometry::areas::convexHull2D`` + ``isPointIn2DPolygon``,
table_object_detector_passive.cpp:485, findObjectClusters :254-341).

- ``radial_hull`` / ``in_radial_hull`` — the device-side region test: the
  inlier set is binned by angle around its centroid and each bin keeps its
  largest radius; a query is inside when its radius is at most the
  largest of its bin's and its two neighbours' radii.  Points within an
  ulp of a bin edge may fall into either bin (``atan2`` rounds
  differently across libraries).
- ``convex_hull_2d``, ``polygon_area``, ``convex_polygon_intersection``,
  ``point_in_polygon`` — exact host (numpy) routines for the world-model
  boundary (TableMemory's polygon matching); the package keeps its own
  copy of the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RadialHull:
    center: torch.Tensor  # (2,)
    radii: torch.Tensor  # (B,) per-angular-bin boundary radius (0 = empty)


def _bins(rel: torch.Tensor, num_bins: int) -> torch.Tensor:
    ang = torch.atan2(rel[:, 1], rel[:, 0])  # [-pi, pi]
    b = ((ang + math.pi) / (2.0 * math.pi) * num_bins).to(torch.int64)
    return torch.clamp(b, 0, num_bins - 1)


def radial_hull(xy: torch.Tensor, mask: torch.Tensor, num_bins: int = 72) -> RadialHull:
    w = mask.to(xy.dtype)[:, None]
    cnt = torch.clamp_min(torch.sum(w), 1.0)
    center = torch.sum(xy * w, dim=0) / cnt
    rel = xy - center
    r = torch.linalg.norm(rel, dim=-1)
    b = torch.where(mask, _bins(rel, num_bins), num_bins)
    radii = torch.zeros((num_bins + 1,), dtype=xy.dtype, device=xy.device)
    radii.scatter_reduce_(0, b, torch.where(mask, r, 0.0), "amax")
    return RadialHull(center=center, radii=radii[:num_bins])


def in_radial_hull(hull: RadialHull, xy: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """(Q,2) → (Q,) bool membership (radius test against the query's bin
    and its two neighbours' largest, smoothing empty-bin seams)."""
    num_bins = hull.radii.shape[0]
    rel = xy - hull.center
    r = torch.linalg.norm(rel, dim=-1)
    b = _bins(rel, num_bins)
    rad = torch.maximum(hull.radii[b], torch.maximum(hull.radii[(b + 1) % num_bins],
                                                     hull.radii[(b - 1) % num_bins]))
    return r <= rad + margin


def convex_hull_2d(xy: np.ndarray) -> np.ndarray:
    """Exact convex hull (host/numpy), CCW order.  Andrew monotone chain."""
    pts = np.asarray(xy, dtype=np.float64)
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area of a CCW polygon (host)."""
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def convex_polygon_intersection(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two convex CCW polygons via Sutherland–Hodgman
    clipping (host).  The in-process replacement for the reference's
    `/intersect_poly` ROS service (table_memory.cpp:286-330).

    Returns the clipped polygon (V,2); empty (0,2) if disjoint."""
    subject = [tuple(p) for p in np.asarray(a, np.float64)]
    clip = np.asarray(b, np.float64)
    if len(subject) < 3 or len(clip) < 3:
        return np.zeros((0, 2))
    for i in range(len(clip)):
        e0, e1 = clip[i], clip[(i + 1) % len(clip)]
        edge = (e1[0] - e0[0], e1[1] - e0[1])

        def inside(p):
            return edge[0] * (p[1] - e0[1]) - edge[1] * (p[0] - e0[0]) >= 0

        def intersect(p, q):
            dp = (q[0] - p[0], q[1] - p[1])
            denom = edge[0] * dp[1] - edge[1] * dp[0]
            if abs(denom) < 1e-30:
                return q
            t = (edge[0] * (e0[1] - p[1]) - edge[1] * (e0[0] - p[0])) / denom
            return (p[0] + t * dp[0], p[1] + t * dp[1])

        out = []
        for j in range(len(subject)):
            cur, nxt = subject[j], subject[(j + 1) % len(subject)]
            if inside(cur):
                out.append(cur)
                if not inside(nxt):
                    out.append(intersect(cur, nxt))
            elif inside(nxt):
                out.append(intersect(cur, nxt))
        subject = out
        if not subject:
            return np.zeros((0, 2))
    return np.asarray(subject)


def point_in_polygon(poly: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Vectorized crossing-number test (host). poly (V,2), pts (Q,2)."""
    x, y = pts[:, 0][:, None], pts[:, 1][:, None]
    x0, y0 = poly[:, 0][None, :], poly[:, 1][None, :]
    x1, y1 = np.roll(poly[:, 0], -1)[None, :], np.roll(poly[:, 1], -1)[None, :]
    cross = ((y0 > y) != (y1 > y)) & (
        x < (x1 - x0) * (y - y0) / np.where(y1 == y0, 1e-30, y1 - y0) + x0
    )
    return np.sum(cross, axis=1) % 2 == 1
