"""Cylinder RANSAC and triangulation — the reference's ``CylinderEstimation``.

Counterpart of ``mapping_private_tpu/fit/cylinder.py`` (reference
cloud_algos/src/cylinder_fit_algo.cpp: RANSAC over ``SACModelCylinder``
with threshold 0.01 on points + normals, :45-47; the mesh of
``triangulate_cylinder``, :117-122).  A hypothesis from two points with
normals: the axis is the cross product of the normals, the axis point the
midpoint of the normal lines' common perpendicular, the radius the first
sample's distance to the axis.  All H hypotheses are scored as one (H, N)
pass; two refinement sweeps re-estimate the radius and the axis point
from the inliers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.fit.ransac import sample_live_indices, score_hypotheses


@dataclasses.dataclass(frozen=True)
class Cylinder:
    """point: (3,) a point on the axis; axis: (3,) unit direction;
    radius: scalar; k_min/k_max: height bounds along the axis from ``point``."""

    point: torch.Tensor
    axis: torch.Tensor
    radius: torch.Tensor
    k_min: torch.Tensor
    k_max: torch.Tensor


def point_to_axis_distance(xyz: torch.Tensor, point: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (...) distance to the line (point, axis); axis unit."""
    rel = xyz - point
    along = torch.sum(rel * axis, dim=-1, keepdim=True)
    return torch.linalg.norm(rel - along * axis, dim=-1)


def _closest_point_between_lines(p1, d1, p2, d2) -> torch.Tensor:
    """Midpoint of the common-perpendicular segment of two lines, batched
    (LineToLineSegment, sac_model_rotational.cpp:110-160)."""
    w = p1 - p2
    a = torch.sum(d1 * d1, -1)
    b = torch.sum(d1 * d2, -1)
    c = torch.sum(d2 * d2, -1)
    d = torch.sum(d1 * w, -1)
    e = torch.sum(d2 * w, -1)
    den = a * c - b * b
    ok = den > 1e-12
    den = torch.where(ok, den, 1.0)
    sc = torch.where(ok, (b * e - c * d) / den, 0.0)
    tc = torch.where(ok, (a * e - b * d) / den, 0.0)
    return 0.5 * ((p1 + sc[..., None] * d1) + (p2 + tc[..., None] * d2))


def fit_cylinder_ransac(
    xyz: torch.Tensor,
    normals: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 512,
    threshold: float = 0.01,
    normal_weight: float = 0.1,
    min_radius: float = 0.0,
    max_radius: float = math.inf,
    method: str = "msac",
    u: Optional[torch.Tensor] = None,
) -> Tuple[Cylinder, torch.Tensor]:
    """RANSAC cylinder over a masked point set with normals.

    Distance per point = (1−w)·|dist_to_axis − r| + w·r·angle(n, radial),
    the normal-distance blend of the reference's SAC cylinder model.
    ``u`` (num_hypotheses, 2) replaces the generator's uniforms.

    Returns (Cylinder, inliers (N,) bool).
    """
    idx = sample_live_indices(generator, mask, (num_hypotheses, 2), u)
    p1, p2 = xyz[idx[:, 0]], xyz[idx[:, 1]]
    n1, n2 = normals[idx[:, 0]], normals[idx[:, 1]]

    ax = torch.linalg.cross(n1, n2)  # (H,3)
    axlen = torch.linalg.norm(ax, dim=-1, keepdim=True)
    degenerate = axlen[:, 0] < 1e-6  # parallel normals
    ax = ax / torch.clamp_min(axlen, 1e-30)
    apt = _closest_point_between_lines(p1, n1, p2, n2)  # (H,3)
    rad = point_to_axis_distance(p1, apt, ax)  # (H,)

    rel = xyz[None, :, :] - apt[:, None, :]  # (H,N,3)
    along = torch.sum(rel * ax[:, None, :], dim=-1)  # (H,N)
    perp = rel - along[..., None] * ax[:, None, :]
    pd = torch.linalg.norm(perp, dim=-1)  # (H,N) distance to the axis
    dists = torch.abs(pd - rad[:, None])
    if normal_weight > 0.0:
        radial = perp / torch.clamp_min(pd[..., None], 1e-12)
        cosang = torch.clip(torch.abs(torch.sum(radial * normals[None, :, :], dim=-1)), 0.0, 1.0)
        dists = (1.0 - normal_weight) * dists + normal_weight * rad[:, None] * torch.arccos(cosang)
    scores = score_hypotheses(dists, mask, threshold, method)
    bad = degenerate | (rad < min_radius) | (rad > max_radius)
    best = torch.argmax(torch.where(bad, -1.0, scores))
    apt_b, ax_b, rad_b = apt[best], ax[best], rad[best]

    # refinement: inlier-mean radius, axis point moved to the inlier centroid's
    # projection on the axis (2 sweeps)
    for _ in range(2):
        d = point_to_axis_distance(xyz, apt_b, ax_b)
        w = ((torch.abs(d - rad_b) < threshold) & mask).to(xyz.dtype)
        cnt = torch.clamp_min(torch.sum(w), 3.0)
        rad_b = torch.sum(d * w) / cnt
        cen = torch.sum(xyz * w[:, None], dim=0) / cnt
        apt_b = apt_b + torch.dot(cen - apt_b, ax_b) * ax_b

    d = point_to_axis_distance(xyz, apt_b, ax_b)
    inliers = (torch.abs(d - rad_b) < threshold) & mask
    k = torch.sum((xyz - apt_b) * ax_b, dim=-1)
    cyl = Cylinder(point=apt_b, axis=ax_b, radius=rad_b,
                   k_min=torch.amin(torch.where(inliers, k, 1e9)),
                   k_max=torch.amax(torch.where(inliers, k, -1e9)))
    return cyl, inliers


def cylinder_mesh(point, axis, radius: float, k_min: float, k_max: float,
                  segments: int = 24) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side triangulation of a fitted cylinder (the reference's
    ``triangulate_cylinder``): (vertices (2*segments, 3), triangles
    (2*segments, 3) int32)."""
    point = np.asarray(torch.as_tensor(point).cpu(), np.float64)
    axis = np.asarray(torch.as_tensor(axis).cpu(), np.float64)
    axis = axis / np.linalg.norm(axis)
    seed = np.array([1.0, 0.0, 0.0]) if abs(axis[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(axis, seed)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    ang = 2.0 * np.pi * np.arange(segments) / segments
    ring = radius * (np.outer(np.cos(ang), u) + np.outer(np.sin(ang), v))
    verts = np.vstack([point + k_min * axis + ring, point + k_max * axis + ring]).astype(np.float32)
    tris = []
    for i in range(segments):
        j = (i + 1) % segments
        tris.append([i, j, segments + i])
        tris.append([j, segments + j, segments + i])
    return verts, np.asarray(tris, np.int32)
