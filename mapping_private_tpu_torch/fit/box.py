"""Oriented-box estimation — the reference's ``RobustBoxEstimation``.

Counterpart of ``mapping_private_tpu/fit/box.py`` (the box fits of the
table-memory reconstruction chain, dyn_obj_store/src/table_memory.cpp:20-25,
:277-280, :437-444): a gravity-aligned (z-up) box from the principal axis
of the cluster's xy covariance, and a free-orientation box from its 3-D
PCA.  Masked reductions and closed-form eigenvectors only.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.ops.normals import smallest_eigenvector_3x3


@dataclasses.dataclass(frozen=True)
class OrientedBox:
    """center (3,), axes (3,3) rows = unit box axes, extents (3,) full widths."""

    center: torch.Tensor
    axes: torch.Tensor
    extents: torch.Tensor


def _masked_cov(pts: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    w = mask.to(pts.dtype)[:, None]
    cnt = torch.clamp_min(torch.sum(w), 1.0)
    mean = torch.sum(pts * w, dim=0) / cnt
    d = (pts - mean) * w
    return d.T @ d / cnt, mean, cnt


def fit_box_zup(xyz: torch.Tensor, mask: torch.Tensor) -> OrientedBox:
    """Gravity-aligned box: yaw from the xy covariance's principal axis, the
    z extent from the height range (box_fit2's convention for objects
    standing on a support plane)."""
    cov, _, _ = _masked_cov(xyz[:, :2], mask)
    theta = 0.5 * torch.atan2(2.0 * cov[0, 1], cov[0, 0] - cov[1, 1])
    ct, st = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(ct), torch.ones_like(ct)
    axes = torch.stack([torch.stack([ct, st, zero]), torch.stack([-st, ct, zero]),
                        torch.stack([zero, zero, one])])
    return _box_from_axes(xyz, mask, axes)


def fit_box_pca(xyz: torch.Tensor, mask: torch.Tensor) -> OrientedBox:
    """Free-orientation box from the full 3-D PCA of the cluster."""
    cov, _, _ = _masked_cov(xyz, mask)
    # the smallest eigenvector, then deflation for the middle axis
    _, v0 = smallest_eigenvector_3x3(cov)
    P = torch.eye(3, dtype=cov.dtype, device=cov.device) - torch.outer(v0, v0)
    cov2 = P @ cov @ P + torch.outer(v0, v0) * (torch.trace(cov) + 1.0)
    _, v1 = smallest_eigenvector_3x3(cov2)
    v1 = v1 - torch.dot(v1, v0) * v0
    v1 = v1 / torch.clamp_min(torch.linalg.norm(v1), 1e-12)
    v2 = torch.linalg.cross(v0, v1)
    return _box_from_axes(xyz, mask, torch.stack([v2, v1, v0]))  # major, middle, minor


def _box_from_axes(xyz: torch.Tensor, mask: torch.Tensor, axes: torch.Tensor) -> OrientedBox:
    proj = xyz @ axes.T  # (N,3) coordinates in the box frame
    lo = torch.amin(torch.where(mask[:, None], proj, 1e9), dim=0)
    hi = torch.amax(torch.where(mask[:, None], proj, -1e9), dim=0)
    center = (0.5 * (lo + hi)) @ axes
    return OrientedBox(center=center, axes=axes, extents=torch.clamp_min(hi - lo, 0.0))


def box_mesh(box_center, box_axes, box_extents) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side 8-vertex/12-triangle mesh of an OrientedBox (arrays or
    tensors)."""
    c, A, e = (np.asarray(torch.as_tensor(v).cpu(), np.float64) for v in (box_center, box_axes, box_extents))
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    verts = (c + (corners * 0.5 * e) @ A).astype(np.float32)
    tris = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 7, 5], [4, 6, 7],  # +x
            [0, 5, 1], [0, 4, 5],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        np.int32,
    )
    return verts, tris
