"""Normal & curvature estimation — batched closed-form 3×3 eigenanalysis.

Counterpart of ``mapping_private_tpu/ops/normals.py``: kNN gather →
masked covariance → analytic smallest eigenvector (Eberly's trigonometric
eigenvalues, then Cayley–Hamilton for the vector) → viewpoint-consistent
sign.  Curvature is λ₀ / (λ₀+λ₁+λ₂), the reference's convention.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.ops.neighbors import build_grid_hash, knn_bruteforce, knn_grid
from mapping_private_tpu_torch.utils.metrics import metrics


def eigvals_sym3x3(A: torch.Tensor) -> torch.Tensor:
    """Analytic eigenvalues of symmetric (..., 3, 3), ascending order."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 1e-30))
    r = torch.clip(torch.linalg.det(B) / (2.0 * p**3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return torch.stack([e3, e2, e1], dim=-1)


def smallest_eigenvector_3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest eigenpair of symmetric (..., 3, 3).

    Returns (eigvals ascending (...,3), eigvec (...,3) unit-norm).  The
    columns of (A−λ₁I)(A−λ₂I) are parallel to the λ₀-eigenvector; the
    largest-norm column is taken.  Degenerate (isotropic) neighbourhoods
    fall back to the z axis — their curvature flags them anyway.
    """
    ev = eigvals_sym3x3(A)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = (A - ev[..., 1, None, None] * eye) @ (A - ev[..., 2, None, None] * eye)
    norms = torch.sum(M * M, dim=-2)  # (..., 3) column squared norms
    col = torch.argmax(norms, dim=-1)
    vec = torch.gather(M, -1, col[..., None, None].expand(*M.shape[:-1], 1))[..., 0]
    n = torch.linalg.norm(vec, dim=-1, keepdim=True)
    fallback = torch.zeros_like(vec)
    fallback[..., 2] = 1.0
    vec = torch.where(n > 1e-12, vec / torch.clamp_min(n, 1e-30), fallback)
    return ev, vec


def normals_from_neighbors(
    xyz: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_valid: torch.Tensor,
    viewpoint: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Covariance normals from precomputed neighbour lists.

    xyz (N,3), nbr_idx (N,k) int (−1 invalid), nbr_valid (N,k) bool,
    viewpoint (3,) sensor origin for the sign (default 0).
    Returns (normals (N,3), curvature (N,)).
    """
    pts = xyz[torch.clamp_min(nbr_idx, 0).long()]  # (N,k,3)
    w = nbr_valid.to(xyz.dtype)[..., None]
    cnt = torch.clamp_min(torch.sum(w, dim=1), 1.0)  # (N,1)
    mean = torch.sum(pts * w, dim=1) / cnt
    d = (pts - mean[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", d, d) / cnt[..., None]
    ev, nrm = smallest_eigenvector_3x3(cov)
    lam_sum = torch.clamp_min(torch.sum(ev, dim=-1), 1e-30)
    curvature = torch.clamp_min(ev[..., 0], 0.0) / lam_sum
    to_vp = -xyz if viewpoint is None else viewpoint[None, :] - xyz
    flip = torch.sign(torch.sum(nrm * to_vp, dim=-1, keepdim=True))
    flip = torch.where(flip == 0, 1.0, flip)
    return nrm * flip, curvature


def estimate_normals_radius(
    cloud: PointCloud,
    radius: float,
    k_cap: int = 64,
    viewpoint: Optional[torch.Tensor] = None,
) -> PointCloud:
    """Radius-search normals (PCL ``NormalEstimation`` parity): the
    covariance runs over all neighbours within ``radius`` including the
    query itself.  ``k_cap`` must exceed the densest neighbourhood."""
    xyz = cloud.padded_xyz()
    idx, sq = knn_bruteforce(xyz, xyz, cloud.mask, k=k_cap)
    valid = (idx >= 0) & (sq <= radius * radius) & cloud.mask[:, None]
    nrm, curv = normals_from_neighbors(xyz, idx, valid, viewpoint)
    return cloud.with_channel("normal", nrm).with_channel("curvature", curv)


def estimate_normals(
    cloud: PointCloud,
    k: int = 20,
    viewpoint: Optional[torch.Tensor] = None,
    use_grid: bool = False,
    cell_size: float = 0.05,
) -> PointCloud:
    """Attach 'normal' (N,3) and 'curvature' (N,) channels from the k
    nearest other points: brute force, or with ``use_grid`` the grid hash
    of cell ``cell_size`` (exact when the k-th neighbour lies within one
    cell and no stencil cell overflows; for large clouds)."""
    with metrics.span("normals"):
        xyz = cloud.padded_xyz()
        if use_grid:
            grid = build_grid_hash(xyz, cloud.mask, cell_size)
            self_idx = torch.arange(xyz.shape[0], dtype=torch.int32, device=xyz.device)
            idx, _ = knn_grid(grid, xyz, k=k, self_idx=self_idx)
        else:
            idx, _ = knn_bruteforce(xyz, xyz, cloud.mask, k=k, exclude_self=True)
        valid = (idx >= 0) & cloud.mask[:, None]
        nrm, curv = normals_from_neighbors(xyz, idx, valid, viewpoint)
        return cloud.with_channel("normal", nrm).with_channel("curvature", curv)
