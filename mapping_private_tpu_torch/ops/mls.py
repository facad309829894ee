"""Moving Least Squares surface smoothing — batched weighted polynomial fits.

Counterpart of ``mapping_private_tpu/ops/mls.py`` (the reference's
``MovingLeastSquares`` op of the table-memory reconstruction chain,
dyn_obj_store/src/table_memory.cpp:20-25, :277-280, in the classical PCL
formulation): per point, a Gaussian-weighted neighbourhood plane fit →
local (u, v, n) frame → weighted order-2 bivariate height polynomial →
the point projected onto the polynomial and the normal re-derived from
its gradient.  One batched pass: kNN gather, closed-form 3×3
eigenvectors, and a 6×6 normal-equations solve per point by the unrolled
Cholesky of ``core/linalg.py``, batched over the points.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.core.linalg import cholesky_solve_unrolled
from mapping_private_tpu_torch.ops.neighbors import build_grid_hash, knn_bruteforce, knn_grid
from mapping_private_tpu_torch.ops.normals import smallest_eigenvector_3x3


def _orthonormal_tangents(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 3) unit normals → (u, v) spanning the tangent plane."""
    x_ax = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    y_ax = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    # seed u with the axis least aligned with n
    ax = torch.where(torch.abs(n[..., 0:1]) < 0.9, x_ax, y_ax)
    u = torch.linalg.cross(n, ax.expand_as(n))
    u = u / torch.clamp_min(torch.linalg.norm(u, dim=-1, keepdim=True), 1e-12)
    return u, torch.linalg.cross(n, u)


def mls_smooth(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    search_radius: float = 0.03,
    k: int = 32,
    polynomial_order: int = 2,
    sqr_gauss_param: Optional[float] = None,
    use_grid: bool = False,
    direct: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MLS-projected positions, normals and curvatures.

    Args:
      xyz: (N, 3); mask: (N,) live rows.
      search_radius: neighbourhood radius; farther neighbours get ~0 weight.
      k: neighbour fan-out (the point itself included).
      polynomial_order: 0 or 1 (plane projection only) or 2 (full MLS).
      sqr_gauss_param: Gaussian weight scale; defaults to radius².
      direct: the brute search ranks by direct differences
        (``knn_bruteforce``).

    Returns (new_xyz (N,3), normals (N,3), curvature (N,)).
    """
    if sqr_gauss_param is None:
        sqr_gauss_param = search_radius * search_radius
    if use_grid:
        idx, sq = knn_grid(build_grid_hash(xyz, mask, search_radius), xyz, k=k)
    else:
        idx, sq = knn_bruteforce(xyz, xyz, mask, k=k, exclude_self=False, direct=direct)
    valid = (idx >= 0) & mask[:, None]
    pts = xyz[torch.clamp_min(idx, 0).long()]  # (N, k, 3)
    w = torch.where(valid, torch.exp(-sq / sqr_gauss_param), 0.0)  # (N, k)

    # weighted plane fit
    wsum = torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1e-12)  # (N,1)
    mean = torch.sum(pts * w[..., None], dim=1) / wsum  # (N,3)
    d = (pts - mean[:, None, :]) * torch.sqrt(w)[..., None]
    cov = torch.einsum("nki,nkj->nij", d, d) / wsum[..., None]
    ev, nrm = smallest_eigenvector_3x3(cov)
    lam_sum = torch.clamp_min(torch.sum(ev, dim=-1), 1e-30)
    curvature = torch.clamp_min(ev[..., 0], 0.0) / lam_sum

    # orient normals towards the origin (sensor at 0, PCL's default)
    flip = torch.sign(torch.sum(nrm * (-xyz), dim=-1, keepdim=True))
    nrm = nrm * torch.where(flip == 0, 1.0, flip)

    # project the query onto the plane
    dist = torch.sum((xyz - mean) * nrm, dim=-1, keepdim=True)  # (N,1)
    plane_pt = xyz - dist * nrm
    if polynomial_order < 2:
        return torch.where(mask[:, None], plane_pt, xyz), nrm, curvature

    # order-2 height polynomial in the local frame, basis [1, u, v, u², uv, v²]
    u_ax, v_ax = _orthonormal_tangents(nrm)
    rel = pts - plane_pt[:, None, :]  # (N,k,3)
    ui = torch.einsum("nkc,nc->nk", rel, u_ax)
    vi = torch.einsum("nkc,nc->nk", rel, v_ax)
    hi = torch.einsum("nkc,nc->nk", rel, nrm)
    basis = torch.stack([torch.ones_like(ui), ui, vi, ui * ui, ui * vi, vi * vi], dim=-1)
    bw = basis * w[..., None]
    H = torch.einsum("nki,nkj->nij", bw, basis)  # (N,6,6)
    g = torch.einsum("nki,nk->ni", bw, hi)  # (N,6)
    coef = cholesky_solve_unrolled(H, g, jitter=1e-9)  # (N,6)

    # the query sits at (u, v) = (0, 0): height c0, gradient (c1, c2)
    new_pt = plane_pt + coef[:, 0:1] * nrm
    new_nrm = nrm - coef[:, 1:2] * u_ax - coef[:, 2:3] * v_ax
    new_nrm = new_nrm / torch.clamp_min(torch.linalg.norm(new_nrm, dim=-1, keepdim=True), 1e-12)
    # degenerate neighbourhoods (fewer than 6 neighbours) keep the input
    ok = (torch.sum(valid, dim=1) >= 6) & mask
    return (torch.where(ok[:, None], new_pt, xyz), torch.where(ok[:, None], new_nrm, nrm),
            curvature)


def mls(cloud: PointCloud, **kwargs) -> PointCloud:
    """PointCloud wrapper: smooths xyz, attaches normal/curvature channels."""
    new_xyz, nrm, curv = mls_smooth(cloud.padded_xyz(), cloud.mask, **kwargs)
    return (cloud.with_xyz(torch.where(cloud.mask[:, None], new_xyz, cloud.xyz))
            .with_channel("normal", nrm).with_channel("curvature", curv))
