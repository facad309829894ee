"""Rotational-surface RANSAC — ``SACModelRotational``.

Counterpart of ``mapping_private_tpu/fit/rotational.py``
(ias_sample_consensus sac_model_rotational.cpp and the RANSAC loop of
cloud_algos/src/rotational_estimation.cpp:30-160).  The model is an axis
line and a polynomial radius profile r(k) of the distance to the axis as
a function of the position k along it; a point's residual is
|dist_to_axis − |r(k)|| (PointToRotationalDistance :73-97).

H hypotheses at once: each takes S sampled points with normals and
builds the axis from the closest-approach midpoints of normal lines
(every normal of a surface of revolution meets the axis), solves its
(order+1)² contour normal equations with the unrolled Cholesky, and all
points are scored against all hypotheses as one (H, N) pass.  The winner
is polished by a fixed number of damped Gauss-Newton steps on the axis
(in place of the reference's lmdif1) with an inlier contour re-fit after
each; the steps are a host loop that reads nothing back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mapping_private_tpu_torch.core.linalg import cholesky_solve_unrolled
from mapping_private_tpu_torch.fit.cylinder import _closest_point_between_lines
from mapping_private_tpu_torch.fit.ransac import sample_live_indices, score_hypotheses

POLY_ORDER = 5  # the reference's polynomial_order (degree-5 contour)


@dataclasses.dataclass(frozen=True)
class RotationalSurface:
    """point (3,) on axis, axis (3,) unit, coeffs (POLY_ORDER+1,) radius
    polynomial in the scaled coordinate k/k_scale, k_scale scalar."""

    point: torch.Tensor
    axis: torch.Tensor
    coeffs: torch.Tensor
    k_scale: torch.Tensor


def _axis_coords(xyz: torch.Tensor, point: torch.Tensor, axis: torch.Tensor):
    """k (position along axis) and y (distance to axis) per point."""
    rel = xyz - point
    k = rel @ axis
    y = torch.linalg.norm(rel - k[..., None] * axis, dim=-1)
    return k, y


def _poly_eval(coeffs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """coeffs (..., D+1), t (..., M) → Σ coeffs[w] t^w (Horner), (..., M)."""
    r = torch.zeros_like(t)
    for w in reversed(range(coeffs.shape[-1])):
        r = r * t + coeffs[..., w, None]
    return r


def _fit_contour(k, y, w, k_scale) -> torch.Tensor:
    """Weighted LS radius polynomial (order POLY_ORDER) of y against
    t = k/k_scale, batched over leading axes: k, y, w (..., M), k_scale
    (...) → coeffs (..., D+1) (EstimateContourFromSamples' LLT solve)."""
    t = k / k_scale[..., None]
    powers = torch.stack([t**i for i in range(POLY_ORDER + 1)], dim=-1)  # (..., M, D+1)
    bw = powers * w[..., None]
    H = bw.transpose(-1, -2) @ powers
    g = (bw.transpose(-1, -2) @ (y * w)[..., None])[..., 0]
    return cholesky_solve_unrolled(H, g, jitter=1e-6)


def rotational_distance(surf: RotationalSurface, xyz: torch.Tensor) -> torch.Tensor:
    """|y − |r(k)|| per point (PointToRotationalDistance :73-97)."""
    k, y = _axis_coords(xyz, surf.point, surf.axis)
    return torch.abs(y - torch.abs(_poly_eval(surf.coeffs, k / surf.k_scale)))


def _line_line_distance(a_pt, a_dir, p, n) -> torch.Tensor:
    """Distance between the axis line and each point-normal line — the
    residual lmdif1 minimized (functionToOptimizeAxis)."""
    cross = torch.linalg.cross(a_dir.expand_as(n), n)  # (N,3)
    cl = torch.linalg.norm(cross, dim=-1)
    w = p - a_pt
    num = torch.abs(torch.sum(w * cross, dim=-1))
    # parallel lines: distance of p to the axis line
    par_d = torch.linalg.norm(w - (w @ a_dir)[..., None] * a_dir, dim=-1)
    return torch.where(cl > 1e-9, num / torch.clamp_min(cl, 1e-12), par_d)


def fit_rotational_ransac(
    xyz: torch.Tensor,
    normals: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 256,
    samples_per_hyp: int = 8,
    threshold: float = 0.01,
    gn_iters: int = 6,
    method: str = "msac",
    u: Optional[torch.Tensor] = None,
) -> Tuple[RotationalSurface, torch.Tensor]:
    """Batched rotational-surface RANSAC; ``u`` (num_hypotheses,
    samples_per_hyp) replaces the generator's uniforms.

    Returns (RotationalSurface, inliers (N,) bool)."""
    idx = sample_live_indices(generator, mask, (num_hypotheses, samples_per_hyp), u)
    sp, sn = xyz[idx], normals[idx]  # (H,S,3)

    # axis from the closest-approach midpoints of normal-line pairs (0,1)
    # and (0,2): both lie on the axis of an exact surface of revolution
    m01 = _closest_point_between_lines(sp[:, 0], sn[:, 0], sp[:, 1], sn[:, 1])
    m02 = _closest_point_between_lines(sp[:, 0], sn[:, 0], sp[:, 2], sn[:, 2])
    ax = m02 - m01
    axlen = torch.linalg.norm(ax, dim=-1, keepdim=True)
    # fallback for coincident midpoints: the cross of the two normals
    alt = torch.linalg.cross(sn[:, 0], sn[:, 1])
    altlen = torch.linalg.norm(alt, dim=-1, keepdim=True)
    use_alt = axlen[:, 0] < 1e-6
    ax = torch.where(use_alt[:, None], alt / torch.clamp_min(altlen, 1e-30),
                     ax / torch.clamp_min(axlen, 1e-30))
    degenerate = use_alt & (altlen[:, 0] < 1e-9)
    apt = m01  # (H,3)

    # per-hypothesis contour through its S samples
    rel = sp - apt[:, None, :]
    k = torch.sum(rel * ax[:, None, :], dim=-1)  # (H,S)
    y = torch.linalg.norm(rel - k[..., None] * ax[:, None, :], dim=-1)
    kscale = torch.clamp_min(torch.amax(torch.abs(k), dim=-1), 1e-3)
    coeffs = _fit_contour(k, y, torch.ones_like(k), kscale)  # (H,D+1)

    # score all points against all hypotheses
    rel = xyz[None, :, :] - apt[:, None, :]  # (H,N,3)
    k = torch.sum(rel * ax[:, None, :], dim=-1)  # (H,N)
    y = torch.linalg.norm(rel - k[..., None] * ax[:, None, :], dim=-1)
    dists = torch.abs(y - torch.abs(_poly_eval(coeffs, k / kscale[:, None])))
    scores = score_hypotheses(dists, mask, threshold, method)
    # a contour solve can overflow to NaN when a hypothesis' samples all
    # sit at one k (the normal equations are then near rank 1); argmax
    # would take a NaN score as the best, so such a hypothesis is
    # degenerate too
    scores = torch.where(degenerate | ~torch.isfinite(scores), -1.0, scores)
    best = torch.argmax(scores)
    a_pt, a_dir, c_cur, ks_cur = apt[best], ax[best], coeffs[best], kscale[best]

    # polish: damped GN on the axis over the current inliers
    def axis_residuals(params, w):
        d = params[3:] / torch.clamp_min(torch.linalg.norm(params[3:]), 1e-12)
        return _line_line_distance(params[:3], d, xyz, normals) * w

    for _ in range(gn_iters):
        surf = RotationalSurface(point=a_pt, axis=a_dir, coeffs=c_cur, k_scale=ks_cur)
        w = ((rotational_distance(surf, xyz) < threshold) & mask).to(xyz.dtype)
        params = torch.cat([a_pt, a_dir])
        res = axis_residuals(params, w)
        J = torch.func.jacfwd(axis_residuals)(params, w)  # (N,6)
        step = cholesky_solve_unrolled(J.T @ J, J.T @ res, jitter=1e-6)
        # the system has two null directions (the point's slide along the
        # axis, the axis vector's scale) that the 1e-6 jitter holds only
        # while J^T J is small; on large clouds the f32 solve can overflow,
        # and then the axis stays where it is
        params = params - torch.where(torch.isfinite(step).all(), step, 0.0)
        a_dir = params[3:] / torch.clamp_min(torch.linalg.norm(params[3:]), 1e-12)
        # the point may slide far along the axis (a metre on a 20,000-point
        # vase), which leaves the contour a polynomial over a sliver of t:
        # put it back at the inliers' axial centroid, the same line
        k_n = (xyz - params[:3]) @ a_dir
        a_pt = params[:3] + (torch.sum(k_n * w) / torch.clamp_min(torch.sum(w), 1.0)) * a_dir
        # contour re-fit on the inliers with the new axis (kept only if finite)
        k_n, y_n = _axis_coords(xyz, a_pt, a_dir)
        ks_n = torch.clamp_min(torch.amax(torch.abs(k_n) * w), 1e-3)
        c_n = _fit_contour(k_n, y_n, w, ks_n)
        fin = torch.isfinite(c_n).all() & torch.isfinite(ks_n)
        c_cur, ks_cur = torch.where(fin, c_n, c_cur), torch.where(fin, ks_n, ks_cur)

    surf = RotationalSurface(point=a_pt, axis=a_dir, coeffs=c_cur, k_scale=ks_cur)
    return surf, (rotational_distance(surf, xyz) < threshold) & mask
