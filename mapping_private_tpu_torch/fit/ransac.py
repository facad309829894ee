"""Batched-hypothesis RANSAC — serial SAC loops turned into one batch.

Counterpart of ``mapping_private_tpu/fit/ransac.py`` (the reference's
``sample_consensus`` loops: fitSACPlane at
table_object_detector_passive.cpp:415, cylinder_fit_algo.cpp:45-47, the
2-D fitters of hough_segmentation/include/ransac.hpp:75-191).  All H
hypotheses are drawn at once, every point is scored against every
hypothesis as one (H, N) computation, and the argmax wins.

Randomness: each sampler takes a ``torch.Generator`` or, in its place,
the uniforms ``u`` in [0, 1) it would draw (shape (..., H, m) for m
points a hypothesis).  The draws do not depend on the mask, so feeding
the JAX package's ``jax.random.uniform`` values reproduces its samples
row for row.  Leading batch dimensions of ``mask`` (and ``u``) fit one
model per row, e.g. one plane per table candidate.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mapping_private_tpu_torch.core.linalg import f32_of
from mapping_private_tpu_torch.ops.normals import smallest_eigenvector_3x3


def sample_live_indices(
    generator: Optional[torch.Generator],
    mask: torch.Tensor,
    shape: Tuple[int, ...],
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Indices drawn uniformly from the live rows of ``mask`` (..., N):
    the inverse CDF of the mask at u·count (searchsorted, right side).
    Returns (..., *shape) int64; ``u`` (..., *shape) replaces the draw."""
    batch = mask.shape[:-1]
    cdf = torch.cumsum(mask, dim=-1, dtype=torch.float32)
    if u is None:
        u = torch.rand(batch + tuple(shape), generator=generator, device=mask.device)
    flat = u.reshape(*batch, -1) * cdf[..., -1:]
    idx = torch.searchsorted(cdf, flat.contiguous(), right=True)
    return torch.clamp(idx, 0, mask.shape[-1] - 1).reshape(u.shape)


def score_hypotheses(dists: torch.Tensor, mask: torch.Tensor, threshold: float,
                     method: str = "ransac") -> torch.Tensor:
    """(..., H, N) absolute distances → (..., H) score, higher is better:
    the inlier count ('ransac') or the truncated-quadratic MSAC gain
    ('msac')."""
    valid = mask[..., None, :]
    if method == "ransac":
        return torch.sum((dists < threshold) & valid, dim=-1, dtype=torch.float32)
    if method == "msac":
        t2 = threshold * threshold
        loss = torch.where(valid, torch.clamp_max(dists * dists, t2), 0.0)
        return torch.sum(t2 - loss, dim=-1) / t2
    raise ValueError(method)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (..., H, C) at idx (...) along H → (..., C)."""
    return torch.gather(t, -2, idx[..., None, None].expand(*idx.shape, 1, t.shape[-1]))[..., 0, :]


def fit_plane_ransac(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 256,
    threshold: float = 0.02,
    axis: Optional[torch.Tensor] = None,
    eps_angle: Optional[float] = None,
    method: str = "msac",
    refine_iters: int = 2,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC plane fit over a masked point set.

    Args:
      xyz: (N, 3); mask: (..., N) live rows, one fit per leading index.
      axis/eps_angle: optional constraint — a hypothesis normal must lie
        within eps_angle (radians) of ±axis.
      refine_iters: total-least-squares re-fits on the inlier set.
      u: (..., num_hypotheses, 3) uniforms in place of the generator's.

    Returns plane (..., 4) [nx, ny, nz, d] with unit normal, n·p + d = 0,
    and inliers (..., N) bool.
    """
    idx = sample_live_indices(generator, mask, (num_hypotheses, 3), u)
    p0, p1, p2 = xyz[idx[..., 0]], xyz[idx[..., 1]], xyz[idx[..., 2]]  # (..., H, 3)
    nrm = torch.linalg.cross(p1 - p0, p2 - p0)
    nlen = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    degenerate = nlen[..., 0] < 1e-12
    nrm = nrm / torch.clamp_min(nlen, 1e-30)
    d = -torch.sum(nrm * p0, dim=-1)  # (..., H)

    dists = torch.abs(nrm @ xyz.T + d[..., None])  # (..., H, N)
    scores = torch.where(degenerate, -1.0, score_hypotheses(dists, mask, threshold, method))
    if axis is not None and eps_angle is not None:
        ax = torch.as_tensor(axis, dtype=xyz.dtype, device=xyz.device)
        cos_ok = torch.abs(nrm @ ax) >= f32_of(torch.cos, eps_angle, xyz.device)
        scores = torch.where(cos_ok, scores, -1.0)
    best = torch.argmax(scores, dim=-1)
    plane = torch.cat([_take(nrm, best), _take(d[..., None], best)], dim=-1)

    def plane_dist(plane):  # (..., 4) -> (..., N)
        return torch.abs((xyz @ plane[..., :3, None])[..., 0] + plane[..., 3:])

    for _ in range(refine_iters):
        inl = (plane_dist(plane) < threshold) & mask
        w = inl.to(xyz.dtype)[..., None]  # (..., N, 1)
        cnt = torch.clamp_min(torch.sum(w, dim=-2), 3.0)  # (..., 1)
        mean = torch.sum(xyz * w, dim=-2) / cnt
        dc = (xyz - mean[..., None, :]) * w
        cov = dc.transpose(-1, -2) @ dc / cnt[..., None]
        _, n2 = smallest_eigenvector_3x3(cov)
        # keep the orientation of the previous estimate
        n2 = n2 * torch.sign(torch.sum(n2 * plane[..., :3], dim=-1, keepdim=True) + 1e-30)
        plane = torch.cat([n2, -torch.sum(n2 * mean, dim=-1, keepdim=True)], dim=-1)
    return plane, (plane_dist(plane) < threshold) & mask


def fit_line2d_ransac(
    xy: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 256,
    threshold: float = 0.01,
    method: str = "msac",
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC 2-D line (hough_segmentation/include/ransac.hpp:75-104).
    Returns line (3,) [nx, ny, c] with n·p + c = 0 (unit normal) and the
    inliers; ``u`` is (num_hypotheses, 2)."""
    idx = sample_live_indices(generator, mask, (num_hypotheses, 2), u)
    p0, p1 = xy[idx[:, 0]], xy[idx[:, 1]]
    t = p1 - p0
    tlen = torch.linalg.norm(t, dim=-1, keepdim=True)
    degenerate = tlen[:, 0] < 1e-12
    t = t / torch.clamp_min(tlen, 1e-30)
    nrm = torch.stack([-t[:, 1], t[:, 0]], dim=-1)  # (H,2)
    c = -torch.sum(nrm * p0, dim=-1)
    dists = torch.abs(xy @ nrm.T + c[None, :]).T
    scores = torch.where(degenerate, -1.0, score_hypotheses(dists, mask, threshold, method))
    best = torch.argmax(scores)
    line = torch.cat([nrm[best], c[best][None]])
    return line, (torch.abs(xy @ line[:2] + line[2]) < threshold) & mask


def fit_circle2d_ransac(
    xy: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 256,
    threshold: float = 0.01,
    min_radius: float = 0.0,
    max_radius: float = math.inf,
    method: str = "msac",
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC 2-D circle from 3-point circumcircles (hough_segmentation
    ransac.hpp:127-191).  Returns circle (3,) [cx, cy, r] and the inliers;
    ``u`` is (num_hypotheses, 3)."""
    idx = sample_live_indices(generator, mask, (num_hypotheses, 3), u)
    a, b, c = xy[idx[:, 0]], xy[idx[:, 1]], xy[idx[:, 2]]
    # circumcentre by the perpendicular-bisector solve
    d = 2.0 * (a[:, 0] * (b[:, 1] - c[:, 1]) + b[:, 0] * (c[:, 1] - a[:, 1])
               + c[:, 0] * (a[:, 1] - b[:, 1]))
    degenerate = torch.abs(d) < 1e-12
    d = torch.where(degenerate, 1.0, d)
    a2, b2, c2 = (torch.sum(p * p, -1) for p in (a, b, c))
    ux = (a2 * (b[:, 1] - c[:, 1]) + b2 * (c[:, 1] - a[:, 1]) + c2 * (a[:, 1] - b[:, 1])) / d
    uy = (a2 * (c[:, 0] - b[:, 0]) + b2 * (a[:, 0] - c[:, 0]) + c2 * (b[:, 0] - a[:, 0])) / d
    center = torch.stack([ux, uy], -1)  # (H,2)
    radius = torch.linalg.norm(a - center, dim=-1)  # (H,)
    dc = torch.linalg.norm(xy[None, :, :] - center[:, None, :], dim=-1)  # (H,N)
    scores = score_hypotheses(torch.abs(dc - radius[:, None]), mask, threshold, method)
    bad = degenerate | (radius < min_radius) | (radius > max_radius)
    best = torch.argmax(torch.where(bad, -1.0, scores))
    circle = torch.stack([center[best, 0], center[best, 1], radius[best]])
    dist = torch.abs(torch.linalg.norm(xy - circle[:2], dim=-1) - circle[2])
    return circle, (dist < threshold) & mask
