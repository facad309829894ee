"""Orientation RANSAC — ``SACModelOrientation``.

Counterpart of ``mapping_private_tpu/fit/orientation.py``
(ias_sample_consensus sac_model_orientation.h:59-213): the dominant pair
of perpendicular directions, ⊥ to a fixed axis (usually gravity z), that
most point normals align with — the Manhattan-frame estimator for
box-like furniture.

- A hypothesis is one sampled normal (computeModelCoefficients :124-138),
  dismissed unless it is ⊥ the axis within the threshold
  (selectWithinDistance :206-217).
- Inliers are normals within angle θ of any of {d, −d, axis×d, −axis×d}
  (the four radius searches :226-256).
- The refit averages the inliers rotated into the front direction
  (refitModel :141+), re-orthogonalized against the axis.

Every hypothesis is scored against every normal as one (H, N) product.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mapping_private_tpu_torch.core.linalg import f32_of
from mapping_private_tpu_torch.fit.ransac import sample_live_indices


def _four_direction_alignment(
    normals: torch.Tensor, dirs: torch.Tensor, axis: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each (hypothesis dir, normal): the largest |cosine| against the
    4 cardinal directions and which pair matched.

    normals: (N,3) unit; dirs: (H,3) unit (⊥ axis); axis: (3,) unit.
    Returns (best_cos (H,N), which (H,N) in {0: ±front, 1: ±left})."""
    left = torch.linalg.cross(axis.expand_as(dirs), dirs)  # (H,3)
    cf = torch.abs(dirs @ normals.T)  # (H,N) |cos| vs ±front
    cl = torch.abs(left @ normals.T)  # (H,N) |cos| vs ±left
    return torch.maximum(cf, cl), (cl > cf).to(torch.int32)


def fit_orientation_ransac(
    normals: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    axis: Optional[torch.Tensor] = None,
    num_hypotheses: int = 128,
    eps_angle: float = 0.1745,  # 10°
    refine_iters: int = 2,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dominant perpendicular-direction estimation over unit normals.

    ``u`` (num_hypotheses, 1) replaces the generator's uniforms.

    Returns:
      direction: (3,) unit vector ⊥ axis (the "front" direction).
      inliers: (N,) bool — normals aligned (±, or ±90° about axis) with it.
    """
    dev, dt = normals.device, normals.dtype
    if axis is None:
        axis = torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev)
    axis = torch.as_tensor(axis, dtype=dt, device=dev)
    axis = axis / torch.linalg.norm(axis)

    idx = sample_live_indices(generator, mask, (num_hypotheses, 1), u)[:, 0]
    dirs = normals[idx]  # (H,3)
    # dismissal gate: |angle(dir, axis) − 90°| ≤ eps (selectWithinDistance :210)
    perp_ok = torch.abs(dirs @ axis) <= f32_of(torch.sin, eps_angle, dev)
    # project onto the plane ⊥ axis and renormalize
    dirs = dirs - (dirs @ axis)[:, None] * axis
    dlen = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    degenerate = dlen[:, 0] < 1e-6
    dirs = dirs / torch.clamp_min(dlen, 1e-30)

    cos_thr = f32_of(torch.cos, eps_angle, dev)
    best_cos, _ = _four_direction_alignment(normals, dirs, axis)
    inl = (best_cos >= cos_thr) & mask[None, :]
    scores = torch.sum(inl, dim=1, dtype=torch.float32)
    scores = torch.where(perp_ok & ~degenerate, scores, -1.0)
    direction = dirs[torch.argmax(scores)]

    axis_n = axis.expand_as(normals)
    for _ in range(refine_iters):
        left = torch.linalg.cross(axis, direction, dim=-1)
        cf = normals @ direction
        cl = normals @ left
        use_left = torch.abs(cl) > torch.abs(cf)
        ok = (torch.where(use_left, torch.abs(cl), torch.abs(cf)) >= cos_thr) & mask
        # rotate every inlier normal into the front frame:
        #   ±front → ±n ; ±left → n × axis, signed
        front_equiv = torch.where(
            use_left[:, None],
            torch.sign(cl)[:, None] * torch.linalg.cross(normals, axis_n),
            torch.sign(cf)[:, None] * normals,
        )
        avg = torch.sum(front_equiv * ok.to(dt)[:, None], dim=0)
        avg = avg - torch.dot(avg, axis) * axis
        nlen = torch.linalg.norm(avg)
        direction = torch.where(nlen > 1e-9, avg / torch.clamp_min(nlen, 1e-30), direction)

    best_cos_f, _ = _four_direction_alignment(normals, direction[None, :], axis)
    return direction, (best_cos_f[0] >= cos_thr) & mask
