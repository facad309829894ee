"""Depth-image operations: disparity conversions, clamped smoothing,
unprojection and the robot self-filter's background subtraction.

Counterpart of ``mapping_private_tpu/realtime/depth.py`` (the reference's
depth_image_smoothing.cpp and realtime_perception's
``BackgroundSubtractionKernel``, urdf_filtering.cu:30-47).  Whole-image
elementwise torch ops on the image's device; the JAX ``lax.scan`` of the
smoothing is a loop of ``iterations`` passes.

Divisions by a constant divide by an f32 tensor of it: a Python scalar
on the left of ``/`` is ``reciprocal() * scalar`` in PyTorch, and a CUDA
tensor divided by a Python scalar is multiplied by its reciprocal; both
round twice where the JAX package rounds once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

BASELINE_FOCAL = 0.075 * 580.0  # Kinect baseline (m) x focal length (px): 43.5, exact in f32


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def depth_to_disparity(depth_m: torch.Tensor, baseline_focal: float = BASELINE_FOCAL) -> torch.Tensor:
    """disparity = B·f / z; invalid (z ≤ 0) → 0."""
    valid = depth_m > 0
    return torch.where(valid, _f32(baseline_focal, depth_m) / torch.clamp_min(depth_m, 1e-6), 0.0)


def disparity_to_depth(disp: torch.Tensor, baseline_focal: float = BASELINE_FOCAL) -> torch.Tensor:
    valid = disp > 0
    return torch.where(valid, _f32(baseline_focal, disp) / torch.clamp_min(disp, 1e-6), 0.0)


def _shift2d(x: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """x[i + dy, j + dx], with ``fill`` where that falls off the image."""
    out = torch.roll(x, (-dy, -dx), dims=(0, 1))
    if dy > 0:
        out[-dy:, :] = fill
    elif dy < 0:
        out[:-dy, :] = fill
    if dx > 0:
        out[:, -dx:] = fill
    elif dx < 0:
        out[:, :-dx] = fill
    return out


def smooth_depth_image(
    depth_m: torch.Tensor,
    iterations: int = 5,
    disparity_tolerance: float = 1.0,
    baseline_focal: float = BASELINE_FOCAL,
) -> torch.Tensor:
    """Clamped depth smoothing (computeClampingImages :45-110 +
    bilateralSmoothing :84-118): each pixel's interval is its own
    disparity ± ``disparity_tolerance`` taken back to depth; each pass
    blurs the valid depths with a 3×3 binomial kernel (weighted by
    validity) and clamps every pixel into its interval, so a depth edge
    cannot bleed.  depth_m: (H, W) metres, 0 = invalid."""
    valid = depth_m > 0
    disp = depth_to_disparity(depth_m, baseline_focal)
    lo = disparity_to_depth(disp + disparity_tolerance, baseline_focal)
    hi = disparity_to_depth(torch.clamp_min(disp - disparity_tolerance, 1e-3), baseline_focal)
    kern = (1.0, 2.0, 1.0)
    validf = valid.to(depth_m.dtype)
    d = depth_m
    for _ in range(iterations):
        s = torch.zeros_like(d)
        w = torch.zeros_like(d)
        live = torch.where(valid, d, 0.0)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                k = kern[dy + 1] * kern[dx + 1]
                s = s + k * _shift2d(live, dy, dx, 0.0)
                w = w + k * _shift2d(validf, dy, dx, 0.0)
        avg = s / torch.clamp_min(w, 1e-6)
        d = torch.where(valid, torch.minimum(torch.maximum(avg, lo), hi), d)
    return torch.where(valid, d, 0.0)


def depth_to_cloud(
    depth_m: torch.Tensor,
    fx: float = 580.0,
    fy: float = 580.0,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) metric depth → ((H, W, 3) camera-frame points, (H, W) valid)."""
    h, w = depth_m.shape
    cx = (w - 1) / 2.0 if cx is None else cx
    cy = (h - 1) / 2.0 if cy is None else cy
    v, u = torch.meshgrid(torch.arange(h, dtype=depth_m.dtype, device=depth_m.device),
                          torch.arange(w, dtype=depth_m.dtype, device=depth_m.device), indexing="ij")
    z = depth_m
    x = (u - cx) / _f32(fx, z) * z
    y = (v - cy) / _f32(fy, z) * z
    return torch.stack([x, y, z], dim=-1), z > 0


def background_subtract(
    measured_depth_m: torch.Tensor,
    rendered_depth_m: torch.Tensor,
    threshold: float = 0.05,
) -> torch.Tensor:
    """Robot self-filter mask (BackgroundSubtractionKernel semantics):
    True = keep the pixel (scene), False = cut it (robot).  A pixel is cut
    where the rendered robot covers it and the measurement is valid and
    nearer than the robot's surface + ``threshold``; invalid measurements
    are kept (as invalid), not classed as robot."""
    robot = rendered_depth_m > 0
    meas_ok = measured_depth_m > 0
    near_robot = robot & meas_ok & (measured_depth_m < rendered_depth_m + threshold)
    return ~near_robot
