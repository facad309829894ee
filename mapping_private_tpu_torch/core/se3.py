"""SE(3) rigid transforms as 4x4 matrices + tangent-space maps.

Counterpart of ``mapping_private_tpu/core/se3.py``.  Each function takes
one pose or twist (batch with ``torch.func.vmap``); none branches on a
value, so ``torch.func.jacfwd`` differentiates through them (the pose
graph does).  Twists are [v, w]: translation first, rotation last.
"""
from __future__ import annotations

import torch

_EPS = 1e-9


def se3_identity(dtype: torch.dtype = torch.float32, device: torch.device | str | None = None) -> torch.Tensor:
    """The (4,4) identity pose."""
    return torch.eye(4, dtype=dtype, device=device)


def skew(w: torch.Tensor) -> torch.Tensor:
    """(3,) -> (3,3) cross-product matrix."""
    wx, wy, wz = w[0], w[1], w[2]
    z = torch.zeros_like(wx)
    return torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z]).reshape(3, 3)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _bc(theta2: torch.Tensor, theta: torch.Tensor):
    """(1−cos θ)/θ² and (θ−sin θ)/θ³ with their small-angle series."""
    big = theta2 > 1e-8
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(
        big, (theta - torch.sin(theta)) / (theta2 * theta), 1.0 / 6.0 - theta2 / 120.0
    )
    return b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (3,) axis-angle -> (3,3) rotation. Taylor-safe at 0."""
    theta2 = torch.dot(w, w)
    theta = torch.sqrt(theta2 + _EPS)
    W = skew(w)
    a = torch.where(theta2 > 1e-8, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b, _ = _bc(theta2, theta)
    return _eye(3, w) + a * W + b * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(3,3) rotation -> (3,) axis-angle.

    Differentiation-safe at the identity: arccos has an unbounded
    derivative at cos θ = 1 and ``torch.where`` does not stop gradients
    from the untaken branch, so the small-angle series is written in
    cos θ and arccos is only evaluated at a clamped-away argument."""
    cos_t = torch.clip((R[0, 0] + R[1, 1] + R[2, 2] - 1.0) * 0.5, -1.0, 1.0)
    small = cos_t > 1.0 - 1e-6
    cos_safe = torch.where(small, 0.0, cos_t)  # derivative-finite arccos input
    theta = torch.arccos(cos_safe)
    w_hat = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s_large = theta / (2.0 * torch.sin(theta) + _EPS)
    # θ² ≈ 2(1−cos θ):  θ/(2 sin θ) ≈ 1/2 + θ²/12 = 1/2 + (1−cos θ)/6
    s_small = 0.5 + (1.0 - cos_t) / 6.0
    return torch.where(small, s_small, s_large) * w_hat


def _pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(3,3) rotation + (3,) translation -> (4,4) homogeneous transform."""
    bottom = _eye(4, R)[3:]  # [0, 0, 0, 1], made on the device: no host copy
    return torch.cat([torch.cat([R, t[:, None]], dim=1), bottom], dim=0)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(6,) twist [v, w] -> (4,4) transform."""
    v, w = xi[:3], xi[3:]
    theta2 = torch.dot(w, w)
    theta = torch.sqrt(theta2 + _EPS)
    W = skew(w)
    b, c = _bc(theta2, theta)
    V = _eye(3, xi) + b * W + c * (W @ W)
    return _pose(so3_exp(w), V @ v)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(4,4) -> (6,) twist [v, w]."""
    w = so3_log(T[:3, :3])
    theta2 = torch.dot(w, w)
    theta = torch.sqrt(theta2 + _EPS)
    W = skew(w)
    b, c = _bc(theta2, theta)
    V = _eye(3, T) + b * W + c * (W @ W)
    # inv, not linalg.solve: solve's forward-mode derivative is NaN under
    # torch.func.vmap, and the pose graph takes jacfwd of this under vmap
    v = torch.linalg.inv(V) @ T[:3, 3]
    return torch.cat([v, w])


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[:3, :3].T
    return _pose(Rt, -Rt @ T[:3, 3])


def se3_apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (4,4) transform to (..., 3) points.

    Broadcast arithmetic, not a matmul, as in the JAX package: each output
    coordinate is summed in one fixed order in exact f32."""
    R = T[:3, :3]
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack(
        [
            R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + T[0, 3],
            R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + T[1, 3],
            R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + T[2, 3],
        ],
        dim=-1,
    )
