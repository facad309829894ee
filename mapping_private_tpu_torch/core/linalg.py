"""Small fixed-size linear algebra, unrolled.

Counterpart of ``mapping_private_tpu/core/linalg.py``.  The 6×6 GN solve
of ICP is written out element by element over tensors, so it stays on
the device (no value is read back to the host) and keeps the JAX
version's semantics: diagonal jitter and a clamped pivot instead of a
failure on a singular system.  ``f32_of`` takes a scalar function of a
threshold in float32, as the JAX package does.
"""
from __future__ import annotations

import torch


def cholesky_solve_unrolled(
    H: torch.Tensor, g: torch.Tensor, jitter: float = 0.0
) -> torch.Tensor:
    """Solve H x = g for symmetric positive-definite H (n ≤ ~8), unrolled.

    H: (..., n, n), g: (..., n).  Returns x (..., n).  ``jitter`` is added
    to the diagonal (Levenberg damping); a pivot s is clamped to
    max(s, 1e-20) before its square root.
    """
    n = H.shape[-1]
    h = [[H[..., i, j] for j in range(n)] for i in range(n)]
    if jitter:
        for i in range(n):
            h[i][i] = h[i][i] + jitter
    # Cholesky: L lower-triangular with H = L Lᵀ
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = h[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, 1e-20))
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L y = g
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution Lᵀ x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def f32_of(fn, x: float, device: torch.device | str) -> torch.Tensor:
    """``fn`` (e.g. ``torch.cos``) of the Python number ``x`` taken in
    float32 on ``device``: the JAX package computes angle thresholds such as
    ``jnp.cos(eps_angle)`` in float32, and ``math.cos`` rounds otherwise,
    which flips a normal that lies on the gate."""
    return fn(torch.tensor(x, dtype=torch.float32, device=device))
