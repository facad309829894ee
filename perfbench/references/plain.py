"""Plain PyTorch geometry the references share.

Brute k-NN over the full distance matrix, covariance normals by LAPACK's
symmetric eigensolver, the SE(3) exponential by ``matrix_exp``.  It
imports nothing of the program.  Every routine runs in the dtype of its
inputs, and every matrix product goes through ``mm``: inside
``precision(tf32=True)`` its float32 operands are first rounded to TF32
(10 mantissa bits), as the tensor cores round them, and the products
summed in float32.  That is the control of a float32 configuration whose
TF32 is off; rounding the operands explicitly makes it TF32 whatever
kernel cuBLAS picks for a shape, and on the CPU too.
"""
from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

_CHUNK_ELEMS = 1 << 26  # elements of one (rows, N) distance block


_TF32 = contextvars.ContextVar("tf32", default=False)


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matrix products of ``mm`` in TF32 (``tf32``) or in full float32."""
    token = _TF32.set(tf32)
    try:
        yield
    finally:
        _TF32.reset(token)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties to even), as float32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, with float32 operands in TF32 inside ``precision(tf32=True)``."""
    if _TF32.get() and a.dtype == torch.float32:
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, 3), (N, 3) -> (Q, N) squared distances, |a|^2 + |b|^2 - 2 a.b."""
    return torch.clamp_min((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * mm(a, b.T), 0.0)


def knn(q: torch.Tensor, r: torch.Tensor, k: int, exclude_self: bool = False):
    """The k nearest rows of ``r`` to each row of ``q``: (idx (Q, k) int64,
    squared distances (Q, k)), nearest first.  With ``exclude_self`` q is
    r and a row is not its own neighbour."""
    rows = max(1, _CHUNK_ELEMS // max(len(r), 1))
    idx, d2 = [], []
    for s in range(0, len(q), rows):
        d = sq_dists(q[s : s + rows], r)
        if exclude_self:
            ar = torch.arange(d.shape[0], device=d.device)
            d[ar, ar + s] = torch.inf
        v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
        idx.append(i)
        d2.append(v)
    return torch.cat(idx), torch.cat(d2)


def nn1(q: torch.Tensor, r: torch.Tensor):
    """Nearest row of ``r`` to each row of ``q``: (idx (Q,), squared distance (Q,))."""
    rows = max(1, _CHUNK_ELEMS // max(len(r), 1))
    idx, d2 = [], []
    for s in range(0, len(q), rows):
        v, i = torch.min(sq_dists(q[s : s + rows], r), dim=1)
        idx.append(i)
        d2.append(v)
    return torch.cat(idx), torch.cat(d2)


def normals(xyz: torch.Tensor, k: int, viewpoint=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Unit normals (N, 3): the least eigenvector of the covariance of the
    k nearest other points, turned towards ``viewpoint``."""
    idx, _ = knn(xyz, xyz, k, exclude_self=True)
    nb = xyz[idx]  # (N, k, 3)
    d = nb - nb.mean(1, keepdim=True)
    cov = mm(d.transpose(1, 2), d) / k
    _, vec = np.linalg.eigh(cov.cpu().numpy())
    n = torch.as_tensor(vec[:, :, 0], device=xyz.device)
    vp = torch.as_tensor(viewpoint, dtype=xyz.dtype, device=xyz.device)
    flip = ((vp - xyz) * n).sum(1) < 0
    return torch.where(flip[:, None], -n, n)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [v, w] (6,) -> (4, 4) transform."""
    A = torch.zeros((4, 4), dtype=xi.dtype, device=xi.device)
    v, w = xi[:3], xi[3:]
    A[0, 1], A[0, 2], A[1, 2] = -w[2], w[1], -w[0]
    A[1, 0], A[2, 0], A[2, 1] = w[2], -w[1], w[0]
    A[:3, 3] = v
    return torch.linalg.matrix_exp(A)
