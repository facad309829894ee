"""Linear SVM training — the reference's ``liblinear_asako`` capability.

Counterpart of ``mapping_private_tpu/classify/linear.py``: the
L2-regularized L2-loss SVC objective

    min_w  ½‖w‖² + C Σ_i max(0, 1 − y_i wᵀx_i)²

by full-batch gradient descent with Barzilai–Borwein steps for a fixed
number of iterations, one-vs-rest over all classes at once (a batch axis
of classes in place of the JAX package's vmap, a plain loop in place of
its ``lax.scan``).
"""
from __future__ import annotations

from typing import Tuple

import torch


def _bias_column(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)], dim=1)


def train_linear_svm(
    X: torch.Tensor, labels: torch.Tensor, num_classes: int, C: float = 1.0, iters: int = 200,
) -> torch.Tensor:
    """One-vs-rest L2-loss linear SVC.  Returns (num_classes, D+1), the
    bias last."""
    Xb = _bias_column(X.to(torch.float32))
    n, d1 = Xb.shape
    classes = torch.arange(num_classes, device=Xb.device)
    y = torch.where(labels.to(Xb.device)[None, :] == classes[:, None], 1.0, -1.0)  # (K, n)

    def grad(w):  # (K, D+1)
        m = 1.0 - y * (w @ Xb.T)
        loss_g = -2.0 * C * ((y * torch.where(m > 0, m, 0.0)) @ Xb)
        reg = w.clone()
        reg[:, -1] = 0.0  # bias unregularized
        return reg + loss_g

    w_prev = torch.zeros((num_classes, d1), dtype=torch.float32, device=Xb.device)
    g_prev = grad(w_prev)
    w = w_prev - 1e-4 * g_prev
    for _ in range(iters):
        g = grad(w)
        sdiff, gdiff = w - w_prev, g - g_prev
        num = torch.sum(sdiff * sdiff, dim=1, keepdim=True)
        den = torch.sum(sdiff * gdiff, dim=1, keepdim=True)
        step = torch.where(den > 1e-12, num / torch.clamp_min(den, 1e-12), 1e-3)
        step = torch.clamp(step, 1e-6, 10.0)
        w, w_prev, g_prev = w - step * g, w, g
    return w


def predict_linear(W: torch.Tensor, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (labels (N,), decision values (N, C)); ties go to the first class."""
    dec = _bias_column(X.to(torch.float32)) @ W.T
    return torch.argmax(dec, dim=-1), dec
