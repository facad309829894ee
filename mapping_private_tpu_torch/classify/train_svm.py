"""Kernel C-SVC training — the reference's ``libsvm_asako`` training capability.

Counterpart of ``mapping_private_tpu/classify/train_svm.py``: RBF
one-vs-one SVMs (libSVM.cpp, scripts/svm/train_svm.sh; the bundled
cloud_algos/svm/*.model files were trained so).  Each class pair's dual

    min_a  ½ aᵀQa − eᵀa,   0 ≤ a_i ≤ C,  yᵀa = 0,  Q_ij = y_i y_j K_ij

is solved by SMO with maximal-violating-pair working sets (libSVM.cpp
Solver::select_working_set).  All C·(C−1)/2 pairs are one batch on the
device: one host loop steps every pair at once, a converged pair is
frozen (its state kept as it was), and the loop reads convergence once
every ``_CHECK_EVERY`` steps, never stepping a pair past ``max_iter``.

The JAX package's CPU programs may fuse the gradient update's multiply
and add; the solutions then differ in the last bits, and so may the
working sets picked late in a solve: decision values agree within a
tolerance.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.classify.libsvm import SVMModel

_CHECK_EVERY = 16  # SMO steps between host reads of convergence


def rbf_kernel(x: torch.Tensor, z: torch.Tensor, gamma: float) -> torch.Tensor:
    x2 = torch.sum(x * x, -1, keepdim=True)
    z2 = torch.sum(z * z, -1, keepdim=True).transpose(-1, -2)
    d2 = torch.clamp_min(x2 + z2 - 2.0 * (x @ z.transpose(-1, -2)), 0.0)
    return torch.exp(-gamma * d2)


def _smo(Q: torch.Tensor, y: torch.Tensor, valid: torch.Tensor, C: float, tol: float, max_iter: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Binary C-SVC dual solves on padded problems, a batch of them.

    Q: (P, n, n) = y_i y_j K_ij with padded rows/cols zeroed; y, valid:
    (P, n).  Returns (alpha (P, n), rho (P,), final KKT gap (P,),
    iterations (P,)).  Each pair steps while it < max_iter and its last
    gap ≥ tol (the gap is measured before each step, and the step is
    taken); padded lanes keep alpha = 0.  A gap ≥ tol at exit means the
    pair did not converge."""
    P, n = y.shape
    dev = Q.device
    big = 1e30
    rows = torch.arange(P, device=dev)
    alpha = torch.zeros((P, n), dtype=torch.float32, device=dev)
    G = torch.full((P, n), -1.0, dtype=torch.float32, device=dev)  # G = Qa − e
    it = torch.zeros(P, dtype=torch.int32, device=dev)
    gap = torch.full((P,), float("inf"), dtype=torch.float32, device=dev)
    pos, neg = y > 0, y < 0
    for step in range(max_iter):
        if step % _CHECK_EVERY == 0 and not bool(((it < max_iter) & (gap >= tol)).any()):
            break
        act = (it < max_iter) & (gap >= tol)
        yG = -y * G
        up = valid & ((pos & (alpha < C)) | (neg & (alpha > 0)))
        low = valid & ((pos & (alpha > 0)) | (neg & (alpha < C)))
        up_v = torch.where(up, yG, -big)
        low_v = torch.where(low, yG, big)
        i = torch.argmax(up_v, dim=1)
        j = torch.argmin(low_v, dim=1)
        gap_new = up_v[rows, i] - low_v[rows, j]

        # two-variable analytic update (libSVM.cpp Solver::solve inner step)
        Qi, Qj = Q[rows, i], Q[rows, j]  # (P, n)
        Qii, Qjj, Qij = Qi[rows, i], Qj[rows, j], Qi[rows, j]
        ai, aj, yi, yj = alpha[rows, i], alpha[rows, j], y[rows, i], y[rows, j]
        Gi, Gj = G[rows, i], G[rows, j]
        quad = torch.clamp_min(Qii + Qjj - 2.0 * yi * yj * Qij, 1e-12)
        delta = (-yi * Gi + yj * Gj) / quad
        ai_new = ai + yi * delta
        # clip to the box, keeping yi·ai + yj·aj
        sum_c = yi * ai + yj * aj
        ai_new = torch.clamp(ai_new, 0.0, C)
        aj_new = torch.clamp(yj * (sum_c - yi * ai_new), 0.0, C)
        ai_new = torch.clamp(yi * (sum_c - yj * aj_new), 0.0, C)
        dai, daj = ai_new - ai, aj_new - aj
        G_new = G + Qi * dai[:, None] + Qj * daj[:, None]
        a_new = alpha.clone()
        a_new[rows, i] = ai_new
        a_new[rows, j] = aj_new

        alpha = torch.where(act[:, None], a_new, alpha)
        G = torch.where(act[:, None], G_new, G)
        gap = torch.where(act, gap_new, gap)
        it = it + act.to(torch.int32)

    # the gradient again from the final alphas in one product: the
    # incremental G drifts over thousands of rank-2 updates (rho below)
    G = (Q @ alpha[..., None])[..., 0] - 1.0
    # rho: y_i G_i = rho at free SVs (libSVM.cpp calculate_rho; G = Qa − e,
    # decision f = Σ y_j a_j K − rho)
    yG = y * G
    free = valid & (alpha > 1e-8) & (alpha < C - 1e-8)
    n_free = torch.sum(free, dim=1)
    at_ub = valid & (alpha >= C - 1e-8)
    at_lb = valid & (alpha <= 1e-8)
    ub_set = (at_ub & neg) | (at_lb & pos)
    lb_set = (at_ub & pos) | (at_lb & neg)
    ub = torch.min(torch.where(ub_set, yG, big), dim=1).values
    lb = torch.max(torch.where(lb_set, yG, -big), dim=1).values
    rho_free = torch.sum(torch.where(free, yG, 0.0), dim=1) / torch.clamp_min(n_free, 1)
    rho = torch.where(n_free > 0, rho_free, (ub + lb) / 2.0)
    return alpha, rho, gap, it


@dataclasses.dataclass
class OVOSVM:
    """One-vs-one kernel SVM in pairwise (training-set-indexed) form."""
    X: np.ndarray          # (N, D) training features
    labels: np.ndarray     # (N,) int class ids 0..C-1
    pair_idx: np.ndarray   # (P, n_max) int32 indices into X (-1 = pad)
    alpha_y: np.ndarray    # (P, n_max) alpha_i * y_i per pair
    rho: np.ndarray        # (P,)
    pairs: np.ndarray      # (P, 2) class ids (i, j)
    gamma: float
    C: float
    num_classes: int


def train_svc_ovo(
    X: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    C: float = 1.0,
    gamma: Optional[float] = None,
    tol: float = 1e-3,
    max_iter: int = 20000,
    *,
    device: torch.device | str,
) -> OVOSVM:
    """Train all C·(C−1)/2 RBF one-vs-one subproblems as one batch on
    ``device``.  gamma defaults to libsvm's 1/num_features.  Pairs are
    padded to the largest pair size (a multiple of 8), as in the JAX
    package."""
    X = np.asarray(X, np.float32)
    labels = np.asarray(labels)
    if gamma is None:
        gamma = 1.0 / X.shape[1]
    by_class = [np.nonzero(labels == c)[0] for c in range(num_classes)]
    pairs = [(i, j) for i in range(num_classes) for j in range(i + 1, num_classes)]
    n_max = max(len(by_class[i]) + len(by_class[j]) for i, j in pairs)
    n_max = -(-n_max // 8) * 8
    P = len(pairs)
    pair_idx = np.full((P, n_max), -1, np.int32)
    pair_y = np.zeros((P, n_max), np.float32)
    for p, (i, j) in enumerate(pairs):
        idx = np.concatenate([by_class[i], by_class[j]])
        pair_idx[p, : len(idx)] = idx
        pair_y[p, : len(by_class[i])] = 1.0
        pair_y[p, len(by_class[i]) : len(idx)] = -1.0

    Xd = torch.as_tensor(X, device=device)
    idxd = torch.as_tensor(pair_idx, device=device)
    yd = torch.as_tensor(pair_y, device=device)
    xp = Xd[torch.clamp_min(idxd, 0).long()]  # (P, n, D)
    valid = idxd >= 0
    K = rbf_kernel(xp, xp, gamma)
    vv = valid[:, :, None] & valid[:, None, :]
    Q = torch.where(vv, (yd[:, :, None] * yd[:, None, :]) * K, 0.0)
    alpha, rho, gaps, _ = _smo(Q, yd, valid, C, tol, max_iter)

    gaps = gaps.cpu().numpy()
    bad = np.nonzero(gaps >= tol)[0]
    if len(bad):
        worst = bad[np.argmax(gaps[bad])]
        warnings.warn(
            f"SMO hit max_iter={max_iter} before convergence on "
            f"{len(bad)}/{P} one-vs-one pairs (worst pair "
            f"{tuple(pairs[worst])}: gap {gaps[worst]:.2e} >= tol {tol:g}); "
            "alphas exported anyway — raise max_iter for exact duals.",
            stacklevel=2,
        )
    alpha = alpha.cpu().numpy()
    alpha[pair_idx < 0] = 0.0
    return OVOSVM(
        X=X, labels=labels, pair_idx=pair_idx,
        alpha_y=alpha * pair_y, rho=rho.cpu().numpy(),
        pairs=np.asarray(pairs, np.int32), gamma=gamma, C=C,
        num_classes=num_classes,
    )


def decision_values_ovo(model: OVOSVM, x: torch.Tensor) -> torch.Tensor:
    """(M, D) → per-pair decision values (M, P) in model.pairs order, on
    x's device: libsvm's svm_predict_values (dec > 0 votes for the pair's
    first class)."""
    x = x.to(torch.float32)
    P, N = len(model.pairs), model.X.shape[0]
    K = rbf_kernel(x, torch.as_tensor(model.X, device=x.device), model.gamma)  # (M, N)
    ay = np.zeros((P, N), np.float32)
    ok = model.pair_idx >= 0
    prow = np.broadcast_to(np.arange(P)[:, None], model.pair_idx.shape)
    np.add.at(ay, (prow[ok], model.pair_idx[ok]), model.alpha_y[ok])
    return K @ torch.as_tensor(ay, device=x.device).T - torch.as_tensor(model.rho, device=x.device)[None, :]


def predict_ovo(model: OVOSVM, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, D) → (labels (M,), votes (M, C)): one kernel product, the votes
    one scatter-add; a vote tie goes to the first class."""
    dec = decision_values_ovo(model, x)  # (M, P)
    win = (dec > 0).to(torch.int32)
    pi = torch.as_tensor(model.pairs[:, 0], dtype=torch.int64, device=dec.device)
    pj = torch.as_tensor(model.pairs[:, 1], dtype=torch.int64, device=dec.device)
    votes = torch.zeros((dec.shape[0], model.num_classes), dtype=torch.int32, device=dec.device)
    votes.index_add_(1, pi, win)
    votes.index_add_(1, pj, 1 - win)
    return torch.argmax(votes, dim=-1), votes


def to_libsvm_model(model: OVOSVM) -> SVMModel:
    """Convert to the libsvm model layout (loadable by svm_predict_batch,
    savable by save_libsvm_model): SVs grouped by class, sv_coef rows per
    libsvm's (C−1, L) convention."""
    N, C = model.X.shape[0], model.num_classes
    P = len(model.pairs)
    ay_global = np.zeros((P, N), np.float64)
    for p in range(P):
        ok = model.pair_idx[p] >= 0
        ay_global[p, model.pair_idx[p][ok]] += model.alpha_y[p][ok]
    is_sv = np.abs(ay_global).max(axis=0) > 1e-8
    order = np.argsort(model.labels[is_sv.nonzero()[0]], kind="stable")
    sv_idx = is_sv.nonzero()[0][order]
    L = len(sv_idx)
    nr_sv = np.asarray([int(np.sum(model.labels[sv_idx] == c)) for c in range(C)], np.int32)
    # row r of class c's SVs holds the coef of the pair (c, other): index
    # j-1 when paired with class j > c, i when i < c
    sv_coef = np.zeros((C - 1, L), np.float64)
    pos_of = {int(g): k for k, g in enumerate(sv_idx)}
    for p, (i, j) in enumerate(model.pairs):
        for g in np.nonzero(ay_global[p])[0]:
            k = pos_of[int(g)]
            row = j - 1 if model.labels[g] == i else i
            sv_coef[row, k] = ay_global[p, g]
    return SVMModel(
        svm_type="c_svc", kernel="rbf", gamma=model.gamma, coef0=0.0,
        degree=3, labels=np.arange(C, dtype=np.int32), nr_sv=nr_sv,
        rho=model.rho.astype(np.float64),
        sv_coef=sv_coef, support_vectors=model.X[sv_idx],
    )


def save_libsvm_model(model: SVMModel, path: str) -> None:
    """Write the libsvm text format (svm_save_model), so retrained models
    drop in wherever the bundled cloud_algos/svm/*.model files do."""
    C = model.nr_class
    with open(path, "w") as fp:
        fp.write(f"svm_type {model.svm_type}\n")
        fp.write(f"kernel_type {model.kernel}\n")
        if model.kernel == "polynomial":
            fp.write(f"degree {model.degree}\n")
        if model.kernel in ("rbf", "polynomial", "sigmoid"):
            fp.write(f"gamma {model.gamma:g}\n")
        if model.kernel in ("polynomial", "sigmoid"):
            fp.write(f"coef0 {model.coef0:g}\n")
        fp.write(f"nr_class {C}\n")
        fp.write(f"total_sv {len(model.support_vectors)}\n")
        fp.write("rho " + " ".join(f"{r:.17g}" for r in model.rho) + "\n")
        fp.write("label " + " ".join(str(int(lab)) for lab in model.labels) + "\n")
        fp.write("nr_sv " + " ".join(str(int(n)) for n in model.nr_sv) + "\n")
        fp.write("SV\n")
        D = model.support_vectors.shape[1] if len(model.support_vectors) else 0
        for k, sv in enumerate(model.support_vectors):
            coefs = " ".join(f"{model.sv_coef[r, k]:.17g}" for r in range(C - 1))
            # sparse like libsvm, but the LAST feature index always, so a
            # dimension zero in every SV cannot shrink the loader's
            # inferred dimensionality (and truncate queries)
            feats = " ".join(f"{i + 1}:{v:.8g}" for i, v in enumerate(sv) if v != 0.0 or i == D - 1)
            fp.write(f"{coefs} {feats} \n")
