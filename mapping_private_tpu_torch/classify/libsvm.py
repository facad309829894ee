"""libsvm-compatible batched SVM prediction — the reference's ``SVMClassification``.

Counterpart of ``mapping_private_tpu/classify/libsvm.py``
(cloud_algos/src/svm_classification.cpp): a libsvm text model
(:80-88) and an optional svm-scale ``.scp`` file (:92-112) are parsed
into dense host arrays, and a whole batch is classified at once on the
features' device: the kernel matrix K(X, SV) is one product, the
one-vs-one decision values a second, and the votes a scatter-add.
Also reads the models of the vendored libsvm fork
(color_feature_classification/src/libsvm_and_linear/libsvm_asako).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

_KERNELS = ("linear", "polynomial", "rbf", "sigmoid", "precomputed")


@dataclasses.dataclass
class SVMModel:
    svm_type: str
    kernel: str
    gamma: float
    coef0: float
    degree: int
    labels: np.ndarray  # (C,)
    nr_sv: np.ndarray  # (C,) SV count per class
    rho: np.ndarray  # (C*(C-1)/2,)
    sv_coef: np.ndarray  # (C-1, L) dual coefficients
    support_vectors: np.ndarray  # (L, D) dense

    @property
    def nr_class(self) -> int:
        return len(self.labels)


def load_libsvm_model(path: str) -> SVMModel:
    """Parse a libsvm text model (svm_load_model format)."""
    header: Dict[str, list] = {}
    sv_lines = []
    with open(path) as fp:
        in_sv = False
        for line in fp:
            line = line.strip()
            if not line:
                continue
            if in_sv:
                sv_lines.append(line)
            elif line == "SV":
                in_sv = True
            else:
                key, *vals = line.split()
                header[key] = vals
    svm_type = header.get("svm_type", ["c_svc"])[0]
    kernel = header.get("kernel_type", ["rbf"])[0]
    gamma = float(header.get("gamma", [0.0])[0])
    coef0 = float(header.get("coef0", [0.0])[0])
    degree = int(header.get("degree", [3])[0])
    nr_class = int(header["nr_class"][0])
    total_sv = int(header["total_sv"][0])
    labels = np.asarray(header.get("label", range(nr_class)), dtype=np.int32)
    nr_sv = np.asarray(header.get("nr_sv", [total_sv]), dtype=np.int32)
    rho = np.asarray(header["rho"], dtype=np.float64)

    n_coef = nr_class - 1 if nr_class > 1 else 1
    sv_coef = np.zeros((n_coef, total_sv), np.float64)
    rows = []
    max_idx = 0
    for li, line in enumerate(sv_lines):
        parts = line.split()
        for c in range(n_coef):
            sv_coef[c, li] = float(parts[c])
        feat = {}
        for tok in parts[n_coef:]:
            i, v = tok.split(":")
            feat[int(i)] = float(v)
            max_idx = max(max_idx, int(i))
        rows.append(feat)
    svs = np.zeros((total_sv, max_idx), np.float32)
    for li, feat in enumerate(rows):
        for i, v in feat.items():
            svs[li, i - 1] = v
    return SVMModel(
        svm_type=svm_type, kernel=kernel, gamma=gamma, coef0=coef0,
        degree=degree, labels=labels, nr_sv=nr_sv, rho=rho,
        sv_coef=sv_coef, support_vectors=svs,
    )


def load_scale_params(path: str) -> Tuple[float, float, np.ndarray]:
    """Parse a ``.scp`` svm-scale restore file (parseScaleParameterFile):
    line 'x', then 'lower upper', then 'index fmin fmax' rows.  Returns
    (lower, upper, ranges (D, 2)); rows absent from the file keep (0, 0),
    "do not scale" (svm-scale's semantics)."""
    with open(path) as fp:
        lines = [ln.strip() for ln in fp if ln.strip()]
    if not lines[0].startswith("x"):
        raise ValueError("only x-scaling .scp files are supported")
    lower, upper = (float(v) for v in lines[1].split())
    entries = [tuple(ln.split()) for ln in lines[2:]]
    max_idx = max(int(e[0]) for e in entries)
    ranges = np.zeros((max_idx, 2), np.float64)
    for idx, lo, hi in entries:
        ranges[int(idx) - 1] = (float(lo), float(hi))
    return lower, upper, ranges


def scale_features(x: torch.Tensor, lower: float, upper: float, ranges: np.ndarray) -> torch.Tensor:
    """Min-max scale (svm_classification.cpp scaleFeature); features with
    fmin == fmax pass through unscaled."""
    d = min(x.shape[-1], len(ranges))
    fmin = torch.as_tensor(ranges[:d, 0], dtype=x.dtype, device=x.device)
    fmax = torch.as_tensor(ranges[:d, 1], dtype=x.dtype, device=x.device)
    span = fmax - fmin
    ok = span != 0
    scaled = lower + (upper - lower) * (x[..., :d] - fmin) / torch.where(ok, span, 1.0)
    out = torch.where(ok, scaled, x[..., :d])
    if x.shape[-1] > d:
        out = torch.cat([out, x[..., d:]], dim=-1)
    return out


def _kernel_matrix(model: SVMModel, x: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """(N, D), (L, D) → (N, L)."""
    if model.kernel == "linear":
        return x @ sv.T
    if model.kernel == "rbf":
        x2 = torch.sum(x * x, -1, keepdim=True)
        s2 = torch.sum(sv * sv, -1, keepdim=True).T
        d2 = torch.clamp_min(x2 + s2 - 2.0 * (x @ sv.T), 0.0)
        return torch.exp(-model.gamma * d2)
    if model.kernel == "polynomial":
        return (model.gamma * (x @ sv.T) + model.coef0) ** model.degree
    if model.kernel == "sigmoid":
        return torch.tanh(model.gamma * (x @ sv.T) + model.coef0)
    raise ValueError(f"unsupported kernel {model.kernel}")


def svm_decision_values(model: SVMModel, x: torch.Tensor) -> torch.Tensor:
    """One-vs-one decision values (N, C*(C-1)/2), libsvm pair order."""
    C = model.nr_class
    sv = torch.as_tensor(model.support_vectors, device=x.device)
    d, L = x.shape[-1], sv.shape[-1]
    if d < L:
        x = torch.nn.functional.pad(x, (0, L - d))
    elif d > L:
        x = x[:, :L]
    K = _kernel_matrix(model, x, sv)  # (N, L)
    starts = np.concatenate([[0], np.cumsum(model.nr_sv)])
    coef = torch.as_tensor(model.sv_coef, dtype=torch.float32, device=x.device)
    decs = []
    p = 0
    for i in range(C):
        si, ei = starts[i], starts[i + 1]
        for j in range(i + 1, C):
            sj, ej = starts[j], starts[j + 1]
            decs.append(K[:, si:ei] @ coef[j - 1, si:ei] + K[:, sj:ej] @ coef[i, sj:ej] - model.rho[p])
            p += 1
    return torch.stack(decs, dim=-1)


def svm_predict_batch(model: SVMModel, x: torch.Tensor) -> torch.Tensor:
    """Batched svm_predict: (N, D) → (N,) predicted labels; a vote tie
    goes to the first class."""
    C = model.nr_class
    dec = svm_decision_values(model, x)  # (N, P)
    pairs = [(i, j) for i in range(C) for j in range(i + 1, C)]
    pi = torch.as_tensor([i for i, _ in pairs], device=x.device)
    pj = torch.as_tensor([j for _, j in pairs], device=x.device)
    win = (dec > 0).to(torch.int32)
    votes = torch.zeros((x.shape[0], C), dtype=torch.int32, device=x.device)
    votes.index_add_(1, pi, win)
    votes.index_add_(1, pj, 1 - win)
    best = torch.argmax(votes, dim=-1)
    return torch.as_tensor(model.labels, device=x.device)[best]
