"""PCA subspace learning — the reference's color_voxel_recognition/src/pca.cpp.

Counterpart of ``mapping_private_tpu/recognition/pca.py``: the
correlation matrix FᵀF/n (PCA::addData, pca.cpp:48-69), optionally minus
the mean outer product and plus Tikhonov regularization, then a
symmetric eigendecomposition with the eigenpairs in descending order
(PCA::solve :73-107), computed on the features' device.  Object
subspaces take the leading ``dim_model`` eigenvectors, optionally scaled
by sqrt(variance ratio) (search.cpp readAxis :153-165).

``eigh`` returns eigenvectors up to sign, and any basis of a degenerate
eigenspace: compare subspaces by their projectors, not by columns.  The
correlation is f32, as in the JAX package; it is solved in f64 and
rounded back (``symmetric_eigh``), because the CPU LAPACK's f32 solver
fails to converge on some rank-deficient correlations whose eigenvalues
spread over ten decades (a few corpus views of 137-dim features).
The files are the reference's binary and ASCII formats (pca.cpp read
:128-185, write :189-243), byte for byte what the JAX package writes
from the same ``PCAResult``.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np
import torch


def symmetric_eigh(a: torch.Tensor):
    """(eigenvalues ascending, eigenvectors) of symmetric (..., D, D),
    solved in f64 and rounded back to ``a``'s dtype."""
    w, v = torch.linalg.eigh(a.to(torch.float64))
    return w.to(a.dtype), v.to(a.dtype)


@dataclasses.dataclass
class PCAResult:
    """axis: (D, D) columns = eigenvectors, descending eigenvalue order;
    variance: (D,) descending; mean: (D,) or None."""

    axis: np.ndarray
    variance: np.ndarray
    mean: Optional[np.ndarray] = None


def pca_fit(
    features: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    mean_flg: bool = False,
    regularization: float = 0.0,
) -> PCAResult:
    """PCA over (N, D) feature rows (masked), eigenpairs descending, on
    the features' device (PCA::solve)."""
    f = torch.as_tensor(features).to(torch.float32)
    n, d = f.shape
    if mask is not None:
        f = f * mask.to(f.dtype)[:, None]
        cnt = torch.clamp_min(torch.sum(mask.to(torch.float32)), 1.0)
    else:
        cnt = float(n)
    corr = (f.T @ f) / cnt
    mean = torch.sum(f, dim=0) / cnt
    if mean_flg:
        corr = corr - torch.outer(mean, mean)
    if regularization:
        corr = corr + regularization * torch.eye(d, dtype=corr.dtype, device=corr.device)
    vals, vecs = symmetric_eigh(corr)  # ascending
    order = torch.argsort(-vals, stable=True)
    return PCAResult(
        axis=vecs[:, order].cpu().numpy(),
        variance=vals[order].cpu().numpy(),
        mean=mean.cpu().numpy() if mean_flg else None,
    )


def subspace_axis(pca: PCAResult, dim_model: int, multiple_similarity: bool = False) -> np.ndarray:
    """axis_q (dim_model, D): the leading eigenvectors transposed, rows
    optionally scaled by sqrt(var_i/var_0) (readAxis :159-164)."""
    axis_q = pca.axis[:, :dim_model].T.copy()
    if multiple_similarity:
        scale = np.sqrt(
            np.maximum(pca.variance[:dim_model], 0.0)
            / max(float(pca.variance[0]), 1e-30)
        )
        axis_q = axis_q * scale[:, None]
    return axis_q.astype(np.float32)


def write_pca(path: str, pca: PCAResult, ascii_fmt: bool = False) -> None:
    """Reference-compatible PCA file (pca.cpp PCA::write :189-243)."""
    d = int(len(pca.variance))
    if ascii_fmt:
        with open(path, "w") as fp:
            fp.write(f"{d}\n")
            for i in range(d):
                fp.write(" ".join(f"{pca.axis[j, i]:f}" for j in range(d)) + " \n")
            for i in range(d):
                fp.write(f"{pca.variance[i]:f}\n")
            if pca.mean is not None:
                for i in range(d):
                    fp.write(f"{pca.mean[i]:f}\n")
    else:
        with open(path, "wb") as fp:
            fp.write(struct.pack("<i", d))
            # eigenvector i contiguous (column i of axis)
            fp.write(np.asarray(pca.axis).T.astype("<f4").tobytes())
            fp.write(np.asarray(pca.variance, "<f4").tobytes())
            if pca.mean is not None:
                fp.write(np.asarray(pca.mean, "<f4").tobytes())


def read_pca(path: str, ascii_fmt: bool = False) -> PCAResult:
    """Reference-compatible PCA reader (pca.cpp PCA::read :128-185)."""
    if ascii_fmt:
        with open(path) as fp:
            tokens = fp.read().split()
        d = int(tokens[0])
        vals = np.asarray(tokens[1:], dtype=np.float32)
    else:
        with open(path, "rb") as fp:
            raw = fp.read()
        d = struct.unpack("<i", raw[:4])[0]
        vals = np.frombuffer(raw[4:], dtype="<f4")
    axis = vals[: d * d].reshape(d, d).T.copy()  # stored per eigenvector
    variance = vals[d * d : d * d + d].copy()
    rest = vals[d * d + d :]
    mean = rest[:d].copy() if len(rest) >= d else None
    return PCAResult(axis=axis, variance=variance, mean=mean)


def variance_report(
    pca: PCAResult,
    dim: "int | None" = None,
    contrib_dim: "int | None" = None,
    contrib_rate: "float | None" = None,
):
    """Subspace eigenvalue inspection, the ``variance_show`` tool
    (color_voxel_recognition/test/variance_show.cpp:49-98): the first
    ``dim`` eigenvalues; with ``contrib_dim=d`` the accumulative
    contribution rate Σ variance[:d] / Σ variance[:dim]; with
    ``contrib_rate=c`` the first 0-based index whose accumulative rate
    reaches ``c`` (``dim`` when never reached)."""
    v = np.maximum(np.asarray(pca.variance, np.float64), 0.0)
    if dim is None:
        dim = len(v)
    v = v[:dim]
    if contrib_dim is not None:
        return float(v[:contrib_dim].sum() / max(v.sum(), 1e-300))
    if contrib_rate is not None:
        c = np.cumsum(v) / max(v.sum(), 1e-300)
        hit = np.nonzero(c >= contrib_rate)[0]
        return int(hit[0]) if len(hit) else dim
    return v
