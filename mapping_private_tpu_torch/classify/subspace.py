"""Per-class subspace classification — ``color_feature_classification``.

Counterpart of ``mapping_private_tpu/classify/subspace.py``: one PCA
subspace per object class (computeSubspace_from_file.cpp), and a query
goes to the class with the largest ‖W_c f‖ / ‖f‖
(test_classify_from_file.cpp).  All classes are scored at once from one
(C, M, D) stack of projections.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from mapping_private_tpu_torch.recognition.pca import pca_fit, subspace_axis


@dataclasses.dataclass
class SubspaceClassifier:
    """axes: (C, M, D) per-class subspace projections; labels: (C,)."""

    axes: np.ndarray
    labels: np.ndarray


def train_subspaces(
    features_per_class: Sequence,
    dim_subspace: int,
    labels: Optional[Sequence[int]] = None,
    multiple_similarity: bool = False,
    *,
    device: torch.device | str,
) -> SubspaceClassifier:
    """Fit one PCA subspace per class (computeSubspace_from_file.cpp) on
    ``device``.  features_per_class: (N_c, D) arrays (N_c may differ)."""
    axes = []
    for f in features_per_class:
        p = pca_fit(torch.as_tensor(np.asarray(f, np.float32), device=device))
        axes.append(subspace_axis(p, dim_subspace, multiple_similarity))
    lab = np.asarray(labels if labels is not None else range(len(features_per_class)), np.int32)
    return SubspaceClassifier(axes=np.stack(axes), labels=lab)


def classify_subspace(clf: SubspaceClassifier, features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Classify (N, D) features on their device.

    Returns (labels (N,), similarities (N, C)), similarity = ‖W_c f‖ / ‖f‖
    (test_classify_from_file.cpp's projection score); ties go to the
    first class."""
    f = features.to(torch.float32)
    W = torch.as_tensor(clf.axes, dtype=torch.float32, device=f.device)  # (C, M, D)
    proj = torch.einsum("cmd,nd->ncm", W, f)
    num = torch.linalg.norm(proj, dim=-1)  # (N, C)
    den = torch.clamp_min(torch.linalg.norm(f, dim=-1, keepdim=True), 1e-20)
    sim = num / den
    best = torch.argmax(sim, dim=-1)
    return torch.as_tensor(clf.labels, device=f.device)[best], sim
