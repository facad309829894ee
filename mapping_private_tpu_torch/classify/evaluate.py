"""Reference-protocol classification evaluation over the 63-object corpus.

Counterpart of ``mapping_private_tpu/classify/evaluate.py``: the
color_feature_classification demo workflow (README:1-13,
scripts/demos/{all.sh,2.leave_one_out.sh,calcRate.sh}):

  0.computeFeature.sh  → extract_corpus_features (per-view descriptors:
      c=981 ColorCHLAC, d=1001 GRSD-20++ColorCHLAC-981, g=20 GRSD,
      r=137 GRSD-20++ColorCHLAC-117)
  0.compute_compress_axis.sh → one global PCA compression axis
  1.compute_subspace.sh → per-object PCA subspaces; for c/d the training
      set gains the 24 proper 90°-rotation permutations of the 981 part
      (computeFeature.cpp :120-160)
  2.leave_one_out.sh   → per (object, view) fold only the test object's
      subspace is retrained on its other views; a view goes to the
      class of the largest ‖W_c f‖/‖f‖
  calcRate.sh          → per-object and overall rates

Every fold subspace is one batched symmetric eigensolve over (C, V, D,
D) on the features' device (in f64, rounded back, as recognition/pca.py
explains).  With ``-sub 50`` over 24 views (the r
protocol) each basis is padded past the data's rank with null-space
directions that no solver fixes, so the two packages may differ view by
view there: compare rates.

Protocol deviation (the JAX package's): whole-object descriptors for
train and test, where the reference trains on per-subdivision histograms.
The corpus directory is an argument without a default (the JAX package
defaults to where its reference corpus was unpacked).
"""
from __future__ import annotations

import dataclasses
import functools
import glob
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.recognition.pca import symmetric_eigh

FEATURE_DIMS = {"c": 981, "d": 1001, "g": 20, "r": 137}
# subspace protocol per 2.leave_one_out.sh: (compress dim or None, sub dim)
PROTOCOL = {"c": (100, 50), "d": (100, 50), "g": (None, 10), "r": (100, 50)}


def compute_all_features(path: str, *, device: torch.device | str) -> Dict[str, np.ndarray]:
    """One view → all four descriptors in one pass on ``device`` (d = g ++
    c and r = g ++ ColorCHLAC-117 share the voxelization, normals and RSD
    types; grids at least 32 a side, as the JAX package pads them)."""
    from mapping_private_tpu_torch.features import grsd20_from_types, voxel_types, voxelize_for_features
    from mapping_private_tpu_torch.features.colorchlac import colorchlac117, colorchlac981
    from mapping_private_tpu_torch.io.pcd import load_pcd

    cloud = load_pcd(path, capacity_bucket=2048, device=device)
    grid = voxelize_for_features(cloud, dim_floor=32)
    types = voxel_types(cloud, grid)
    g = grsd20_from_types(types, grid.occupancy()).cpu().numpy()
    c = colorchlac981(grid).cpu().numpy()
    r117 = colorchlac117(grid).cpu().numpy()
    return {"g": g, "c": c, "d": np.concatenate([g, c]), "r": np.concatenate([g, r117])}


def compute_feature(path: str, feature_type: str, *, device: torch.device | str) -> np.ndarray:
    """One view → descriptor, types per the reference banner dims."""
    return compute_all_features(path, device=device)[feature_type]


def extract_corpus_features(
    data_dir: str,
    feature_type: str = "g",
    cache_path: Optional[str] = None,
    objects: Optional[Sequence[str]] = None,
    max_views: int = 0,
    verbose: bool = False,
    *,
    device: torch.device | str,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(features (N, D), labels (N,), object names).  Cached as npz."""
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path, allow_pickle=True)
        return z["features"], z["labels"], list(z["names"])
    F, L, dirs = extract_corpus_features_all(data_dir, None, objects, max_views, verbose, device=device)
    Ft = F[feature_type]
    if cache_path:
        np.savez_compressed(cache_path, features=Ft, labels=L, names=dirs)
    return Ft, L, dirs


def extract_corpus_features_all(
    data_dir: str,
    cache_path: Optional[str] = None,
    objects: Optional[Sequence[str]] = None,
    max_views: int = 0,
    verbose: bool = False,
    *,
    device: torch.device | str,
) -> Tuple[Dict[str, np.ndarray], np.ndarray, List[str]]:
    """All four feature types in one corpus pass.  Cached as one npz with
    keys features_c/d/g/r."""
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path, allow_pickle=True)
        return {t: z[f"features_{t}"] for t in "cdgr"}, z["labels"], list(z["names"])
    dirs = sorted(d for d in os.listdir(data_dir) if d.startswith("obj"))
    if objects:
        dirs = [d for d in dirs if d in set(objects)]
    feats = {t: [] for t in "cdgr"}
    labels = []
    for ci, d in enumerate(dirs):
        t0 = time.time()
        views = sorted(glob.glob(os.path.join(data_dir, d, "*.pcd")))
        if max_views:
            views = views[:max_views]
        for p in views:
            out = compute_all_features(p, device=device)
            for t in "cdgr":
                feats[t].append(out[t])
            labels.append(ci)
        if verbose:
            print(f"{d}: {len(views)} views {time.time() - t0:.1f}s", flush=True)
    F = {t: np.stack(feats[t]).astype(np.float32) for t in "cdgr"}
    L = np.asarray(labels, np.int32)
    if cache_path:
        np.savez_compressed(cache_path, labels=L, names=dirs, **{f"features_{t}": F[t] for t in "cdgr"})
    return F, L, dirs


@functools.lru_cache(maxsize=None)
def _rotation_orbit_perms_981() -> np.ndarray:
    """(24, 981) permutations: the proper-rotation orbit generated by the
    x/y/z 90° feature permutations (rotate_feature_981)."""
    from mapping_private_tpu_torch.features.colorchlac import _rotation_permutation_981

    gens = [_rotation_permutation_981(m) for m in ("x", "y", "z")]
    seen = {tuple(range(981)): np.arange(981)}
    frontier = [np.arange(981)]
    while frontier:
        nxt = []
        for p in frontier:
            for g in gens:
                q = p[g]
                t = tuple(q)
                if t not in seen:
                    seen[t] = q
                    nxt.append(q)
        frontier = nxt
    perms = np.stack(list(seen.values()))
    if perms.shape[0] != 24:
        raise AssertionError(perms.shape)
    return perms


def _augment_rotations(F: np.ndarray, L: np.ndarray, feature_type: str):
    """24× rotation augmentation of c (981) / d (20++981) training sets."""
    if feature_type not in ("c", "d"):
        return F, L
    perms = _rotation_orbit_perms_981()
    off = 20 if feature_type == "d" else 0
    out = []
    for p in perms:
        f = F.copy()
        f[:, off:] = F[:, off:][:, p]
        out.append(f)
    return np.concatenate(out), np.tile(L, len(perms))


@dataclasses.dataclass
class EvalResult:
    rate: float
    per_object: Dict[str, float]
    n_correct: int
    n_total: int


def _leading_axes(X: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D, dim) eigenvectors of Xᵀ X for the ``dim`` largest
    eigenvalues, descending, and those eigenvalues."""
    w, v = symmetric_eigh(X.transpose(-1, -2) @ X)
    return v.flip(-1)[..., :dim], w.flip(-1)[..., :dim]


def leave_one_out_similarities(
    F: np.ndarray,
    L: np.ndarray,
    feature_type: str,
    whiten: bool = False,
    bin_normalize: bool = False,
    *,
    device: torch.device | str,
) -> torch.Tensor:
    """(N, C) similarities ‖W f‖/‖f‖ of each view to each object's
    subspace, the view's own object by its fold subspace: what
    ``leave_one_out_subspace`` takes the argmax of."""
    compress_dim, sub_dim = PROTOCOL[feature_type]
    C = int(L.max()) + 1
    if bin_normalize:
        F = F / np.maximum(F.max(0), 1e-12)
    Fa, _ = _augment_rotations(F, L, feature_type)
    Xall = torch.as_tensor(np.asarray(Fa, np.float32), device=device)

    # global compression axis (0.compute_compress_axis.sh): PCA over the
    # whole (augmented) training corpus, no centring (pca.cpp:73-107)
    Fc = torch.as_tensor(np.asarray(F, np.float32), device=device)
    Fac = Xall
    if compress_dim is not None:
        comp, w_top = _leading_axes(Xall, compress_dim)  # (D, dim)
        if whiten:
            comp = comp / torch.sqrt(torch.clamp_min(w_top, 1e-12))[None, :]
        Fc, Fac = Fc @ comp, Xall @ comp

    aug = Fac.shape[0] // len(F)
    V = int(np.max(np.bincount(L)))  # views per object (24)
    # training tensor (C, V*aug, D) grouped per object
    rows = np.stack([
        np.concatenate([np.nonzero(L == c)[0] + r * len(F) for r in range(aug)]) for c in range(C)
    ])
    X = Fac[torch.as_tensor(rows, device=device)]
    W_full, _ = _leading_axes(X, sub_dim)  # (C, D, sub)

    # fold subspaces: object c, view v → its views != v (every rotation
    # copy of view v removed), one batch of C·V problems
    view_of_row = torch.as_tensor(np.tile(np.arange(V), aug), device=device)
    keep = (view_of_row[None, :] != torch.arange(V, device=device)[:, None]).to(X.dtype)  # (V, V*aug)
    W_fold, _ = _leading_axes(X[:, None, :, :] * keep[None, :, :, None], sub_dim)  # (C, V, D, sub)

    # the test feature is the unaugmented view's
    Lt = torch.as_tensor(np.asarray(L, np.int64), device=device)
    N = Fc.shape[0]
    sims = torch.linalg.norm(torch.einsum("nd,cds->ncs", Fc, W_full), dim=-1)  # (N, C)
    vidx = torch.arange(N, device=device) % V
    own = torch.linalg.norm(torch.einsum("nd,nds->ns", Fc, W_fold[Lt, vidx]), dim=-1)
    sims[torch.arange(N, device=device), Lt] = own
    return sims / torch.clamp_min(torch.linalg.norm(Fc, dim=-1, keepdim=True), 1e-20)


def leave_one_out_subspace(
    F: np.ndarray,
    L: np.ndarray,
    names: Sequence[str],
    feature_type: str,
    verbose: bool = False,
    whiten: bool = False,
    bin_normalize: bool = False,
    *,
    device: torch.device | str,
) -> EvalResult:
    """2.leave_one_out.sh semantics, batched on ``device``.

    ``whiten`` divides each compressed coordinate by the sqrt of its
    compress-axis eigenvalue (compressFeature's FILE_MODE WHITENING);
    ``bin_normalize`` scales each bin by its corpus maximum
    (0.calcNormalization).  The headline runs with both off."""
    sims = leave_one_out_similarities(F, L, feature_type, whiten, bin_normalize, device=device)
    pred = torch.argmax(sims, dim=-1).cpu().numpy()
    per_object = {n: float((pred[L == c] == c).mean()) for c, n in enumerate(names)}
    n_ok = int((pred == L).sum())
    res = EvalResult(n_ok / len(L), per_object, n_ok, len(L))
    if verbose:
        for n in names:
            print(f"{n}: {per_object[n] * 100:.1f}%")
        print(f"overall: {res.rate * 100:.2f}% ({n_ok}/{len(L)})")
    return res


def crossval_svm(
    F: np.ndarray,
    L: np.ndarray,
    names: Sequence[str],
    n_folds: int = 4,
    C: float = 10.0,
    verbose: bool = False,
    *,
    device: torch.device | str,
) -> EvalResult:
    """View-held-out cross-validation with the kernel OvO SVM trainer
    (classify/train_svm.py) on ``device``.  Fold k holds out views
    v ≡ k (mod n_folds) of every object."""
    from mapping_private_tpu_torch.classify.train_svm import predict_ovo, train_svc_ovo

    V = np.max(np.bincount(L)) if len(L) else 0
    vidx = np.arange(len(L)) % V
    # scale to [0,1] per dim over the training corpus (libsvm practice)
    Fs = F / np.maximum(np.abs(F).max(axis=0), 1e-12)
    pred = np.zeros(len(L), np.int64)
    for k in range(n_folds):
        te = vidx % n_folds == k
        m = train_svc_ovo(Fs[~te], L[~te], len(names), C=C, device=device)
        lab, _ = predict_ovo(m, torch.as_tensor(np.asarray(Fs[te], np.float32), device=device))
        pred[te] = lab.cpu().numpy()
        if verbose:
            print(f"fold {k}: {float((pred[te] == L[te]).mean()) * 100:.1f}%", flush=True)
    per_object = {n: float((pred[L == c] == c).mean()) for c, n in enumerate(names)}
    n_ok = int((pred == L).sum())
    return EvalResult(n_ok / len(L), per_object, n_ok, len(L))


def subspace_split_protocol(
    Xtr: np.ndarray,
    Ltr: np.ndarray,
    Xte: np.ndarray,
    n_class: int,
    sub_dim: int,
    compress_dim: Optional[int] = None,
    whiten: bool = True,
    *,
    device: torch.device | str,
):
    """Train/test-split subspace classification with the reference's
    option semantics (computeSubspace_from_file.cpp:94-132: a mean-free
    PCA compress axis over all training rows, whitened by
    1/sqrt(variance) under FILE_MODE WHITENING; test_classify_from_file.cpp
    :59-152: per-class subspaces, similarity |W_cᵀ y|² / |y|², argmax).
    Returns (pred (N,) int, sims (N, C)) as numpy."""
    Xtr = torch.as_tensor(np.asarray(Xtr, np.float32), device=device)
    Xte = torch.as_tensor(np.asarray(Xte, np.float32), device=device)
    if compress_dim is not None:
        comp, var = _leading_axes(Xtr, compress_dim)
        Xtr, Xte = Xtr @ comp, Xte @ comp
        if whiten:
            scale = 1.0 / torch.sqrt(torch.clamp_min(var, 1e-30))
            Xtr, Xte = Xtr * scale, Xte * scale
    Ltr = np.asarray(Ltr)
    W = torch.stack([_leading_axes(Xtr[torch.as_tensor(np.nonzero(Ltr == c)[0], device=device)], sub_dim)[0]
                     for c in range(n_class)])  # (C, D, sub)
    proj = torch.einsum("nd,cds->ncs", Xte, W)
    sims = torch.sum(proj * proj, dim=-1)
    sims = sims / torch.clamp_min(torch.sum(Xte * Xte, dim=-1, keepdim=True), 1e-20)
    return torch.argmax(sims, dim=-1).cpu().numpy(), sims.cpu().numpy()
