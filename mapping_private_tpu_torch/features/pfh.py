"""Point Feature Histograms — the reference's ``PointFeatureHistogram``.

Counterpart of ``mapping_private_tpu/features/pfh.py``
(cloud_algos/src/pfh.cpp and the pair features of pfh.h:105-235): per
point, pair features (α, β, γ, δ) between the point and each neighbour
in its radius, quantized into a joint quantum^features histogram or
quantum·features separate ones, each pair adding 100/neighbourhood size
(pfh.cpp:208).  One batched kNN gather, vectorized pair features and a
scatter-add in place of the reference's serial kd-tree loop.

Pair features (pfh.h getPointPairFeatures, normalizations :218-229): the
source is the end whose normal makes the smaller angle with the
connecting line (:135-154); u = n_source, v = (p_t−p_s)×u / ‖·‖,
w = u×v; γ = u·(p_t−p_s)/δ → (γ+1)/2, β = v·n_target → (β+1)/2,
α = atan2(w·n_t, u·n_t) → (α+π)/(2π), δ = ‖p_t−p_s‖.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from mapping_private_tpu_torch.ops.neighbors import knn_bruteforce


def pair_features(
    p_s: torch.Tensor, n_s: torch.Tensor, p_t: torch.Tensor, n_t: torch.Tensor,
    check_flip: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched (α, β, γ, δ, valid) over (..., 3) source/target pairs, all
    normalized to [0, 1) except δ (in metres)."""
    p_s, p_t, n_s, n_t = torch.broadcast_tensors(p_s, p_t, n_s, n_t)
    d = p_t - p_s
    delta = torch.linalg.norm(d, dim=-1)
    ok = delta > 1e-9
    dn = d / torch.clamp_min(delta[..., None], 1e-30)

    g_fwd = torch.sum(n_s * dn, dim=-1)  # source = s
    g_bwd = -torch.sum(n_t * dn, dim=-1)  # source = t (flipped)
    if check_flip:
        flip = torch.arccos(torch.clamp(g_fwd, -1, 1)) > torch.arccos(torch.clamp(g_bwd, -1, 1))
    else:
        flip = torch.ones(delta.shape, dtype=torch.bool, device=delta.device)
    f3 = flip[..., None]
    ns = torch.where(f3, n_t, n_s)
    nt = torch.where(f3, n_s, n_t)
    dvec = torch.where(f3, -dn, dn)
    gamma = torch.where(flip, g_bwd, g_fwd)

    u = ns
    v = torch.linalg.cross(dvec, u, dim=-1)
    vlen = torch.linalg.norm(v, dim=-1)
    ok = ok & (vlen > 1e-9)
    v = v / torch.clamp_min(vlen[..., None], 1e-30)
    w = torch.linalg.cross(u, v, dim=-1)
    beta = torch.sum(v * nt, dim=-1)
    alpha = torch.atan2(torch.sum(w * nt, dim=-1), torch.sum(u * nt, dim=-1))

    alpha = (alpha + math.pi) / (2.0 * math.pi)
    beta = (beta + 1.0) / 2.0
    gamma = (gamma + 1.0) / 2.0
    return alpha, beta, gamma, delta, ok


def pfh_histograms(
    xyz: torch.Tensor,
    normals: torch.Tensor,
    mask: torch.Tensor,
    radius: float = 0.02,
    k: int = 16,
    quantum: int = 4,
    use_dist: bool = False,
    combine: bool = True,
    check_flip: bool = True,
) -> torch.Tensor:
    """(N, nr_bins) per-point PFH: nr_bins = quantum^features if combine
    else quantum·features (pfh.cpp:98-106), features = 4 with use_dist
    else 3; the combined bin order is the reference's (:113-120)."""
    nr_features = 4 if use_dist else 3
    nr_bins = quantum ** nr_features if combine else quantum * nr_features
    n_pts = xyz.shape[0]

    idx, sq = knn_bruteforce(xyz, xyz, mask, k=k, exclude_self=True)
    valid = (idx >= 0) & (sq <= radius * radius) & mask[:, None]
    idx_c = torch.clamp_min(idx, 0).long()
    a, b, g, d, ok = pair_features(xyz[:, None, :], normals[:, None, :], xyz[idx_c], normals[idx_c],
                                   check_flip=check_flip)
    ok = ok & valid  # (N, k)

    q = quantum

    def quant(x):
        return torch.clamp(torch.floor(q * x), 0, q - 1).to(torch.int64)

    fa, fb, fg, fd = quant(a), quant(b), quant(g), quant(d / (2.0 * radius))
    # increment 100 / neighbourhood size (pfh.cpp:208)
    cnt = torch.clamp_min(torch.sum(ok.to(torch.float32), dim=1), 1.0)
    add = torch.where(ok, (100.0 / cnt)[:, None], 0.0)
    rows = torch.arange(n_pts, device=xyz.device)[:, None].expand(ok.shape)
    hist = torch.zeros((n_pts, nr_bins), dtype=torch.float32, device=xyz.device)
    if combine:
        # reference order (pfh.cpp:113-120), index = Σ fi[j]·q^j with
        # fi = (β, δ, γ, α) with distance, (β, γ, α) without
        flat = fb + q * (fd + q * (fg + q * fa)) if use_dist else fb + q * (fg + q * fa)
        hist.index_put_((rows, flat), add, accumulate=True)
    else:
        for fi_idx, f in enumerate([fa, fb, fg] + ([fd] if use_dist else [])):
            hist.index_put_((rows, fi_idx * q + f), add, accumulate=True)
    return hist
