"""Euclidean clustering — connected components by label propagation.

Counterpart of ``mapping_private_tpu/ops/cluster.py`` (the reference's
``extractEuclideanClusters``, table_object_detector_passive.cpp:401,477,
and the flood fill of region_growing.cpp:48-84).  A fixed-fanout radius
graph (kNN edges gated by the tolerance, optionally by the normals'
angle), then "label := min(label, neighbour labels)" both ways along
every edge (a gather along incoming and a scatter-min along outgoing
edges, so the directed kNN graph acts undirected) until the labels are
stationary.

Convergence is tested on the host once per block of ``_SWEEPS_PER_CHECK``
sweeps rather than after each one (each test is a device sync); extra
sweeps past the fixed point change nothing, and the total never exceeds
``max_iters``, so the labels are the JAX loop's in either case.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mapping_private_tpu_torch.core.linalg import f32_of
from mapping_private_tpu_torch.ops.neighbors import build_grid_hash, knn_bruteforce, knn_grid

_SWEEPS_PER_CHECK = 8


def radius_graph(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    tolerance: float,
    k: int = 16,
    use_grid: bool = False,
    cap_per_cell: int = 16,
    normals: Optional[torch.Tensor] = None,
    angle_threshold: Optional[float] = None,
    direct: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,k) neighbour indices + validity for edges within ``tolerance``.

    With ``normals`` and ``angle_threshold`` an edge also needs
    angle(n_i, n_j) < threshold, sign-agnostic (the reference's
    region_angle_threshold).  ``direct``: the brute search ranks by
    direct differences (``knn_bruteforce``)."""
    if use_grid:
        grid = build_grid_hash(xyz, mask, tolerance)
        self_idx = torch.arange(xyz.shape[0], dtype=torch.int32, device=xyz.device)
        idx, sq = knn_grid(grid, xyz, k=k, cap_per_cell=cap_per_cell, self_idx=self_idx)
    else:
        idx, sq = knn_bruteforce(xyz, xyz, mask, k=k, exclude_self=True, direct=direct)
    valid = (idx >= 0) & (sq <= tolerance * tolerance) & mask[:, None]
    if normals is not None and angle_threshold is not None:
        nb = normals[torch.clamp_min(idx, 0).long()]  # (N,k,3)
        cosang = torch.abs(torch.sum(normals[:, None, :] * nb, dim=-1))
        valid = valid & (cosang >= f32_of(torch.cos, angle_threshold, xyz.device))
    return idx, valid


def propagate_labels(
    init_labels: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_valid: torch.Tensor,
    mask: torch.Tensor,
    max_iters: int = 200,
) -> torch.Tensor:
    """Min-label propagation to a fixed point, or for ``max_iters`` sweeps
    if it has not converged by then.  Dead rows get label N.  (N,) int32."""
    n = init_labels.shape[0]
    labels = torch.where(mask, init_labels.to(torch.int64), n)
    idx = torch.clamp_min(nbr_idx, 0).long()
    tgt = torch.where(nbr_valid, idx, n).reshape(-1)  # dead edges -> slot n

    def sweep(labels):
        nbr_lab = torch.where(nbr_valid, labels[idx], n)
        gathered = torch.minimum(labels, torch.min(nbr_lab, dim=1).values)
        new = torch.full((n + 1,), n, dtype=labels.dtype, device=labels.device)
        new.scatter_reduce_(0, tgt, gathered[:, None].expand(idx.shape).reshape(-1), "amin")
        return torch.where(mask, torch.minimum(gathered, new[:n]), n)

    done = 0
    while done < max_iters:
        for _ in range(min(_SWEEPS_PER_CHECK, max_iters - done) - 1):
            labels = sweep(labels)
        new = sweep(labels)
        done += min(_SWEEPS_PER_CHECK, max_iters - done)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return labels.to(torch.int32)


def euclidean_cluster(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    tolerance: float,
    k: int = 16,
    use_grid: bool = False,
    normals: Optional[torch.Tensor] = None,
    angle_threshold: Optional[float] = None,
    direct: bool = False,
) -> torch.Tensor:
    """Cluster labels (N,) int32: the least point index in the component;
    dead rows get N."""
    idx, valid = radius_graph(xyz, mask, tolerance, k=k, use_grid=use_grid,
                              normals=normals, angle_threshold=angle_threshold, direct=direct)
    init = torch.arange(xyz.shape[0], dtype=torch.int32, device=xyz.device)
    return propagate_labels(init, idx, valid, mask)


def _label_counts(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = labels.shape[0]
    counts = torch.zeros((n + 1,), dtype=torch.int64, device=labels.device)
    return counts.index_add_(0, labels.long(), mask.to(torch.int64))


def cluster_sizes(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N,) size of the cluster each point belongs to (0 for dead), int32."""
    n = labels.shape[0]
    counts = _label_counts(labels, mask)
    return torch.where(mask, counts[torch.clamp(labels.long(), 0, n)], 0).to(torch.int32)


def top_clusters(
    labels: torch.Tensor,
    mask: torch.Tensor,
    num_clusters: int,
    min_size: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``num_clusters`` largest clusters, equal sizes in ascending
    label order (``lax.top_k``'s order; ``torch.topk`` promises none, so
    it ranks the unique key count·(N+1) + (N − label)).

    Returns member (num_clusters, N) bool masks, largest first, and sizes
    (num_clusters,) int32 (0 where fewer clusters exist).
    """
    n = labels.shape[0]
    counts = _label_counts(labels, mask)
    counts[n] = 0  # dead bucket
    label = torch.arange(n + 1, dtype=torch.int64, device=labels.device)
    key, _ = torch.topk(counts * (n + 1) + (n - label), num_clusters)
    sizes, roots = key // (n + 1), n - key % (n + 1)
    ok = sizes >= min_size
    member = (labels.long()[None, :] == roots[:, None]) & mask[None, :] & ok[:, None]
    return member, torch.where(ok, sizes, 0).to(torch.int32)
