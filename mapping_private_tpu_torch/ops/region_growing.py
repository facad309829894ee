"""Region growing — gated flood fill as masked label propagation.

Counterpart of ``mapping_private_tpu/ops/region_growing.py`` (the
reference's ``RegionGrowing``, cloud_algos/src/region_growing.cpp:48-120):
the BFS that expands a cluster by radius search becomes connected
components over the radius graph restricted to *growable* points, with
two gates:

- ``grow_mask``: only these points may join a region (the grow-into
  predicate and the channel gate folded in);
- ``seed_mask``: only components holding at least one seed survive (the
  grow-from predicate); the others get label N (unclustered).
"""
from __future__ import annotations

from typing import Optional

import torch

from mapping_private_tpu_torch.ops.cluster import propagate_labels, radius_graph


def region_grow(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    radius: float,
    grow_mask: Optional[torch.Tensor] = None,
    seed_mask: Optional[torch.Tensor] = None,
    k: int = 16,
    use_grid: bool = False,
    normals: Optional[torch.Tensor] = None,
    angle_threshold: Optional[float] = None,
) -> torch.Tensor:
    """Cluster labels (N,) int32: the least point index of the region, N
    for dead, non-growable and seedless points.

    Args:
      grow_mask: points that may be grown *into* (default: all live).
      seed_mask: points that may *start* a region; a region without a
        seed is dropped (default: every growable point is a seed).
    """
    n = xyz.shape[0]
    growable = mask if grow_mask is None else (mask & grow_mask)
    idx, valid = radius_graph(xyz, growable, radius, k=k, use_grid=use_grid,
                              normals=normals, angle_threshold=angle_threshold)
    init = torch.arange(n, dtype=torch.int32, device=xyz.device)
    labels = propagate_labels(init, idx, valid, growable)
    if seed_mask is not None:
        seeds = growable & seed_mask
        # a region survives iff any member is a seed: count seeds by label
        has_seed = torch.zeros((n + 1,), dtype=torch.int32, device=xyz.device)
        has_seed.index_add_(0, torch.where(growable, labels, n).long(), seeds.to(torch.int32))
        labels = torch.where(growable & (has_seed[torch.clamp(labels, 0, n).long()] > 0), labels, n)
    return labels.to(torch.int32)
