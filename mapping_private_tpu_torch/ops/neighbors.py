"""Neighbour search: dense brute force and the grid hash.

Counterpart of ``mapping_private_tpu/ops/neighbors.py``.

1. ``knn_bruteforce`` — exact kNN over a dense squared distance matrix
   (‖a‖² + ‖b‖² − 2a·bᵀ, one matmul), sized for the reference's cloud
   sizes (≤ ~50k points).  The matrix is built a block of query rows at a
   time, so a 20k×20k (1.6 GB) or 50k×50k one is never held whole on the
   device.
2. ``build_grid_hash`` / ``nn_grid_1nn`` / ``knn_grid`` /
   ``radius_count_grid`` — points sorted by a 30-bit packed cell key (10
   bits per axis, wrap-around mod 1024; aliasing only ever adds
   candidates, which the exact distance check filters, so results stay
   exact as long as the true neighbour lies within the 27-cell stencil,
   i.e. cell_size ≥ search radius, and no stencil cell holds more than
   ``cap_per_cell`` points).  Per query: 27 binary searches into the
   sorted keys, a fixed-fanout gather and a min or top-k.

Both return (indices, squared distances) with invalid slots marked by
index −1 and distance +inf.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mapping_private_tpu_torch.core.cloud import PAD_COORD
from mapping_private_tpu_torch.utils.metrics import metrics

# Elements of one (rows, N) distance block: 64 Mi floats = 256 MB.
_CHUNK_ELEMS = 1 << 26


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q,3),(N,3) -> (Q,N) squared Euclidean distances via one matmul
    (full f32: the package turns TF32 off at import)."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True).T
    return torch.clamp_min(a2 + b2 - 2.0 * (a @ b.T), 0.0)


def knn_bruteforce(
    query_xyz: torch.Tensor,
    ref_xyz: torch.Tensor,
    ref_mask: torch.Tensor,
    k: int,
    exclude_self: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over a dense distance matrix.

    Args:
      query_xyz: (Q, 3).
      ref_xyz: (N, 3).
      ref_mask: (N,) bool; dead refs never returned.
      k: neighbour count.
      exclude_self: if True, assumes query i == ref i and masks the diagonal.

    Returns:
      idx: (Q, k) int32, −1 where fewer than k live refs exist.
      sq_dists: (Q, k) float32, +inf in the same slots.
    """
    q, n = query_xyz.shape[0], ref_xyz.shape[0]
    rows = max(1, _CHUNK_ELEMS // max(n, 1))
    idx_parts, sq_parts = [], []
    with metrics.span("knn"):
        for s in range(0, q, rows):
            d2 = pairwise_sq_dists(query_xyz[s : s + rows], ref_xyz)
            d2 = d2.masked_fill(~ref_mask[None, :], torch.inf)
            if exclude_self:
                r = torch.arange(d2.shape[0], device=d2.device)
                d2[r, r + s] = torch.inf
            if k == 1:
                idx = torch.argmin(d2, dim=1, keepdim=True)
                sq = torch.gather(d2, 1, idx)
            else:
                sq, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
            valid = torch.isfinite(sq)
            idx_parts.append(torch.where(valid, idx, -1).to(torch.int32))
            sq_parts.append(torch.where(valid, sq, torch.inf))
        return torch.cat(idx_parts), torch.cat(sq_parts)


_KEY_SENTINEL = 1 << 30
_BITS = 10
_MASKB = (1 << _BITS) - 1
# the 27-cell stencil, x-major: the order ties between cells resolve in
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def _cell_key(cell: torch.Tensor) -> torch.Tensor:
    """(...,3) int32 cell coords -> packed 30-bit int32 key (wrap mod 1024
    per axis; ``&`` on a negative int32 is two's complement, as in the
    JAX package, so negative cells get the same keys)."""
    cx = cell[..., 0] & _MASKB
    cy = cell[..., 1] & _MASKB
    cz = cell[..., 2] & _MASKB
    return (cx << (2 * _BITS)) | (cy << _BITS) | cz


def _cells(xyz: torch.Tensor, cell_size) -> torch.Tensor:
    return torch.floor(xyz / cell_size).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class GridHash:
    """Sorted grid-hash index over a fixed-capacity point set."""

    sorted_keys: torch.Tensor  # (N,) int32, ascending; dead points at sentinel
    sorted_idx: torch.Tensor  # (N,) int32 original row ids
    sorted_xyz: torch.Tensor  # (N, 3) gathered positions (dead → PAD_COORD)
    cell_size: torch.Tensor  # scalar


def build_grid_hash(xyz: torch.Tensor, mask: torch.Tensor, cell_size: float) -> GridHash:
    cs = torch.as_tensor(cell_size, dtype=torch.float32, device=xyz.device)
    keys = torch.where(mask, _cell_key(_cells(xyz, cs)), _KEY_SENTINEL)
    order = torch.argsort(keys, stable=True)
    sorted_keys = keys[order]
    sorted_xyz = torch.where((sorted_keys != _KEY_SENTINEL)[:, None], xyz[order], PAD_COORD)
    return GridHash(sorted_keys=sorted_keys, sorted_idx=order.to(torch.int32),
                    sorted_xyz=sorted_xyz, cell_size=cs)


def _cell_slots(grid: GridHash, keys: torch.Tensor, cap_per_cell: int):
    """Positions into the sorted arrays of up to ``cap_per_cell`` points
    of each keyed cell: (slots (..., cap) int64 clipped into range, valid
    (..., cap) bool)."""
    keys = keys.contiguous()
    start = torch.searchsorted(grid.sorted_keys, keys, right=False)
    end = torch.searchsorted(grid.sorted_keys, keys, right=True)
    lane = torch.arange(cap_per_cell, device=keys.device)
    slots = start[..., None] + lane
    valid = slots < end[..., None]
    return slots.clamp_(0, grid.sorted_keys.shape[0] - 1), valid


def _candidate_gather(grid: GridHash, query_xyz: torch.Tensor, cap_per_cell: int):
    """For each query, up to 27*cap candidate slots from the stencil:
    (cand_slot (Q, 27*cap) positions into the sorted arrays, cand_valid
    (Q, 27*cap) bool)."""
    offsets = torch.tensor(_OFFSETS, dtype=torch.int32, device=query_xyz.device)
    cells = _cells(query_xyz, grid.cell_size)[:, None, :] + offsets[None, :, :]  # (Q,27,3)
    slots, valid = _cell_slots(grid, _cell_key(cells), cap_per_cell)
    q = query_xyz.shape[0]
    return slots.reshape(q, -1), valid.reshape(q, -1)


def _cand_sq_dists(grid: GridHash, slots: torch.Tensor, query_xyz: torch.Tensor) -> torch.Tensor:
    d = grid.sorted_xyz[slots] - query_xyz[:, None, :]  # (Q,C,3)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return dx * dx + dy * dy + dz * dz


def nn_grid_1nn(
    grid: GridHash, query_xyz: torch.Tensor, cap_per_cell: int = 16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scalable exact-within-stencil 1-NN, O(Q·cap) memory: exact whenever
    the true NN lies within cell_size of the query and no stencil cell
    overflows cap_per_cell.  The 27 stencil cells are walked one (Q, cap)
    block at a time; a later cell replaces the carried best only on a
    strictly smaller distance.

    Returns (idx (Q,) int32 original row ids or −1, sq_dists (Q,))."""
    q = query_xyz.shape[0]
    qcell = _cells(query_xyz, grid.cell_size)
    best_d2 = torch.full((q,), torch.inf, dtype=query_xyz.dtype, device=query_xyz.device)
    best_slot = torch.zeros((q,), dtype=torch.int64, device=query_xyz.device)
    for off in _OFFSETS:
        keys = _cell_key(qcell + torch.tensor(off, dtype=torch.int32, device=qcell.device))
        slots, valid = _cell_slots(grid, keys, cap_per_cell)  # (Q,cap)
        d2 = torch.where(valid, _cand_sq_dists(grid, slots, query_xyz), torch.inf)
        m, am = torch.min(d2, dim=1)
        upd = m < best_d2
        best_slot = torch.where(upd, torch.gather(slots, 1, am[:, None])[:, 0], best_slot)
        best_d2 = torch.minimum(best_d2, m)
    idx = grid.sorted_idx[best_slot]
    return torch.where(torch.isfinite(best_d2), idx, -1).to(torch.int32), best_d2


def knn_grid(
    grid: GridHash,
    query_xyz: torch.Tensor,
    k: int,
    cap_per_cell: int = 16,
    self_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN via grid-hash stencil gather.

    Exact when the k-th neighbour is within cell_size of the query and
    each stencil cell holds ≤ cap_per_cell points; otherwise a high-recall
    approximation.

    self_idx: optional (Q,) original-row ids to exclude (self-match).
    Returns (idx (Q,k) int32 original row ids or −1, sq_dists (Q,k))."""
    slots, valid = _candidate_gather(grid, query_xyz, cap_per_cell)  # (Q,C)
    cand_idx = grid.sorted_idx[slots]
    d2 = torch.where(valid, _cand_sq_dists(grid, slots, query_xyz), torch.inf)
    if self_idx is not None:
        d2 = torch.where(cand_idx == self_idx[:, None], torch.inf, d2)
    sq, pos = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    idx = torch.gather(cand_idx, 1, pos)
    ok = torch.isfinite(sq)
    return torch.where(ok, idx, -1).to(torch.int32), torch.where(ok, sq, torch.inf)


def radius_count_grid(
    grid: GridHash, query_xyz: torch.Tensor, radius: float, cap_per_cell: int = 16
) -> torch.Tensor:
    """Number of indexed points within ``radius`` of each query (requires
    cell_size ≥ radius for exactness)."""
    slots, valid = _candidate_gather(grid, query_xyz, cap_per_cell)
    hit = valid & (_cand_sq_dists(grid, slots, query_xyz) <= radius * radius)
    return torch.sum(hit, dim=-1, dtype=torch.int32)
