"""Point-to-plane ICP — all-point correspondences + 6×6 Gauss-Newton.

Counterpart of ``mapping_private_tpu/registration/icp.py``
(``icp_point_to_plane``): every live source point is matched every sweep,
residuals are Huber-weighted, the 6×6 normal equations are one reduction,
and the pose update is an SE(3) exponential.  The sweep loop is a Python
loop that never reads a value back to the host, so on the card the
sweeps queue up without a sync.  Each sweep's work beside the
correspondence search is ``ops/icp_gn.py``'s Gauss-Newton step: the
hand-written kernel ``csrc/icp_gn.cu`` on CUDA tensors, its plain version
on CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.core.cloud import PAD_COORD
from mapping_private_tpu_torch.ops import icp_gn
from mapping_private_tpu_torch.ops.neighbors import build_grid_hash, knn_bruteforce, nn_grid_1nn
from mapping_private_tpu_torch.ops.nn_argmin import (
    nn_argmin_prepared,
    prepare_nn_ref_argmin,
)
from mapping_private_tpu_torch.ops.tiled_nn import (
    build_compact_tiles,
    check_lattice_dims,
    compact_nn_1nn,
    lattice_occupancy,
    masked_bounds,
    refresh_compact_coords,
    tiled_nn_for_icp,
)
from mapping_private_tpu_torch.utils.metrics import metrics


@dataclasses.dataclass(frozen=True)
class ICPResult:
    transform: torch.Tensor  # (4,4) source → target
    rmse: torch.Tensor  # () residual RMS over accepted correspondences
    num_corr: torch.Tensor  # () int32 accepted correspondences (last sweep)
    per_iter_rmse: torch.Tensor  # (iters,)


def icp_point_to_plane(
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_xyz: torch.Tensor,
    tgt_mask: torch.Tensor,
    tgt_normals: torch.Tensor,
    init_T: Optional[torch.Tensor] = None,
    iters: int = 20,
    max_corr_dist: float = 0.25,
    huber_delta: float = 0.05,
    damping: float = 1e-6,
    nn_backend: str = "auto",
    grid_cell: float = 0.25,
    cap_per_cell: int = 16,
    tile_origin: Optional[Tuple[float, float, float]] = None,
    tile_dims: Optional[Tuple[int, int, int]] = None,
    max_tiles: int = 0,
    rebucket_sweeps: Optional[int] = None,
) -> ICPResult:
    """Align source onto target; runs on the device the tensors are on.

    tgt_normals: (N,3) unit normals for the target (estimate with
    ops.normals.estimate_normals if the scan lacks them).

    nn_backend: 'auto' — exact argmin NN (ops/nn_argmin.py): the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors; 'xla' —
    the dense brute force of ops/neighbors.py (the JAX package's name for
    it); 'grid' — the grid-hash stencil of ops/neighbors.py; 'tiled' —
    the stencil engines of ops/tiled_nn.py, the big-cloud path with
    N·27·cap work, on the lattice (tile_origin, tile_dims): the compact
    occupied-tiles engine with max_tiles bucket rows (use
    icp_point_to_plane_tiled to size them from the clouds), or the dense
    lattice with max_tiles=0.  grid_cell is the cell size of 'grid' and
    the tile size of 'tiled' (must be ≥ the largest correspondence
    distance you care about); cap_per_cell the points kept per cell or
    tile.

    rebucket_sweeps=k (compact engine only; the dense lattice ignores
    it, as in the JAX package): the query slot assignments are rebuilt
    only at the entry of k uniform segments of j = ceil(iters/k) sweeps
    (sweeps 0, j, 2j, …); the other sweeps of a segment re-scatter the
    moved coordinates into that layout (refresh_compact_coords).  A
    query δ from where it was bucketed keeps its guaranteed NN radius
    tile_size − δ.  Without it the queries are re-bucketed every sweep.
    """
    with metrics.span("icp"):
        masked_queries = nn_backend == "auto"  # nn_fn takes queries with dead rows at -PAD_COORD
        if nn_backend == "auto":
            tgt_padded = torch.where(tgt_mask[:, None], tgt_xyz, PAD_COORD)
            tgt_normals = torch.where(tgt_mask[:, None], tgt_normals, 0.0)
            tgt_xyz = tgt_padded
            prepared = prepare_nn_ref_argmin(tgt_padded)  # once, outside the loop

            def nn_fn(q):
                return nn_argmin_prepared(q, prepared)

        elif nn_backend == "xla":

            def nn_fn(p):
                idx, sq = knn_bruteforce(p, tgt_xyz, tgt_mask, k=1)
                return idx[:, 0], sq[:, 0]

        elif nn_backend == "grid":
            grid = build_grid_hash(tgt_xyz, tgt_mask, grid_cell)

            def nn_fn(p):
                return nn_grid_1nn(grid, p, cap_per_cell=cap_per_cell)

        elif nn_backend == "tiled":
            if tile_origin is None or tile_dims is None:
                raise ValueError(
                    "nn_backend='tiled' needs tile_origin/tile_dims — "
                    "call icp_point_to_plane_tiled(...) instead")
            # the target is bucketed once; the queries at their current pose
            origin = torch.as_tensor(tile_origin, dtype=torch.float32, device=tgt_xyz.device)
            if rebucket_sweeps is not None and max_tiles > 0:
                nn_fn = _segmented_nn(
                    tgt_xyz, tgt_mask, src_mask, origin, grid_cell, tile_dims, cap_per_cell,
                    max_tiles, -(-iters // min(max(int(rebucket_sweeps), 1), iters)))
            else:
                nn_fn = tiled_nn_for_icp(
                    tgt_xyz, tgt_mask, origin, grid_cell, tile_dims, cap_per_cell,
                    max_tiles=max_tiles, query_mask=src_mask)

        else:
            raise ValueError(f"unknown nn_backend {nn_backend!r}")

        T = torch.eye(4, dtype=src_xyz.dtype, device=src_xyz.device) if init_T is None else init_T
        with icp_gn.gauss_newton(src_xyz, src_mask, tgt_xyz, tgt_normals, T, iters,
                                 max_corr_dist, huber_delta, damping, masked_queries) as gn:
            for s in range(iters):
                q = gn.apply()
                with metrics.span("icp.nn"):
                    idx, sq = nn_fn(q)
                with metrics.span("icp.gn"):
                    gn.step(idx, sq, s)
        T, per_iter, cnt = gn.result()
        return ICPResult(transform=T, rmse=per_iter[-1], num_corr=cnt[-1], per_iter_rmse=per_iter)


def _segmented_nn(tgt_xyz, tgt_mask, src_mask, origin, tile, dims, cap, max_tiles, seg_len):
    """The compact engine's nn_fn for segmented re-bucketing: the queries
    are bucketed on the first call of every ``seg_len`` calls and only
    re-scattered (refresh_compact_coords) on the others.  The JAX
    package pads the last segment with masked no-op sweeps; here the
    sweep loop simply ends at ``iters``."""
    tgt_tiles = build_compact_tiles(tgt_xyz, tgt_mask, origin, tile, dims, cap, max_tiles)
    calls, layout = 0, None

    def nn_fn(p):
        nonlocal calls, layout
        if calls % seg_len == 0:
            layout = qt = build_compact_tiles(
                p, src_mask, origin, tile, dims, cap, max_tiles, query_only=True)
        else:
            qt = refresh_compact_coords(layout, p)
        calls += 1
        return compact_nn_1nn(tgt_tiles, qt)

    return nn_fn


def _lattice_geom(bt, bs, t):
    """Union lattice geometry from two (lo, hi) bounds pairs, on the
    device, so the sizing chain syncs once (see icp_point_to_plane_tiled)."""
    lo = torch.minimum(bt[0], bs[0]) - 2.0 * t
    hi = torch.maximum(bt[1], bs[1]) + 2.0 * t
    dims = torch.ceil((hi - lo) / t).to(torch.int32)
    return lo, dims


def size_tiled_lattice(src_xyz, src_mask, tgt_xyz, tgt_mask, tile_size: float = 0.25,
                       cap_per_cell: int = 256) -> dict:
    """The tiled backend's lattice for this pair of clouds, as the keyword
    arguments of ``icp_point_to_plane`` (tile_origin, tile_dims,
    cap_per_cell, max_tiles): the union of both clouds' live bounds with
    two tiles of margin.

    Occupied-tile capacity contract: max_tiles MUST cover every
    target-occupied tile — a spilled TARGET tile silently vanishes from
    slot_of and compact_nn_1nn returns a valid-looking *farther*
    neighbour, not −1.  Only QUERY-side spill degrades safely to
    no-correspondence.  It is sized from the union of target and initial
    source occupancy plus 50% margin for source motion, rounded up to a
    power of two.  The per-cell cap carries the same target-side
    contract, so it is raised (to a multiple of 128) to cover the densest
    target cell.

    The whole sizing chain — bounds → union geometry → both occupancies —
    runs on the device and is read by the host in ONE transfer."""
    t = torch.tensor(tile_size, dtype=torch.float32, device=src_xyz.device)
    lo_dev, dims_dev = _lattice_geom(
        masked_bounds(tgt_xyz, tgt_mask), masked_bounds(src_xyz, src_mask), t)
    ot = lattice_occupancy(tgt_xyz, tgt_mask, lo_dev, t, dims_dev)
    os_ = lattice_occupancy(src_xyz, src_mask, lo_dev, t, dims_dev)
    stats = torch.cat([lo_dev.double(), dims_dev.double(), torch.stack([*ot, *os_]).double()])
    stats = stats.cpu().numpy()  # the one sync
    lo = stats[:3].astype(np.float32)
    dims = tuple(int(v) for v in stats[3:6])
    check_lattice_dims(dims, tile_size)
    occ_t, maxcell_t, occ_s = int(stats[6]), int(stats[7]), int(stats[8])
    occ = max(occ_t, occ_s)
    max_tiles = 1 << int(np.ceil(np.log2(max(int(1.5 * occ), 64))))
    if max_tiles < occ_t:
        raise RuntimeError(f"max_tiles {max_tiles} does not cover the target's {occ_t} occupied tiles")
    return dict(tile_origin=tuple(float(v) for v in lo), tile_dims=dims,
                cap_per_cell=max(cap_per_cell, -(-maxcell_t // 128) * 128), max_tiles=max_tiles)


def icp_point_to_plane_tiled(
    src_xyz, src_mask, tgt_xyz, tgt_mask, tgt_normals,
    tile_size: float = 0.25, cap_per_cell: int = 256, **kwargs
) -> ICPResult:
    """Big-cloud ICP: sizes the tile lattice AND the occupied-tile slot
    capacity from the clouds' bounds and occupancy (size_tiled_lattice),
    then runs the solver with the 'tiled' NN backend (compact
    occupied-tile blocks — see ops/tiled_nn.py CompactTiles)."""
    lattice = size_tiled_lattice(src_xyz, src_mask, tgt_xyz, tgt_mask, tile_size, cap_per_cell)
    return icp_point_to_plane(
        src_xyz, src_mask, tgt_xyz, tgt_mask, tgt_normals,
        nn_backend="tiled", grid_cell=tile_size, **lattice, **kwargs)


def ate_rmse(traj_a: torch.Tensor, traj_b: torch.Tensor) -> torch.Tensor:
    """Absolute trajectory error between (K,4,4) pose arrays (translation
    RMS after no alignment — callers pre-align if needed)."""
    d = traj_a[:, :3, 3] - traj_b[:, :3, 3]
    return torch.sqrt(torch.mean(torch.sum(d**2, dim=-1)))
