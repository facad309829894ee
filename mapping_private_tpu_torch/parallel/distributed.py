"""Distributed registration: sharded Gauss-Newton over ranks.

Counterpart of ``mapping_private_tpu/parallel/distributed.py``.  JAX
builds one SPMD program over a mesh; the port runs one process per rank
(``torch.distributed``), so each ``make_*`` returns ``(step_fn,
shard_fn)``:

- ``shard_fn(*global_arrays)`` cuts this rank's pieces (numpy arrays or
  tensors) as the JAX ``PartitionSpec``s lay them out and puts them on
  the mesh's device;
- ``step_fn(*pieces)`` runs the step: ``psum`` over an axis is an
  ``all_reduce`` on that axis's process group, ``all_gather`` over the
  axes an ``all_gather`` on each axis's group in turn.

At world size 1 the same code runs, with one-rank collectives.

Each shard's exact 1-NN of the brute steps is the matmul-form search
``ops.nn_matmul`` (the hand-written kernel on a CUDA tensor, its plain
version on a CPU one), where the JAX package forms the (N, M) matrix
d² = q² + r² − 2 q·r.  Two consequences, both kept equal to JAX:

- dead refs carry +PAD_COORD into the search (JAX writes inf into d²),
  and a winner that is a dead row gets d² = inf afterwards;
- JAX clamps d² at 0 before its argmin; the kernel ranks the unclamped
  values, so the clamp follows the search.  Indices can then differ from
  JAX's only where several refs lie within ~4·eps·(|q|² + |r|²) of a
  query's least d².

Cross-shard winners: every shard's best (d², point, normal) is gathered
axis by axis in the mesh's axis order, as the JAX loop does, so on a
(dp, sp) mesh the gathered order is sp-major while the shards of
``P(axes)`` are dp-major; an exact d² tie across shards goes to the first
in the gathered order (``torch.argmin``, like ``jnp.argmin``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.func import vmap

from mapping_private_tpu_torch.core.cloud import PAD_COORD
from mapping_private_tpu_torch.core.se3 import se3_apply, se3_exp
from mapping_private_tpu_torch.ops.nn_matmul import nn_matmul
from mapping_private_tpu_torch.ops.tiled_nn import (
    build_compact_tiles,
    check_lattice_dims,
    compact_nn_1nn,
)
from mapping_private_tpu_torch.parallel.mesh import (
    all_gather_stack,
    all_reduce_sum,
    block,
    shard_index,
    to_mesh_device,
)


def _point_to_plane_system(p, q, n, ok, huber_delta):
    """Huber-weighted point-to-plane normal equations of the correspondences
    (p, q, n) where ``ok``: (H (6,6), g (6,), count int32)."""
    r = torch.sum(n * (p - q), dim=-1)
    absr = torch.abs(r)
    w = torch.where(absr <= huber_delta, 1.0, huber_delta / torch.clamp_min(absr, 1e-12))
    w = torch.where(ok, w, 0.0)
    J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)
    Jw = J * w[:, None]
    return J.T @ Jw, Jw.T @ r, torch.sum(ok, dtype=torch.int32)


def _solve_update(H, g, T, damping):
    """T ← exp(−(H + damping·I)⁻¹ g) · T, batched over leading dims."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    xi = -torch.linalg.solve(H + damping * eye, g)
    if xi.ndim == 1:
        return se3_exp(xi) @ T
    return vmap(se3_exp)(xi) @ T


def _nn_with_pad(p, ref_xyz, ref_mask, rows: int = 0):
    """Exact 1-NN of ``p`` among the live refs through ``ops.nn_matmul``
    (``rows`` queries a call, all at once when 0): (idx int64, d²) with d²
    clamped at 0, and inf where the winner is a dead row."""
    refs = torch.where(ref_mask[:, None], ref_xyz, PAD_COORD).contiguous()
    rows = rows if rows and p.shape[0] > rows else p.shape[0]
    parts = [nn_matmul(p[s : s + rows].contiguous(), refs) for s in range(0, p.shape[0], rows)]
    idx = torch.cat([i for i, _ in parts]).long()
    sq = torch.cat([d for _, d in parts])
    return idx, torch.where(ref_mask[idx], torch.clamp_min(sq, 0.0), torch.inf)


def _pair_partial_system(
    src: torch.Tensor,  # (n_local, 3) this rank's slice of source points
    src_mask: torch.Tensor,  # (n_local,)
    tgt: torch.Tensor,  # (N, 3) full target (replicated over sp)
    tgt_mask: torch.Tensor,  # (N,)
    tgt_normals: torch.Tensor,  # (N, 3)
    T: torch.Tensor,  # (4,4) current pose estimate
    max_corr_dist: float,
    huber_delta: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial (H, g, count) from this shard's correspondences."""
    p = se3_apply(T, src)
    idx, sq = _nn_with_pad(p, tgt, tgt_mask)
    ok = src_mask & (sq <= max_corr_dist * max_corr_dist)
    return _point_to_plane_system(p, tgt[idx], tgt_normals[idx], ok, huber_delta)


def _cross_shard_winner(cand: torch.Tensor, mesh, axes):
    """The global best of every shard's (N, 7) candidates [d², q, n]."""
    allc = cand
    for a in axes:
        allc = all_gather_stack(allc, mesh.get_group(a)).reshape((-1,) + tuple(cand.shape))
    win = torch.argmin(allc[..., 0], dim=0)  # first minimum in gathered order
    sel = torch.gather(allc, 0, win[None, :, None].expand(1, *cand.shape))[0]
    return sel[:, 0], sel[:, 1:4], sel[:, 4:7]


def _map_shard_fn(mesh, axes):
    """shard_fn of the map steps: scan, mask and pose replicated, the map's
    xyz, mask and normals sharded over every mesh axis."""

    def shard(scan, scan_mask, map_xyz, map_mask, map_normals, T):
        k, n = shard_index(mesh, axes)
        put = lambda a: to_mesh_device(mesh, a)  # noqa: E731
        return (put(scan), put(scan_mask), put(block(map_xyz, k, n)), put(block(map_mask, k, n)),
                put(block(map_normals, k, n)), put(T))

    return shard


def make_sharded_map_icp_step(
    mesh,
    max_corr_dist: float = 0.3,
    huber_delta: float = 0.05,
    damping: float = 1e-6,
    scan_chunk: int = 0,
):
    """One scan-to-map GN iteration with the MAP sharded over every mesh
    axis: each rank finds its shard's best correspondence per scan point
    (the brute-force ``nn_matmul`` search, ``scan_chunk`` scan rows a call
    when nonzero; the result does not depend on it); one all_gather of the
    per-shard winners (7 floats a query a shard) and a cross-shard argmin
    give the exact global NN; every rank then builds and solves the same
    GN system (the scan is replicated).

    Returns (step_fn, shard_fn) for step_fn(scan (N,3), scan_mask,
    map_xyz (M/n,3), map_mask, map_normals, T (4,4)) → (T_new, num_corr)."""
    axes = tuple(mesh.mesh_dim_names)

    def step(scan, scan_mask, mxyz, mmask, mnrm, T):
        p = se3_apply(T, scan)
        loc, best_d2 = _nn_with_pad(p, mxyz, mmask, scan_chunk)
        cand = torch.cat([best_d2[:, None], mxyz[loc], mnrm[loc]], dim=1)
        sq, q, n = _cross_shard_winner(cand, mesh, axes)
        ok = scan_mask & (sq <= max_corr_dist * max_corr_dist)
        H, g, cnt = _point_to_plane_system(p, q, n, ok, huber_delta)
        return _solve_update(H, g, T, damping), cnt

    return step, _map_shard_fn(mesh, axes)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def size_map_lattice(
    map_xyz,
    map_mask,
    tile_size: float,
    scan_xyz=None,
    tile_margin: float = 1.5,
):
    """Size the static tile lattice of the tiled sharded map-ICP from
    CONCRETE map (and optionally scan) bounds, on the host in numpy.
    Returns (origin, dims, cap, max_tiles).

    max_tiles covers the GLOBAL map occupancy, so every shard's slice
    (≤ global occupancy) is covered too — target-side spill would return
    farther neighbours, never −1 (see ops.tiled_nn.build_compact_tiles)."""
    pts = [_host(map_xyz)[_host(map_mask)]]
    if scan_xyz is not None:
        s = _host(scan_xyz)
        # drop PAD_COORD sentinel rows of padded scans — one stray +1e8
        # row would blow the lattice bounds (and the D+1 slot_of alloc)
        pts.append(s[np.all(np.abs(s) < 1e7, axis=1)])
    lo = np.min([p.min(0) for p in pts], axis=0) - 2 * tile_size
    hi = np.max([p.max(0) for p in pts], axis=0) + 2 * tile_size
    dims = tuple(int(v) for v in np.ceil((hi - lo) / tile_size))
    check_lattice_dims(dims, tile_size)
    cell = np.floor((pts[0] - lo) / tile_size).astype(np.int64)
    flat = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    _, counts = np.unique(flat, return_counts=True)
    occ, percell = len(counts), int(counts.max())
    cap = max(128, -(-percell // 128) * 128)
    max_tiles = 1 << int(np.ceil(np.log2(max(int(tile_margin * occ), 64))))
    return tuple(float(v) for v in lo), dims, cap, max_tiles


def make_sharded_map_icp_step_tiled(
    mesh,
    origin,
    tile_size: float,
    dims,
    cap: int,
    max_tiles: int,
    q_cap: int = 128,
    q_max_tiles: int = 4096,
    max_corr_dist: float = 0.3,
    huber_delta: float = 0.05,
    damping: float = 1e-6,
    sweeps: int = 1,
):
    """Sharded scan-to-map ICP with the COMPACT-TILES NN engine per shard
    (``ops.tiled_nn``) in place of the brute-force search, for 64k–1M map
    points a rank.

    Each rank buckets its map slice ONCE per step call; the replicated scan
    re-buckets every GN sweep (it moves, and it is small); per-shard
    winners exchange through the same 7-float gather and cross-shard
    argmin, so the result is the exact global NN within ``tile_size``.
    ``sweeps`` GN iterations reuse the map buckets.

    The lattice (origin/tile_size/dims/cap/max_tiles) must be sized from
    concrete bounds — use size_map_lattice.  q_max_tiles bounds the SCAN's
    occupied tiles (query spill degrades to no-correspondence, which is
    safe).

    Returns (step_fn, shard_fn) with the signature of
    make_sharded_map_icp_step: step_fn(...) → (T_new, num_corr at the last
    sweep)."""
    axes = tuple(mesh.mesh_dim_names)
    dims = tuple(int(d) for d in dims)

    def step(scan, scan_mask, mxyz, mmask, mnrm, T):
        tiles = build_compact_tiles(mxyz, mmask, origin, tile_size, dims, cap, max_tiles)
        cnt = None
        for _ in range(sweeps):
            p = se3_apply(T, scan)
            qt = build_compact_tiles(p, scan_mask, origin, tile_size, dims, q_cap, q_max_tiles,
                                     query_only=True)
            idx, sq = compact_nn_1nn(tiles, qt)
            has = idx >= 0
            i = torch.clamp_min(idx, 0).long()
            cand = torch.cat([torch.where(has, sq, torch.inf)[:, None], mxyz[i], mnrm[i]], dim=1)
            sq_g, q, n = _cross_shard_winner(cand, mesh, axes)
            ok = scan_mask & (sq_g <= max_corr_dist * max_corr_dist)
            H, g, cnt = _point_to_plane_system(p, q, n, ok, huber_delta)
            T = _solve_update(H, g, T, damping)
        return T, cnt

    return step, _map_shard_fn(mesh, axes)


def make_sharded_registration_step(
    mesh,
    max_corr_dist: float = 0.25,
    huber_delta: float = 0.05,
    damping: float = 1e-6,
):
    """A batch of (source, target) scan pairs sharded over ``dp``; within a
    pair the source points shard over ``sp``, so each rank scores its slice
    of correspondences against the (replicated) target and contributes a
    partial 6×6 system; one all_reduce over ``sp`` assembles it.

    Returns (step_fn, shard_fn) for step_fn(src (B/dp, N/sp, 3), src_mask,
    tgt (B/dp, N, 3), tgt_mask, tgt_normals, poses (B/dp, 4, 4)) → (this
    rank's dp block of the updated poses (B/dp, 4, 4), of the
    correspondence counts (B/dp,)); the global arrays are the blocks in dp
    order, as the JAX step's outputs ``P("dp")`` are."""
    sp = mesh.get_group("sp")

    def step(src, src_mask, tgt, tgt_mask, tgt_normals, poses):
        parts = [_pair_partial_system(src[b], src_mask[b], tgt[b], tgt_mask[b], tgt_normals[b], poses[b],
                                      max_corr_dist, huber_delta) for b in range(src.shape[0])]
        H, g, cnt = (all_reduce_sum(torch.stack(t), sp) for t in zip(*parts))
        return _solve_update(H, g, poses, damping), cnt

    def shard(src, src_mask, tgt, tgt_mask, tgt_normals, poses):
        d, n_dp = shard_index(mesh, ("dp",))
        s, n_sp = shard_index(mesh, ("sp",))
        put = lambda a: to_mesh_device(mesh, a)  # noqa: E731
        return (put(block(block(src, d, n_dp), s, n_sp, dim=1)),
                put(block(block(src_mask, d, n_dp), s, n_sp, dim=1)),
                *(put(block(a, d, n_dp)) for a in (tgt, tgt_mask, tgt_normals, poses)))

    return step, shard


def balance_map_shards(map_xyz, mask, tile_size: float, n_shards: int):
    """Occupancy-balancing permutation for the evenly row-sharded map.

    The sharded tiled map step splits map rows into contiguous equal
    blocks; on a spatially ordered skewed scene (corridor + dense
    cluster) that gives shards very different occupied-tile counts, and
    the global max_tiles must cover the WORST shard's occupancy.  This
    host-side helper returns a permutation that deals live points
    round-robin over shards in lattice-tile order, so every shard samples
    every region and the per-shard occupied-tile counts equalize.  Apply
    as ``map_xyz[perm]`` (and to masks/normals) before sharding."""
    xyz = _host(map_xyz)
    m = _host(mask)
    if not m.any():
        return np.arange(len(xyz), dtype=np.int64)  # nothing to balance
    lo = xyz[m].min(0) - tile_size
    cell = np.floor((xyz - lo) / tile_size).astype(np.int64)
    ext = cell[m].max(0) + 1
    flat = (cell[:, 0] * ext[1] + cell[:, 1]) * ext[2] + cell[:, 2]
    flat = np.where(m, flat, np.int64(1) << 60)  # dead rows sort last
    order = np.argsort(flat, kind="stable")
    # deal in tile order: position i of the sorted list goes to shard
    # i % n_shards, preserving tile order within each shard
    M = len(xyz)
    perm = np.empty(M, np.int64)
    pos = 0
    for s in range(n_shards):
        sel = order[s::n_shards]
        perm[pos : pos + len(sel)] = sel
        pos += len(sel)
    return perm
