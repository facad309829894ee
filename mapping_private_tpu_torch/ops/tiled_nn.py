"""Tiled dense 1-NN — the big-cloud correspondence engine.

Counterpart of ``mapping_private_tpu/ops/tiled_nn.py``: both clouds are
bucketed into a lattice of spatial tiles, and dense (P_q × P_t) distance
blocks are computed between each query tile and its 27 neighbour target
tiles.  Work drops from N² to N·27·cap.  Two engines:

- the dense lattice (``TileSet``, ``build_tiles``, ``tiled_nn_1nn``):
  every lattice cell gets a bucket row, occupied or not;
- the compact engine (``CompactTiles``): only occupied tiles get bucket
  rows, and a dense ``slot_of`` lookup (one int32 per lattice cell)
  resolves stencil neighbours.  ``refresh_compact_coords`` re-scatters
  moved coordinates into an existing slot layout.

Both walk the stencil a chunk of query tiles at a time, so no distance
block passes ``_CHUNK_ELEMS`` floats, and both take distances from
direct coordinate differences.

Exactness: the true NN is found whenever it lies within ``tile_size`` of
the query (the 3³ stencil then covers it) and neither point's tile
overflowed ``cap``.  Overflowed queries return idx −1 (callers treat
them as no-correspondence, exactly like an out-of-range match).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

# Elements of one (tiles, Q, P) distance block: the stencil loop runs
# over this many query tiles or slots at a time (64 Mi floats, 256 MB per
# temporary; 4096 tiles of 128 × 128).
_CHUNK_ELEMS = 1 << 26
_OFFSETS = [(ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1) for oz in (-1, 0, 1)]


def _block_min(qp, cp, cvalid, cidx, bd, bi) -> None:
    """One stencil offset for a chunk of query tiles: the (t, Q, P) block
    of squared distances between the query planes ``qp`` (t, 3, Q) and
    the target planes ``cp`` (t, 3, P), from direct differences; rows
    ``cvalid`` (t, P) marks dead are inf.  The best (t, Q) distance
    ``bd`` and target row ``bi`` are updated in place where this offset
    is strictly closer.  Among equal distances in one block the first
    position wins (``torch.min``, like ``jnp.argmin``)."""
    ex = qp[:, 0, :, None] - cp[:, 0, None, :]
    ey = qp[:, 1, :, None] - cp[:, 1, None, :]
    ez = qp[:, 2, :, None] - cp[:, 2, None, :]
    d2 = ex * ex + ey * ey + ez * ez
    d2 = torch.where(cvalid[:, None, :], d2, torch.inf)
    m, am = torch.min(d2, dim=-1)
    sel = torch.gather(cidx, -1, am)
    upd = m < bd
    bi.copy_(torch.where(upd, sel, bi))
    bd.copy_(torch.minimum(bd, m))


@dataclasses.dataclass(frozen=True)
class TileSet:
    """Points bucketed into a (Dx·Dy·Dz, cap) tile lattice; coordinates
    are stored as planes (T, 3, cap)."""

    xyz: torch.Tensor      # (T, 3, cap) padded member coordinate planes
    valid: torch.Tensor    # (T, cap) bool
    idx: torch.Tensor      # (T, cap) int32 original rows (-1 pad)
    tile_of: torch.Tensor  # (N,) int32 flat tile id per original row (T when dead)
    rank_of: torch.Tensor  # (N,) int32 rank within tile (may exceed cap)
    origin: torch.Tensor   # (3,)
    tile_size: torch.Tensor  # ()
    dims: Tuple[int, int, int]
    cap: int


@dataclasses.dataclass(frozen=True)
class CompactTiles:
    """Occupied-tiles-only bucketing."""

    xyz: torch.Tensor         # (S, 3, cap) occupied-tile coordinate planes
    valid: torch.Tensor       # (S, cap)
    idx: torch.Tensor         # (S, cap) int32 original rows (-1 pad)
    tile_id: torch.Tensor     # (S,) int32 flat lattice id (D for dead slots)
    slot_of: torch.Tensor     # (D+1,) int32 lattice id → slot (-1 empty)
    slot_of_pt: torch.Tensor  # (N,) int32 slot per original row (-1 spilled)
    rank_of: torch.Tensor     # (N,) int32 rank within the tile
    origin: torch.Tensor      # (3,)
    tile_size: torch.Tensor   # ()
    dims: Tuple[int, int, int]
    cap: int
    max_tiles: int


def _flat_cells(xyz: torch.Tensor, origin: torch.Tensor, tile_size, dims) -> torch.Tensor:
    """(N,) int32 flat lattice cell of each point, clamped to the border."""
    cell = torch.floor((xyz - origin) / tile_size).to(torch.int32)
    cx = cell[:, 0].clamp(0, dims[0] - 1)
    cy = cell[:, 1].clamp(0, dims[1] - 1)
    cz = cell[:, 2].clamp(0, dims[2] - 1)
    return (cx * dims[1] + cy) * dims[2] + cz


def _stencil_coords(tid: torch.Tensor, dims):
    dz, dy = dims[2], dims[1]
    return tid // (dy * dz), (tid // dz) % dy, tid % dz


def build_tiles(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    origin,
    tile_size: float,
    dims: Tuple[int, int, int],
    cap: int,
) -> TileSet:
    """Bucket a fixed-capacity cloud into the dense lattice.

    origin/dims/tile_size define the lattice (callers size it from the
    scene bounds); points outside are clamped to border tiles.  Dead
    rows, and rows beyond ``cap`` in their tile, are written to a spare
    tile T, several to the same place; it is sliced off before anything
    reads it, so the order of those writes does not matter."""
    n = xyz.shape[0]
    dev = xyz.device
    dims = tuple(int(d) for d in dims)
    T = dims[0] * dims[1] * dims[2]
    t = torch.as_tensor(tile_size, dtype=torch.float32, device=dev)
    o = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    flat = torch.where(mask, _flat_cells(xyz, o, t, dims), T)
    order = torch.argsort(flat, stable=True)
    fs = flat[order]
    rank = torch.arange(n, device=dev) - torch.searchsorted(fs, fs, right=False)
    keep = (fs < T) & (rank < cap)
    tile = torch.where(keep, fs, T).long()
    slot = torch.where(keep, rank, 0)
    i32 = dict(dtype=torch.int32, device=dev)
    bx = torch.zeros((T + 1, cap, 3), dtype=xyz.dtype, device=dev)
    bx[tile, slot] = xyz[order]
    bvalid = torch.zeros((T + 1, cap), dtype=torch.bool, device=dev)
    bvalid[tile, slot] = keep
    bidx = torch.full((T + 1, cap), -1, **i32)
    bidx[tile, slot] = torch.where(keep, order, -1).to(torch.int32)
    tile_of = torch.zeros((n,), **i32)
    tile_of[order] = torch.clamp_max(fs, T).to(torch.int32)
    rank_of = torch.zeros((n,), **i32)
    rank_of[order] = rank.to(torch.int32)
    return TileSet(
        xyz=bx[:T].transpose(1, 2).contiguous(), valid=bvalid[:T], idx=bidx[:T],
        tile_of=tile_of, rank_of=rank_of, origin=o, tile_size=t, dims=dims, cap=cap,
    )


def tiled_nn_1nn(
    tgt: TileSet, qry: TileSet, query_xyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-within-tile_size 1-NN of every query against the target set.

    qry must be built over the SAME lattice as tgt; query_xyz are the
    original query coordinates (only their count is read).  Work: 27
    offsets × (T, Q, P) dense blocks, a chunk of tiles at a time, in
    x-major offset order; a later offset replaces the carried best only
    on a strictly smaller distance.  Returns (idx (N,) int32 target rows
    or −1, sq_dists (N,))."""
    dx, dy, dz = tgt.dims
    T = dx * dy * dz
    Q, P = qry.cap, tgt.cap
    dev = qry.xyz.device
    best_d2 = torch.full((T, Q), torch.inf, dtype=qry.xyz.dtype, device=dev)
    best_idx = torch.full((T, Q), -1, dtype=torch.int32, device=dev)
    rows = max(1, _CHUNK_ELEMS // (Q * P))
    for t0 in range(0, T, rows):
        tid = torch.arange(t0, min(T, t0 + rows), device=dev)
        tx, ty, tz = _stencil_coords(tid, tgt.dims)
        qp = qry.xyz[t0 : t0 + rows]
        bd, bi = best_d2[t0 : t0 + rows], best_idx[t0 : t0 + rows]  # views
        for ox, oy, oz in _OFFSETS:
            nx_, ny_, nz_ = tx + ox, ty + oy, tz + oz
            ok = (nx_ >= 0) & (nx_ < dx) & (ny_ >= 0) & (ny_ < dy) & (nz_ >= 0) & (nz_ < dz)
            nid = torch.where(ok, (nx_ * dy + ny_) * dz + nz_, 0)
            _block_min(qp, tgt.xyz[nid], tgt.valid[nid] & ok[:, None], tgt.idx[nid], bd, bi)

    # back to the original query order; overflowed and dead queries → −1
    ok_pt = (qry.rank_of < Q) & (qry.tile_of < T)
    srow = torch.clamp_max(qry.tile_of, T - 1).long()
    srank = torch.clamp_max(qry.rank_of, Q - 1).long()
    idx = torch.where(ok_pt, best_idx[srow, srank], -1)
    d2 = torch.where(ok_pt, best_d2[srow, srank], torch.inf)
    return idx.to(torch.int32), d2


def build_compact_tiles(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    origin,
    tile_size: float,
    dims: Tuple[int, int, int],
    cap: int,
    max_tiles: int,
    query_only: bool = False,
) -> CompactTiles:
    """Bucket points into occupied-tile slots (sorted-run compaction).

    Occupied tiles beyond ``max_tiles`` spill: their points get slot −1.
    On the QUERY side of compact_nn_1nn that reads back as
    no-correspondence (idx −1), the same safe contract as cap overflow.
    On the TARGET side it is NOT safe: a spilled target tile vanishes
    from ``slot_of``, so queries near it get a valid-looking *farther*
    neighbour instead of −1.  max_tiles MUST cover every target-occupied
    tile — size it from concrete occupancy counts
    (see icp_point_to_plane_tiled).

    All points that are not kept (dead, spilled, beyond cap) are written
    to one spare bucket row, which is sliced off.  The scatters do not
    depend on write order: in ``xyz``, ``valid`` and ``idx`` every kept
    point has a destination of its own, and ``tile_id`` and ``slot_of``
    are written once per kept point of a slot, each time with the same
    value."""
    n = xyz.shape[0]
    dev = xyz.device
    dims = tuple(int(d) for d in dims)
    D = dims[0] * dims[1] * dims[2]
    t = torch.as_tensor(tile_size, dtype=torch.float32, device=dev)
    o = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    flat = torch.where(mask, _flat_cells(xyz, o, t, dims), D)
    order = torch.argsort(flat, stable=True)
    fs = flat[order]
    live = fs < D
    is_first = torch.ones_like(live)
    is_first[1:] = fs[1:] != fs[:-1]
    is_first &= live
    slot = torch.cumsum(is_first, dim=0) - 1  # per sorted point
    first_pos = torch.searchsorted(fs, fs, right=False)
    rank = torch.arange(n, device=dev) - first_pos
    keep = live & (slot < max_tiles) & (rank < cap)
    s = torch.where(keep, slot, max_tiles)
    r = torch.where(keep, rank, 0)
    i32 = dict(dtype=torch.int32, device=dev)
    bx = torch.zeros((max_tiles + 1, cap, 3), dtype=xyz.dtype, device=dev)
    bx[s, r] = xyz[order]
    tile_id = torch.full((max_tiles + 1,), D, **i32)
    tile_id[s] = torch.where(keep, fs, D)
    slot_of_pt = torch.zeros((n,), **i32)
    slot_of_pt[order] = torch.where(live & (slot < max_tiles), slot, -1).to(torch.int32)
    rank_of = torch.zeros((n,), **i32)
    rank_of[order] = rank.to(torch.int32)
    if query_only:
        # the QUERY side of compact_nn_1nn reads only xyz/tile_id/
        # slot_of_pt/rank_of — skip the valid/idx/slot_of scatters
        bvalid = torch.zeros((max_tiles, cap), dtype=torch.bool, device=dev)
        bidx = torch.full((max_tiles, cap), -1, **i32)
        slot_of = torch.full((D + 1,), -1, **i32)
    else:
        bvalid = torch.zeros((max_tiles + 1, cap), dtype=torch.bool, device=dev)
        bvalid[s, r] = keep
        bvalid = bvalid[:max_tiles]
        bidx = torch.full((max_tiles + 1, cap), -1, **i32)
        bidx[s, r] = torch.where(keep, order, -1).to(torch.int32)
        bidx = bidx[:max_tiles]
        slot_of = torch.full((D + 1,), -1, **i32)
        slot_of[torch.where(keep, fs, D).long()] = s.to(torch.int32)
        slot_of[D] = -1
    return CompactTiles(
        xyz=bx[:max_tiles].transpose(1, 2).contiguous(), valid=bvalid, idx=bidx,
        tile_id=tile_id[:max_tiles], slot_of=slot_of, slot_of_pt=slot_of_pt,
        rank_of=rank_of, origin=o, tile_size=t, dims=dims, cap=cap, max_tiles=max_tiles,
    )


def check_lattice_dims(dims, radius) -> None:
    """Guard every host-side lattice sizing against int32 key overflow.

    build_compact_tiles / lattice_occupancy compute flat int32 cell keys
    and allocate a (n_cells+1,) slot_of table; dims whose product nears
    2**31 wrap the keys (garbage occupancy → under-sized max_tiles →
    silently FARTHER neighbours) or hit a multi-GB allocation with no
    clear error.  Call from every wrapper that turns concrete bounds
    into a lattice (nn_1nn, icp_point_to_plane_tiled)."""
    n_cells = int(dims[0]) * int(dims[1]) * int(dims[2])
    if n_cells >= 2 ** 31:
        raise ValueError(
            f"tile lattice {tuple(int(d) for d in dims)} has {n_cells} "
            f"cells >= 2**31: int32 flat cell keys would wrap (silent "
            f"wrong neighbors). Increase the search radius/tile size "
            f"(currently {float(radius)}) or crop the cloud extent.")
    if n_cells > 1 << 28:  # slot_of alone > 1 GiB int32
        raise ValueError(
            f"tile lattice {tuple(int(d) for d in dims)} has {n_cells} "
            f"cells (> 2**28): the (n_cells+1,) slot lookup table would "
            f"exceed 1 GiB. Increase the search radius/tile size "
            f"(currently {float(radius)}) or crop the cloud extent.")


def masked_bounds(xyz: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo (3,), hi (3,)) of the live points, on the device (wrappers that
    size lattices transfer these scalars instead of pulling the cloud)."""
    big = 1e8
    return (torch.where(mask[:, None], xyz, big).amin(dim=0),
            torch.where(mask[:, None], xyz, -big).amax(dim=0))


def lattice_occupancy(xyz: torch.Tensor, mask: torch.Tensor, origin, tile, dims
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(occupied-cell count, max points in one cell) on the lattice, as
    two int32 device scalars.  ``origin`` (3,), ``tile`` and ``dims``
    (3,) may be device tensors, so a sizing chain can run to its end
    before the host reads anything."""
    dev = xyz.device
    o = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    d = torch.as_tensor(dims, dtype=torch.int32, device=dev)
    cell = torch.floor((xyz - o) / tile).to(torch.int32)
    cell = torch.minimum(torch.clamp_min(cell, 0), d - 1)
    key = (cell[:, 0] * d[1] + cell[:, 1]) * d[2] + cell[:, 2]
    dead = 2 ** 31 - 1
    ks, _ = torch.sort(torch.where(mask, key, dead))
    live = ks < dead
    newrun = torch.ones_like(live)
    newrun[1:] = ks[1:] != ks[:-1]
    occ = torch.sum(newrun & live, dtype=torch.int32)
    first = torch.searchsorted(ks, ks, right=False)
    run_len = torch.arange(1, xyz.shape[0] + 1, device=dev) - first
    maxcell = torch.where(live, run_len, 0).amax().to(torch.int32)
    return occ, maxcell


def refresh_compact_coords(ct: CompactTiles, xyz: torch.Tensor) -> CompactTiles:
    """Re-scatter CURRENT coordinates into an existing slot layout — the
    cheap between-sweeps path of segmented tiled ICP: the bucket
    assignments (argsort-bound) are reused, and only the (N, 3)
    coordinates are scattered, through ``slot_of_pt`` and ``rank_of``.
    The planes equal those a build at the same assignments would write.

    Exactness shrinks gracefully: a point that moved δ from where it was
    bucketed is still guaranteed its true NN within ``tile_size − δ``
    (the 3³ stencil around the stale tile covers that ball)."""
    keep = (ct.slot_of_pt >= 0) & (ct.rank_of < ct.cap)
    s = torch.where(keep, ct.slot_of_pt, ct.max_tiles).long()
    r = torch.where(keep, ct.rank_of, 0).long()
    bx = torch.zeros((ct.max_tiles + 1, ct.cap, 3), dtype=xyz.dtype, device=xyz.device)
    bx[s, r] = xyz  # unkept rows all land in the spare row, sliced off
    return dataclasses.replace(ct, xyz=bx[: ct.max_tiles].transpose(1, 2).contiguous())


def compact_nn_1nn(tgt: CompactTiles, qry: CompactTiles) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-within-tile_size 1-NN over occupied tiles only.

    Results are scattered back to the original query rows via
    qry.slot_of_pt/rank_of; qry shares tgt's lattice.  Work: 27 offsets ×
    (S, Q, P) dense blocks with S = query slots, a chunk of slots at a
    time.  The stencil is walked in x-major offset order and a later
    offset replaces the carried best only on a strictly smaller distance.

    Returns (idx (N,) int32 target rows or −1, sq_dists (N,))."""
    dx, dy, dz = tgt.dims
    D = dx * dy * dz
    S, Q, P = qry.max_tiles, qry.cap, tgt.cap
    dev = qry.xyz.device
    best_d2 = torch.full((S, Q), torch.inf, dtype=qry.xyz.dtype, device=dev)
    best_idx = torch.full((S, Q), -1, dtype=torch.int32, device=dev)
    rows = max(1, _CHUNK_ELEMS // (Q * P))
    for s0 in range(0, S, rows):
        tid = qry.tile_id[s0 : s0 + rows]  # lattice id, D for dead slots
        tx, ty, tz = _stencil_coords(tid, tgt.dims)
        slot_live = tid < D
        qp = qry.xyz[s0 : s0 + rows]  # (s, 3, Q)
        bd, bi = best_d2[s0 : s0 + rows], best_idx[s0 : s0 + rows]  # views
        for ox, oy, oz in _OFFSETS:
            nx_, ny_, nz_ = tx + ox, ty + oy, tz + oz
            ok = (slot_live & (nx_ >= 0) & (nx_ < dx) & (ny_ >= 0) & (ny_ < dy)
                  & (nz_ >= 0) & (nz_ < dz))
            nid = torch.where(ok, (nx_ * dy + ny_) * dz + nz_, D)
            nslot = tgt.slot_of[nid.long()]  # −1 when empty
            ns = torch.clamp_min(nslot, 0).long()
            _block_min(qp, tgt.xyz[ns], tgt.valid[ns] & (nslot >= 0)[:, None], tgt.idx[ns], bd, bi)

    ok_pt = (qry.slot_of_pt >= 0) & (qry.rank_of < Q)
    srow = torch.clamp_min(qry.slot_of_pt, 0).long()
    srank = torch.clamp_max(qry.rank_of, Q - 1).long()
    idx = torch.where(ok_pt, best_idx[srow, srank], -1)
    d2 = torch.where(ok_pt, best_d2[srow, srank], torch.inf)
    return idx.to(torch.int32), d2


def tiled_nn_for_icp(
    tgt_xyz: torch.Tensor,
    tgt_mask: torch.Tensor,
    origin,
    tile_size: float,
    dims: Tuple[int, int, int],
    cap: int,
    max_tiles: int = 0,
    query_mask: Optional[torch.Tensor] = None,
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Returns nn_fn(p) → (idx (N,), sq (N,)) closing over prebuilt target
    tiles — the ICP 'tiled' backend.  ``max_tiles > 0`` selects the
    compact occupied-tiles engine, 0 the dense lattice; the query side is
    re-bucketed on every call.  Rows that ``query_mask`` (N,) marks dead
    take no bucket room and get idx −1; without it every query row
    counts as live."""
    if max_tiles > 0:
        tgt_tiles = build_compact_tiles(tgt_xyz, tgt_mask, origin, tile_size, dims, cap, max_tiles)
    else:
        tgt_tiles = build_tiles(tgt_xyz, tgt_mask, origin, tile_size, dims, cap)

    def nn_fn(p: torch.Tensor):
        live = query_mask
        if live is None:
            live = torch.ones((p.shape[0],), dtype=torch.bool, device=p.device)
        if max_tiles > 0:
            q_tiles = build_compact_tiles(
                p, live, origin, tile_size, dims, cap, max_tiles, query_only=True)
            return compact_nn_1nn(tgt_tiles, q_tiles)
        return tiled_nn_1nn(tgt_tiles, build_tiles(p, live, origin, tile_size, dims, cap), p)

    return nn_fn
