"""One front door for exact 1-NN — size-driven engine dispatch.

Counterpart of ``mapping_private_tpu/ops/nn_dispatch.py``: a single
``nn_1nn`` call that selects the engine from the problem size:

- **brute** (``ops.nn_argmin``: the CUDA kernel for CUDA tensors, its
  plain version on the CPU): exact global argmin, no radius needed.
- **compact** (``ops.tiled_nn.CompactTiles``): occupied-tiles stencil
  engine, work N·27·cap instead of N·M.  Needs a search ``radius`` (the
  tile size); exact within it.
- **lattice** (the dense ``TileSet`` engine) is not ported.

This is a host-level dispatcher: it reads concrete bounds and occupancy
to size the lattice, in two host syncs (the live counts with the bounds,
then the occupancy).  Dead queries and beyond-radius queries return
idx −1 / sq inf.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.core.cloud import PAD_COORD
from mapping_private_tpu_torch.ops import tiled_nn
from mapping_private_tpu_torch.ops.nn_argmin import nn_argmin_prepared, prepare_nn_ref_argmin

# Brute force below this many query×target pairs, the compact engine
# above (its bucketing overhead has to amortize).  The value is the JAX
# package's and has not been re-derived on the H100: PERF.md records the
# brute and compact times at 200k × 200k from which to set it.
BRUTE_PAIR_LIMIT = 1 << 30


def _lattice_geometry(bounds_list, radius):
    lo = np.min([b[0] for b in bounds_list], axis=0) - 2 * radius
    hi = np.max([b[1] for b in bounds_list], axis=0) + 2 * radius
    dims = tuple(int(v) for v in np.ceil((hi - lo) / radius))
    return lo.astype(np.float32), dims


def choose_nn_engine(n_query: int, n_target: int, radius: Optional[float]) -> str:
    """The dispatch policy, separated out so tests can pin it."""
    if radius is None or n_query * n_target <= BRUTE_PAIR_LIMIT:
        return "brute"
    return "compact"


def nn_1nn(
    query_xyz: torch.Tensor,
    query_mask: torch.Tensor,
    target_xyz: torch.Tensor,
    target_mask: torch.Tensor,
    radius: Optional[float] = None,
    engine: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of every live query against the live target points, on
    the device the tensors are on.

    Returns (idx (N,) int32 target rows or −1, sq_dists (N,)).  With a
    ``radius``, matches farther than it return −1 (and the compact engine
    uses it as its tile size — required for engine 'compact' and for
    auto-dispatch past ``BRUTE_PAIR_LIMIT``).
    """
    if engine == "auto":
        # dispatch on CAPACITIES (free): brute-force cost is the padded
        # N×M whatever the masks say
        engine = choose_nn_engine(query_xyz.shape[0], target_xyz.shape[0], radius)
    if engine == "lattice":
        raise NotImplementedError(
            "engine='lattice' is the dense TileSet engine: ROADMAP §1 item 6")
    if engine not in ("brute", "compact"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "compact" and radius is None:
        raise ValueError("engine='compact' needs a search radius")

    # one sync: the two live counts and both clouds' bounds, 14 scalars
    bt = tiled_nn.masked_bounds(target_xyz, target_mask)
    bq = tiled_nn.masked_bounds(query_xyz, query_mask)
    counts = torch.stack([target_mask.sum(), query_mask.sum()]).to(torch.float32)
    stats = torch.cat([counts, *bt, *bq]).cpu().numpy()
    n = query_xyz.shape[0]
    if stats[0] == 0 or stats[1] == 0:
        return (torch.full((n,), -1, dtype=torch.int32, device=query_xyz.device),
                torch.full((n,), torch.inf, dtype=torch.float32, device=query_xyz.device))

    if engine == "brute":
        idx, sq = _brute_1nn(query_xyz, query_mask, target_xyz, target_mask)
    else:
        b = stats[2:].reshape(2, 2, 3)
        lo, dims = _lattice_geometry([b[0], b[1]], radius)
        tiled_nn.check_lattice_dims(dims, radius)
        idx, sq = _tiled_1nn(query_xyz, query_mask, target_xyz, target_mask, lo, radius, dims)

    if radius is not None:
        out = query_mask & (sq <= float(np.float32(radius) ** 2))
    else:
        out = query_mask & (idx >= 0)
    return torch.where(out, idx, -1).to(torch.int32), torch.where(out, sq, torch.inf)


def _brute_1nn(query_xyz, query_mask, target_xyz, target_mask):
    tgt = torch.where(target_mask[:, None], target_xyz, PAD_COORD)
    qry = torch.where(query_mask[:, None], query_xyz, -PAD_COORD)
    return nn_argmin_prepared(qry, prepare_nn_ref_argmin(tgt))


def _tiled_1nn(query_xyz, query_mask, target_xyz, target_mask, lo, radius, dims):
    # both occupancies in one sync
    ot = tiled_nn.lattice_occupancy(target_xyz, target_mask, lo, radius, dims)
    oq = tiled_nn.lattice_occupancy(query_xyz, query_mask, lo, radius, dims)
    occ_t, cap_t, occ_q, cap_q = (int(v) for v in torch.stack([*ot, *oq]).cpu())
    # max_tiles MUST cover all target-occupied tiles (target spill is
    # unsafe — see build_compact_tiles), so size it from the larger side's
    # exact occupancy plus margin; caps cover the densest cell of each side
    cap_t = max(128, -(-cap_t // 128) * 128)
    cap_q = max(128, -(-cap_q // 128) * 128)
    mt = 1 << int(np.ceil(np.log2(max(int(1.2 * max(occ_t, occ_q)), 64))))
    tgt = tiled_nn.build_compact_tiles(target_xyz, target_mask, lo, radius, dims, cap_t, mt)
    qry = tiled_nn.build_compact_tiles(
        query_xyz, query_mask, lo, radius, dims, cap_q, mt, query_only=True)
    return tiled_nn.compact_nn_1nn(tgt, qry)
