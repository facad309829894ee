"""Launch geometry and workspace of the exact 1-NN search kernels.

``csrc/nn_search.cuh`` is the skeleton that ``csrc/nn_argmin.cu``,
``csrc/nn_matmul.cu`` and ``csrc/nn_gather.cu`` share: a thread owns
``QUERIES_PER_THREAD`` queries,
a block a tile of ``QUERY_TILE`` of them, and ``splits`` blocks share a
query tile, each searching one contiguous stretch of the refs; the block
that finishes last merges the stretches in ascending order.  This module
is the Python side of that: how many ways to split (a pure function of the
sizes and the card's SM count), the length of a stretch and the sizes of
the workspace that follow from it, and the launch itself.  The kernel is
told the stretch, the workspace rows and the number of counters and
refuses a grid that would exceed them; of the header's constants this
module mirrors the query tile (for the counters) and the ref tile (for the
choice of the split).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

BLOCK_THREADS = 128  # kBlock
QUERIES_PER_THREAD = 2  # kQueries
QUERY_TILE = BLOCK_THREADS * QUERIES_PER_THREAD  # queries per block
REF_TILE = 2048  # kTile: refs per shared-memory tile
STRETCH_ALIGN = 32  # a stretch starts on a 128-byte boundary of each row of refs
# Blocks of one launch that an SM is given at most, so that all of them are
# resident at once (shared memory allows 6 of a 4-row tile's blocks, those
# of nn_matmul and nn_gather's mxu modes, and 9 of a 3-row one's) and each
# SM's share of the work is its number of blocks.
BLOCKS_PER_SM = 6
# A split whose fill is within this share of the best one is as good: take
# the smallest such, for the shortest merge.
FILL_SLACK = 0.01

_INT_MAX = 2**31 - 1


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def fill(blocks: int, sm_count: int) -> float:
    """Share of the card that ``blocks`` equal blocks keep busy while the
    fullest SM works through its ceil(blocks / sm_count) of them."""
    return blocks / (sm_count * _ceil_div(blocks, sm_count))


@functools.lru_cache(maxsize=1024)
def split_count(nq: int, nr: int, sm_count: int) -> int:
    """How many ways to split ``nr`` refs among the blocks of each query
    tile.  The kernel's time follows the fullest SM's number of blocks and
    not how many warps are resident (measured: two queries a thread give a
    scheduler enough independent work from 3 warps on), so this takes the
    smallest split that fills the card's last round of blocks about as well
    as any: 1 where the query tiles alone do, never more than there are ref
    tiles (a stretch shorter than a tile is not worth a block), and no more
    than keeps all blocks resident at once."""
    if nq <= 0 or nr <= 0 or sm_count <= 0:
        raise ValueError(f"split_count({nq}, {nr}, {sm_count}): want positive sizes")
    q_tiles = _ceil_div(nq, QUERY_TILE)
    most = max(1, min(_ceil_div(nr, REF_TILE), BLOCKS_PER_SM * sm_count // q_tiles))
    fills = [fill(q_tiles * s, sm_count) for s in range(1, most + 1)]
    return 1 + next(k for k, f in enumerate(fills) if f >= max(fills) * (1.0 - FILL_SLACK))


def stretch_len(nr: int, splits: int) -> int:
    """Refs per stretch: an even share, rounded up to STRETCH_ALIGN."""
    return _ceil_div(_ceil_div(nr, splits), STRETCH_ALIGN) * STRETCH_ALIGN


def stretch_count(nr: int, splits: int) -> int:
    """Stretches the launch really makes (its ``gridDim.y``): at most
    ``splits``, fewer where rounding the stretch up leaves the last ones
    empty."""
    return _ceil_div(nr, stretch_len(nr, splits))


def workspace_sizes(nq: int, nr: int, splits: int) -> Tuple[int, int]:
    """(rows of ``nq`` partial results, ticket counters) that a launch
    needs: none of either when one block searches all the refs."""
    rows = stretch_count(nr, splits)
    return (0, 0) if rows == 1 else (rows, _ceil_div(nq, QUERY_TILE))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# (device index, stream) -> zeroed int32 ticket counters.  A kernel that
# runs to its end leaves them zeroed, so they are filled once, when they are
# made or must grow; launches on one stream run in order, so a stream owns
# its counters.  Two things would break that and are not supported: a launch
# that dies on the card (the process has lost its CUDA context then anyway),
# and capturing a stream's FIRST split launch into a CUDA graph, which would
# capture the fill with it; launch once before capturing.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}

# gridDim.y of the newest launch: the stretches it really made
last_stretches = 0


def _ticket_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    have = _counters.get(key)
    if have is None or have.numel() < n:
        have = _counters[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return have


def search(kernel: str, q: torch.Tensor, refs: torch.Tensor, nr: int,
           out: Sequence[Union[torch.Tensor, int]], splits: Optional[int] = None) -> None:
    """Launch ``kernel`` ("nn_argmin", "nn_matmul" or "nn_gather") for
    contiguous f32 CUDA tensors: (nq, 3) queries against ``nr`` refs in the
    kernel's own layout, nq > 0.  ``out`` holds the arguments of the
    kernel's output policy, which follow the ticket counters in its entry
    point (a tensor is passed as its data pointer): (idx (nq,) int32, sq
    (nq,) f32) for the first two.  ``splits`` is chosen by
    ``split_count`` unless given."""
    global last_stretches
    from mapping_private_tpu_torch._build import launch

    nq = q.shape[0]
    if q.numel() > _INT_MAX or refs.numel() > _INT_MAX:
        raise ValueError(f"{nq} queries x {nr} refs: sizes exceed int32 indexing")
    device = q.device
    if splits is None:
        splits = split_count(nq, nr, sm_count(device.index))
    rows, n_counters = workspace_sizes(nq, nr, splits)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # the partials may be freed on return: the allocator hands their memory
        # out again only to work queued on this stream after the kernel
        part_d = part_i = counters = None
        if rows:
            part_d = torch.empty((rows, nq), dtype=torch.float32, device=device)
            part_i = torch.empty((rows, nq), dtype=torch.int32, device=device)
            counters = _ticket_counters(device, stream, n_counters)
        try:
            launch(kernel, q.data_ptr(), nq, refs.data_ptr(), nr, stretch_len(nr, splits), rows,
                   part_d.data_ptr() if rows else None, part_i.data_ptr() if rows else None,
                   counters.numel() if rows else 0, counters.data_ptr() if rows else None,
                   *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in out), stream)
        except Exception:
            _counters.pop((device.index, stream), None)  # their state is unknown now
            raise
    last_stretches = max(rows, 1)


def search_index(kernel: str, q: torch.Tensor, refs: torch.Tensor, nr: int,
                 splits: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``search`` for a kernel whose output is the index: (idx (nq,)
    int32, sq (nq,) f32)."""
    idx = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    sq = torch.empty((q.shape[0],), dtype=torch.float32, device=q.device)
    search(kernel, q, refs, nr, (idx, sq), splits)
    return idx, sq
