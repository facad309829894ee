"""The k smallest squared distances from each point of a set to the others:
the search of the statistical outlier filter.

No Pallas kernel stands behind it: the JAX package ranks a dense distance
matrix with ``top_k`` (``knn_bruteforce``).  For a CUDA tensor
``knn_kbest`` launches the hand-written kernel ``csrc/knn_kbest.cu``; for a
CPU tensor it runs ``knn_kbest_plain``, the plain PyTorch version of the
same function, which the tests and the on-card check compare the kernel
with.

Contract, shared by both:

- the points are (3, n) f32 x/y/z rows (``prepare_nn_ref_argmin``'s
  layout; ``live_rows`` compacts a cloud's live rows into it); each point
  is a query against all the others;
- row i of the (n, k) result holds the k smallest d² over j ≠ i, by index
  (a duplicate of point i keeps its zero distance), ascending, with +inf
  in the slots past n − 1;
- d² = (dx² + dy²) + dz² from direct differences, never the matmul form.

Only distances come back, no indices: which of two tied neighbours is
kept does not change them, so the kernel and the plain version agree bit
for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from mapping_private_tpu_torch.ops.neighbors import direct_sq_dists
from mapping_private_tpu_torch.ops.nn_argmin import prepare_nn_ref_argmin
from mapping_private_tpu_torch.utils.metrics import metrics

K_STEP = 8  # kStep: the kernel's lists are k rounded up to a multiple of this
K_MAX = 64  # kMax: the largest k the kernel takes

# Elements of one (rows, n) block in the plain version: 32 Mi floats.
_CHUNK_ELEMS = 1 << 25


def live_rows(xyz: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 3) points and (N,) live mask -> (the live rows' indices (n,)
    int64 in order, their (3, n) x/y/z rows).  The number of live rows
    is read to the host once."""
    rows = torch.nonzero(mask).squeeze(1)
    return rows, prepare_nn_ref_argmin(xyz.index_select(0, rows))


def knn_kbest_plain(rt: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: (3, n) -> (n, k), a block of query rows at a
    time."""
    n = rt.shape[1]
    out = rt.new_full((n, k), torch.inf)
    kk = min(k, n)
    rows = max(1, _CHUNK_ELEMS // max(n, 1))
    for s in range(0, n, rows):
        d2 = direct_sq_dists(rt[:, s : s + rows].T, rt.T)
        r = torch.arange(d2.shape[0], device=d2.device)
        d2[r, r + s] = torch.inf
        out[s : s + rows, :kk] = torch.topk(d2, kk, dim=1, largest=False, sorted=True).values
    return out


def knn_kbest(rt: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest squared distances from each of the (3, n) points to
    the others: (n, k) f32, ascending, +inf past n − 1.  CUDA tensors run
    the kernel (1 ≤ k ≤ K_MAX); CPU tensors the plain version."""
    if rt.ndim != 2 or rt.shape[0] != 3:
        raise ValueError(f"rt shape {tuple(rt.shape)}: want (3, n)")
    if rt.dtype != torch.float32:
        raise TypeError(f"want float32, got {rt.dtype}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k = {k}: want 1 <= k <= {K_MAX}")
    if rt.device.type == "cpu":
        return knn_kbest_plain(rt, k)
    if rt.device.type != "cuda":
        raise ValueError(f"no knn_kbest kernel for device {rt.device}")
    return _launch(rt.contiguous(), k)


def _launch(rt: torch.Tensor, k: int) -> torch.Tensor:
    from mapping_private_tpu_torch._build import launch

    n = rt.shape[1]
    out = torch.empty((n, k), dtype=torch.float32, device=rt.device)
    if n == 0:
        return out
    if rt.numel() >= 2**31:
        raise ValueError(f"{n} points: sizes exceed int32 indexing")
    with torch.cuda.device(rt.device):
        stream = torch.cuda.current_stream(rt.device).cuda_stream
        launch("knn_kbest", rt.data_ptr(), n, k, out.data_ptr(), stream)
    metrics.count("knn_kbest.launches")
    return out
