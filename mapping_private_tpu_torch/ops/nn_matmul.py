"""Matmul-form 1-NN — nearest ref by d² = q² + r² − 2 q·r.

Counterpart of ``nn_pallas`` in ``mapping_private_tpu/ops/pallas_nn.py``
(the Pallas kernel ``_nn_kernel``).  For a CUDA tensor ``nn_matmul``
launches the hand-written kernel ``csrc/nn_matmul.cu``; for a CPU tensor
it runs ``nn_matmul_plain``, the plain PyTorch version of the same
function, which the tests and the on-card check compare the kernel with.

Contract, shared by both:

- every product and sum is rounded to f32 on its own, in this order:
  q² = (qx² + qy²) + qz², r² likewise, cross = (qx·rx + qy·ry) + qz·rz,
  d² = (q² + r²) − 2·cross.  The plain version therefore uses elementwise
  ops, not ``@``, whose summation order is the library's;
- the expansion cancels: d² carries an error of about 4·eps·(|q|² + |r|²)
  and may come out slightly negative (it is not clamped, as in the JAX
  kernel).  For exact ranking of near ties use ``ops.nn_argmin``;
- dead refs carry +PAD_COORD (d² ≈ 3e16, finite) and never beat a live
  ref; exact ties in d² go to the lowest ref index.
"""
from __future__ import annotations

from typing import Tuple

import torch

from mapping_private_tpu_torch.utils.metrics import metrics

# Elements of one (rows, N) block in the plain version: 32 Mi floats.
_CHUNK_ELEMS = 1 << 25


def sq_norm_rows(xyz: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...): (x² + y²) + z², each step rounded to f32."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return (x * x + y * y) + z * z


def expansion_sq_dists(q: torch.Tensor, q2: torch.Tensor, cq: torch.Tensor,
                       cr: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """(rows, N) d² = (q² + r²) − 2·cross in the kernels' operation order.
    ``cq`` (rows,3) and ``cr`` (3,N) are the coordinates that enter the
    cross term (the exact ones, or bf16-rounded ones for a fast mode)."""
    cross = (cq[:, 0:1] * cr[0][None, :] + cq[:, 1:2] * cr[1][None, :]) + cq[:, 2:3] * cr[2][None, :]
    return (q2[:, None] + r2[None, :]) - 2.0 * cross


def nn_matmul_plain(
    query_xyz: torch.Tensor, ref_xyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (Q,3),(N,3) -> (idx (Q,) int32, sq (Q,) f32),
    a block of query rows at a time."""
    n = ref_xyz.shape[0]
    rows = max(1, _CHUNK_ELEMS // max(n, 1))
    rt = ref_xyz.T.contiguous()
    r2 = sq_norm_rows(ref_xyz)
    idx_parts, sq_parts = [], []
    for s in range(0, query_xyz.shape[0], rows):
        q = query_xyz[s : s + rows]
        d2 = expansion_sq_dists(q, sq_norm_rows(q), q, rt, r2)
        i = torch.argmin(d2, dim=1)  # first minimum: lowest index on ties
        idx_parts.append(i.to(torch.int32))
        sq_parts.append(torch.gather(d2, 1, i[:, None])[:, 0])
    if not idx_parts:
        return query_xyz.new_empty((0,), dtype=torch.int32), query_xyz.new_empty((0,))
    return torch.cat(idx_parts), torch.cat(sq_parts)


def nn_matmul(
    query_xyz: torch.Tensor, ref_xyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN in the expansion form: (Q,3) queries against (N,3) refs ->
    (idx (Q,) int32 in [0, N), sq (Q,) f32).  Dead refs must carry
    +PAD_COORD.  CUDA tensors run the kernel; CPU tensors the plain
    version."""
    if query_xyz.ndim != 2 or query_xyz.shape[1] != 3:
        raise ValueError(f"query_xyz shape {tuple(query_xyz.shape)}: want (Q, 3)")
    if ref_xyz.ndim != 2 or ref_xyz.shape[1] != 3 or ref_xyz.shape[0] == 0:
        raise ValueError(f"ref_xyz shape {tuple(ref_xyz.shape)}: want (N, 3), N > 0")
    if query_xyz.device != ref_xyz.device:
        raise ValueError(f"queries on {query_xyz.device}, refs on {ref_xyz.device}")
    if query_xyz.dtype != torch.float32 or ref_xyz.dtype != torch.float32:
        raise TypeError(f"want float32, got {query_xyz.dtype} / {ref_xyz.dtype}")
    if query_xyz.device.type == "cpu":
        return nn_matmul_plain(query_xyz, ref_xyz)
    if query_xyz.device.type != "cuda":
        raise ValueError(f"no nn_matmul kernel for device {query_xyz.device}")
    return _launch(query_xyz.contiguous(), ref_xyz.contiguous())


def _launch(q: torch.Tensor, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    from mapping_private_tpu_torch.ops.nn_search import search_index

    if q.shape[0] == 0:
        return (torch.empty((0,), dtype=torch.int32, device=q.device),
                torch.empty((0,), dtype=torch.float32, device=q.device))
    out = search_index("nn_matmul", q, r, r.shape[0])
    metrics.count("nn_matmul.launches")
    return out
