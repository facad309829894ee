"""Exact 1-NN argmin — the ICP correspondence search.

Counterpart of ``prepare_nn_ref_argmin`` / ``nn_argmin_prepared`` in
``mapping_private_tpu/ops/pallas_nn.py`` (the Pallas kernel
``_make_argmin_kernel``).  For a CUDA tensor ``nn_argmin_prepared``
launches the hand-written kernel ``csrc/nn_argmin.cu``; for a CPU tensor
it runs ``nn_argmin_plain``, the plain PyTorch version of the same
function, which the tests and the on-card check compare the kernel with.

Contract, shared by both:

- distances are direct differences, d² = (dx² + dy²) + dz², never the
  q² + r² − 2q·r matmul form, so near ties rank exactly;
- dead queries carry −PAD_COORD and dead refs +PAD_COORD (their d² is
  ~1.2e17, finite in f32, so callers gate them by distance);
- exact ties go to the lowest ref index.
"""
from __future__ import annotations

from typing import Tuple

import torch

from mapping_private_tpu_torch.utils.metrics import metrics

# Elements of one (rows, N) block in the plain version: 32 Mi floats.
_CHUNK_ELEMS = 1 << 25


def prepare_nn_ref_argmin(ref_xyz: torch.Tensor) -> torch.Tensor:
    """(N,3) refs -> (3,N) contiguous f32 x/y/z rows (once per target,
    outside the ICP loop).  Dead refs must already carry +PAD_COORD."""
    if ref_xyz.ndim != 2 or ref_xyz.shape[1] != 3:
        raise ValueError(f"ref_xyz shape {tuple(ref_xyz.shape)}: want (N, 3)")
    return ref_xyz.to(torch.float32).T.contiguous()


def nn_argmin_plain(
    query_xyz: torch.Tensor, prepared: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (Q,3),(3,N) -> (idx (Q,) int32, sq (Q,) f32),
    a block of query rows at a time."""
    n = prepared.shape[1]
    rows = max(1, _CHUNK_ELEMS // max(n, 1))
    rx, ry, rz = prepared[0][None, :], prepared[1][None, :], prepared[2][None, :]
    idx_parts, sq_parts = [], []
    for s in range(0, query_xyz.shape[0], rows):
        q = query_xyz[s : s + rows]
        dx = q[:, 0:1] - rx
        dy = q[:, 1:2] - ry
        dz = q[:, 2:3] - rz
        d2 = dx * dx + dy * dy + dz * dz
        i = torch.argmin(d2, dim=1)  # first minimum: lowest index on ties
        idx_parts.append(i.to(torch.int32))
        sq_parts.append(torch.gather(d2, 1, i[:, None])[:, 0])
    if not idx_parts:
        return query_xyz.new_empty((0,), dtype=torch.int32), query_xyz.new_empty((0,))
    return torch.cat(idx_parts), torch.cat(sq_parts)


def nn_argmin_prepared(
    query_xyz: torch.Tensor, prepared: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN: (Q,3) queries against prepare_nn_ref_argmin() refs ->
    (idx (Q,) int32 in [0, N), sq (Q,) f32).  Dead queries must carry
    −PAD_COORD.  CUDA tensors run the kernel; CPU tensors the plain
    version."""
    if query_xyz.ndim != 2 or query_xyz.shape[1] != 3:
        raise ValueError(f"query_xyz shape {tuple(query_xyz.shape)}: want (Q, 3)")
    if prepared.ndim != 2 or prepared.shape[0] != 3 or prepared.shape[1] == 0:
        raise ValueError(f"prepared shape {tuple(prepared.shape)}: want (3, N), N > 0")
    if query_xyz.device != prepared.device:
        raise ValueError(f"queries on {query_xyz.device}, refs on {prepared.device}")
    if query_xyz.dtype != torch.float32 or prepared.dtype != torch.float32:
        raise TypeError(f"want float32, got {query_xyz.dtype} / {prepared.dtype}")
    if query_xyz.device.type == "cpu":
        return nn_argmin_plain(query_xyz, prepared)
    if query_xyz.device.type != "cuda":
        raise ValueError(f"no nn_argmin kernel for device {query_xyz.device}")
    return _launch(query_xyz.contiguous(), prepared.contiguous())


def _launch(q: torch.Tensor, rt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    from mapping_private_tpu_torch.ops.nn_search import search_index

    if q.shape[0] == 0:
        return (torch.empty((0,), dtype=torch.int32, device=q.device),
                torch.empty((0,), dtype=torch.float32, device=q.device))
    out = search_index("nn_argmin", q, rt, rt.shape[1])
    metrics.count("nn_argmin.launches")
    return out
