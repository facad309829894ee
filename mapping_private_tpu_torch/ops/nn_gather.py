"""Fused 1-NN + gather — squared distance, matched ref xyz and aux row.

Counterpart of ``prepare_nn_ref`` / ``nn_gather_prepared`` /
``nn_gather_pallas`` in ``mapping_private_tpu/ops/pallas_nn.py`` (the
Pallas kernel ``_make_gather_kernel``).  For a CUDA tensor
``nn_gather_prepared`` launches the hand-written kernel
``csrc/nn_gather.cu``; for a CPU tensor it runs ``nn_gather_plain``, the
plain PyTorch version of the same function, which the tests and the
on-card check compare the kernel with.

Contract, shared by both:

- ``dist`` picks how d² is computed, every product and sum rounded to f32
  on its own: ``"vpu"`` from direct differences, (dx² + dy²) + dz²;
  ``"mxu"`` (the default, as in the JAX package) in the expansion form
  (q² + r²) − 2·cross of ``ops.nn_matmul``; ``"mxu_fast"`` the same with
  the cross term's inputs rounded to bf16 first — an approximate
  selection (opt-in), while the gathered rows stay exact;
- dead queries carry −PAD_COORD, dead refs +PAD_COORD;
- ties: refs are split into aligned windows of ``TIE_WINDOW``.  Inside a
  window all refs whose d² equals the window minimum are averaged (xyz
  and aux, each weighted 1/count); a later window replaces the carried
  result only on a strictly smaller minimum.  For true duplicates the
  average is the point itself;
- in ``"vpu"`` mode the refs end as if padded to a whole window with refs
  at (PAD_COORD, PAD_COORD, PAD_COORD) whose aux row is 0, as the JAX
  package's ``prepare_nn_ref`` pads them: such a ref ties with a dead one,
  so where the last window is partial and its minimum is a dead ref's
  (every ref dead and N < 512, say), the missing rows join the average.
  ``rt`` itself is not padded: a padding column of three rows would have
  r² = 3·PAD_COORD² and tie in the ``"mxu"`` modes too, where the JAX
  package's eight-row column has 8·PAD_COORD² and never does.  So the
  ``"mxu"`` modes add nothing.
"""
from __future__ import annotations

from typing import Tuple

import torch

from mapping_private_tpu_torch.core.cloud import PAD_COORD
from mapping_private_tpu_torch.ops.nn_matmul import expansion_sq_dists, sq_norm_rows
from mapping_private_tpu_torch.utils.metrics import metrics

# The reference's tie window: exact ties are averaged inside aligned
# blocks of this many refs and resolved by strict '<' across them.
TIE_WINDOW = 512
DIST_MODES = ("vpu", "mxu", "mxu_fast")

# Elements of one (rows, N) block in the plain version: 16 Mi floats.
_CHUNK_ELEMS = 1 << 24


def prepare_nn_ref(ref_xyz: torch.Tensor, ref_aux: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,3) refs and (N,3) aux rows -> two (3,N) contiguous f32 tensors
    (once per target, outside loops).  Dead refs must carry +PAD_COORD."""
    if ref_xyz.ndim != 2 or ref_xyz.shape[1] != 3:
        raise ValueError(f"ref_xyz shape {tuple(ref_xyz.shape)}: want (N, 3)")
    if ref_aux.shape != ref_xyz.shape:
        raise ValueError(f"ref_aux shape {tuple(ref_aux.shape)}: want {tuple(ref_xyz.shape)}")
    return ref_xyz.to(torch.float32).T.contiguous(), ref_aux.to(torch.float32).T.contiguous()


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)  # round to nearest even


def nn_gather_plain(
    query_xyz: torch.Tensor, rt: torch.Tensor, nt: torch.Tensor, dist: str = "mxu"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (Q,3),(3,N),(3,N) -> (sq (Q,), q_sel (Q,3),
    n_sel (Q,3)), a block of query rows at a time."""
    n = rt.shape[1]
    n_win = -(-n // TIE_WINDOW)
    pad = n_win * TIE_WINDOW - n
    # the refs padded to whole windows, as the JAX package pads them: xyz
    # PAD_COORD, aux 0; (6, n_win, W) value rows
    rt_p = torch.nn.functional.pad(rt, (0, pad), value=PAD_COORD)
    vals = torch.cat([rt_p, torch.nn.functional.pad(nt, (0, pad))]).view(6, n_win, TIE_WINDOW)
    if dist != "vpu":
        r2 = sq_norm_rows(rt.T)
        cr = _bf16_round(rt) if dist == "mxu_fast" else rt
    rows = max(1, _CHUNK_ELEMS // max(n, 1))
    sq_parts, sel_parts = [], []
    for s in range(0, query_xyz.shape[0], rows):
        q = query_xyz[s : s + rows]
        if dist == "vpu":  # the padding takes part
            dx = q[:, 0:1] - rt_p[0][None, :]
            dy = q[:, 1:2] - rt_p[1][None, :]
            dz = q[:, 2:3] - rt_p[2][None, :]
            d2 = dx * dx + dy * dy + dz * dz
        else:  # the padding never ties (weight 0)
            cq = _bf16_round(q) if dist == "mxu_fast" else q
            d2 = expansion_sq_dists(q, sq_norm_rows(q), cq, cr, r2)
            d2 = torch.nn.functional.pad(d2, (0, pad), value=torch.inf)
        d2 = d2.view(-1, n_win, TIE_WINDOW)
        wmin = d2.amin(dim=2)  # (rows, n_win)
        w = torch.argmin(wmin, dim=1)  # first minimum: strict '<' across windows
        r_ = torch.arange(d2.shape[0], device=d2.device)
        best = wmin[r_, w]
        hits = (d2[r_, w] <= best[:, None]).to(torch.float32)  # (rows, W)
        onehot = hits / hits.sum(dim=1, keepdim=True)
        sel = (onehot[None, :, :] * vals[:, w, :]).sum(dim=2)  # (6, rows)
        sq_parts.append(best)
        sel_parts.append(sel.T)
    if not sq_parts:
        e = query_xyz.new_empty((0, 3))
        return query_xyz.new_empty((0,)), e, e.clone()
    sel = torch.cat(sel_parts)
    return torch.cat(sq_parts), sel[:, :3].contiguous(), sel[:, 3:].contiguous()


def nn_gather_prepared(
    query_xyz: torch.Tensor, rt: torch.Tensor, nt: torch.Tensor, dist: str = "mxu"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """1-NN with fused value gather against a prepare_nn_ref() reference:
    (Q,3),(3,N),(3,N) -> (sq (Q,), matched ref xyz (Q,3), matched aux
    (Q,3)).  Dead queries must carry −PAD_COORD.  CUDA tensors run the
    kernel; CPU tensors the plain version."""
    if dist not in DIST_MODES:
        raise ValueError(f"dist {dist!r}: want one of {DIST_MODES}")
    if query_xyz.ndim != 2 or query_xyz.shape[1] != 3:
        raise ValueError(f"query_xyz shape {tuple(query_xyz.shape)}: want (Q, 3)")
    if rt.ndim != 2 or rt.shape[0] != 3 or rt.shape[1] == 0:
        raise ValueError(f"rt shape {tuple(rt.shape)}: want (3, N), N > 0")
    if nt.shape != rt.shape:
        raise ValueError(f"nt shape {tuple(nt.shape)}: want {tuple(rt.shape)}")
    if not (query_xyz.device == rt.device == nt.device):
        raise ValueError(f"queries on {query_xyz.device}, refs on {rt.device}, aux on {nt.device}")
    if not (query_xyz.dtype == rt.dtype == nt.dtype == torch.float32):
        raise TypeError(f"want float32, got {query_xyz.dtype} / {rt.dtype} / {nt.dtype}")
    if query_xyz.device.type == "cpu":
        return nn_gather_plain(query_xyz, rt, nt, dist)
    if query_xyz.device.type != "cuda":
        raise ValueError(f"no nn_gather kernel for device {query_xyz.device}")
    return _launch(query_xyz.contiguous(), rt.contiguous(), nt.contiguous(), dist)


def nn_gather(
    query_xyz: torch.Tensor, ref_xyz: torch.Tensor, ref_aux: torch.Tensor, dist: str = "mxu"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Convenience wrapper: prepare_nn_ref + nn_gather_prepared.  In
    loops, call prepare_nn_ref once outside instead."""
    rt, nt = prepare_nn_ref(ref_xyz, ref_aux)
    return nn_gather_prepared(query_xyz, rt, nt, dist=dist)


def _launch(q, rt, nt, dist, splits=None):
    """The kernel through ``nn_search.search``; ``splits`` as there."""
    from mapping_private_tpu_torch.ops.nn_search import search

    nq = q.shape[0]
    sq = torch.empty((nq,), dtype=torch.float32, device=q.device)
    q_sel = torch.empty((nq, 3), dtype=torch.float32, device=q.device)
    n_sel = torch.empty((nq, 3), dtype=torch.float32, device=q.device)
    if nq == 0:
        return sq, q_sel, n_sel
    # the output policy's arguments of csrc/nn_gather.cu's entry point
    search("nn_gather", q, rt, rt.shape[1], (DIST_MODES.index(dist), nt, sq, q_sel, n_sel), splits)
    metrics.count("nn_gather.launches")
    return sq, q_sel, n_sel
