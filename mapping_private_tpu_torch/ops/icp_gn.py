"""ICP's Gauss-Newton step: all of a point-to-plane sweep but the
correspondence search.

No Pallas kernel stands behind it: the JAX package leaves the sweep's GN
work (``_gn_from_corr`` in ``mapping_private_tpu/registration/icp.py``)
to XLA.  ``gauss_newton`` builds the step for one ``icp_point_to_plane``
call from its tensors' device: for CUDA tensors ``CardGN``, whose sweeps
are the hand-written kernel ``csrc/icp_gn.cu`` (three launches: apply,
partial sums, solve); for CPU tensors ``PlainGN``, the plain PyTorch
version (``se3_apply`` and ``gn_from_corr``), which the tests and the
on-card check compare the kernel with.  Both are context managers (the
card one holds its device for all sweeps) with one interface: ``apply()``
gives a sweep's NN queries, ``step(idx, sq, sweep)`` moves the pose from
that sweep's correspondences, ``result()`` gives (T, per-sweep RMSE,
per-sweep count).

Contract, shared by both:

- float32 inputs;
- p = T·src in ``se3_apply``'s order; the NN queries are p, or p with
  dead rows at −PAD_COORD where ``queries`` is set;
- a correspondence is accepted (ok) where the source row is live,
  idx ≥ 0 and sq ≤ max_corr_dist²; r = n·(p − q) at q, n = the target's
  point and normal at max(idx, 0); the Huber weight w is 1 for
  |r| ≤ huber_delta, huber_delta / max(|r|, 1e-12) above, 0 where not ok;
  J = [n, p × n];
- ξ = −(JᵀWJ + damping·I)⁻¹ JᵀWr by ``core/linalg.py``'s unrolled
  Cholesky, T ← se3_exp(ξ)·T in ``core/se3.py``'s order;
- each sweep's RMSE, sqrt(Σ w r² / max(Σ w, 1e-12)), and its count of
  accepted correspondences, (iters,) of each.

The kernel sums JᵀWJ and JᵀWr in float64 where the plain version takes
f32 matrix products, so the two agree to f32 rounding of those sums.
"""
from __future__ import annotations

from typing import Tuple

import torch

from mapping_private_tpu_torch.core.cloud import PAD_COORD
from mapping_private_tpu_torch.core.linalg import cholesky_solve_unrolled
from mapping_private_tpu_torch.core.se3 import se3_apply, se3_exp
from mapping_private_tpu_torch.utils.metrics import metrics

APPLY, PARTIALS, SOLVE = 0, 1, 2  # the kernel's stages
BLOCK = 128  # kBlock: threads of a partial-sums block
MAX_BLOCKS = 1024  # kMaxBlocks
ROW = 32  # kRow: float64 slots of a block's row of partial sums


def gn_from_corr(
    p: torch.Tensor,
    idx: torch.Tensor,
    sq: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_xyz: torch.Tensor,
    tgt_normals: torch.Tensor,
    T: torch.Tensor,
    max_corr_dist: float,
    huber_delta: float,
    damping: float,
):
    """The GN update given correspondences (idx, sq) for transformed
    points p -> (T_new, rmse, count); the plain version of one sweep's
    partial sums and solve."""
    ok = src_mask & (idx >= 0) & (sq <= max_corr_dist * max_corr_dist)
    i = torch.clamp_min(idx, 0).long()
    q = tgt_xyz[i]
    n = tgt_normals[i]
    r = torch.sum(n * (p - q), dim=-1)  # (N,) point-to-plane residual
    absr = torch.abs(r)
    w = torch.where(absr <= huber_delta, 1.0, huber_delta / torch.clamp_min(absr, 1e-12))
    w = torch.where(ok, w, 0.0)
    # J_i = [n ; p × n] for update T ← exp(ξ)·T
    J = torch.cat([n, torch.linalg.cross(p, n)], dim=-1)  # (N,6)
    Jw = J * w[:, None]
    H = J.T @ Jw  # (6,6), full f32 (TF32 is off)
    g = Jw.T @ r  # (6,)
    xi = -cholesky_solve_unrolled(H, g, jitter=damping)
    T_new = se3_exp(xi) @ T
    cnt = torch.sum(ok, dtype=torch.int32)
    rmse = torch.sqrt(torch.sum(w * r * r) / torch.clamp_min(torch.sum(w), 1e-12))
    return T_new, rmse, cnt


def gauss_newton(src_xyz, src_mask, tgt_xyz, tgt_normals, T, iters: int, max_corr_dist: float,
                 huber_delta: float, damping: float, queries: bool):
    """The GN step of one ICP call: ``CardGN`` for CUDA tensors,
    ``PlainGN`` otherwise.  The one place the choice is made."""
    gn = CardGN if src_xyz.device.type == "cuda" else PlainGN
    return gn(src_xyz, src_mask, tgt_xyz, tgt_normals, T, iters, max_corr_dist, huber_delta, damping, queries)


class PlainGN:
    """The GN work of every sweep as PyTorch ops on the call's tensors."""

    def __init__(self, src_xyz, src_mask, tgt_xyz, tgt_normals, T, iters: int,
                 max_corr_dist: float, huber_delta: float, damping: float, queries: bool):
        self.src, self.mask, self.tgt, self.nrm, self.T = src_xyz, src_mask, tgt_xyz, tgt_normals, T
        self.args = (max_corr_dist, huber_delta, damping)
        self.queries = queries
        self.p = None
        self.rmse, self.cnt = [None] * iters, [None] * iters

    def __enter__(self) -> "PlainGN":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def apply(self) -> torch.Tensor:
        self.p = se3_apply(self.T, self.src)
        return torch.where(self.mask[:, None], self.p, -PAD_COORD) if self.queries else self.p

    def step(self, idx: torch.Tensor, sq: torch.Tensor, sweep: int) -> None:
        self.T, self.rmse[sweep], self.cnt[sweep] = gn_from_corr(
            self.p, idx, sq, self.mask, self.tgt, self.nrm, self.T, *self.args)

    def result(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.T, torch.stack(self.rmse), torch.stack(self.cnt)


class CardGN:
    """The GN work of every sweep as csrc/icp_gn.cu's launches, on the
    buffers of one ``icp_point_to_plane`` call: the pose (a copy of the
    initial one, rewritten in place by each solve), the moved points, the
    NN queries with dead rows at −PAD_COORD where ``queries`` is set, the
    blocks' partial sums and the (iters,) RMSE and count of each sweep."""

    def __init__(self, src_xyz, src_mask, tgt_xyz, tgt_normals, T, iters: int,
                 max_corr_dist: float, huber_delta: float, damping: float, queries: bool):
        for name, t in (("src_xyz", src_xyz), ("tgt_xyz", tgt_xyz), ("tgt_normals", tgt_normals), ("T", T)):
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: want float32 on the card, got {t.dtype}")
        dev = src_xyz.device
        self.n = src_xyz.shape[0]
        self.src, self.mask = src_xyz.contiguous(), src_mask.to(torch.bool).contiguous()
        self.tgt, self.nrm = tgt_xyz.contiguous(), tgt_normals.contiguous()
        self.T = T.to(dev).clone(memory_format=torch.contiguous_format)
        # the plain version's scalars, each rounded to f32 as a tensor op rounds them
        self.params = torch.tensor([max_corr_dist * max_corr_dist, huber_delta, damping],
                                   dtype=torch.float32, device=dev)
        self.p = torch.empty_like(self.src)
        self.q = torch.empty_like(self.src) if queries else None
        self.blocks = max(1, min(-(-self.n // BLOCK), MAX_BLOCKS))
        self.work = torch.empty((self.blocks, ROW), dtype=torch.float64, device=dev)
        self.rmse = torch.empty((iters,), dtype=torch.float32, device=dev)
        self.cnt = torch.empty((iters,), dtype=torch.int32, device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def __enter__(self) -> "CardGN":
        """Makes the call's card current for all its sweeps at once."""
        self._device = torch.cuda.device(self.p.device)
        self._device.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._device.__exit__(*exc)

    def _launch(self, stage: int, idx=None, sq=None, sweep: int = 0) -> None:
        from mapping_private_tpu_torch._build import launch

        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        launch("icp_gn", stage, self.n, self.blocks, ptr(self.T), ptr(self.src), ptr(self.mask),
               ptr(self.p), ptr(self.q), ptr(idx), ptr(sq), ptr(self.tgt), ptr(self.nrm),
               ptr(self.params), ptr(self.work), ptr(self.rmse) + 4 * sweep, ptr(self.cnt) + 4 * sweep,
               self.stream)

    def apply(self) -> torch.Tensor:
        """p = T·src; returns the NN queries: p itself unless ``queries``."""
        self._launch(APPLY)
        return self.p if self.q is None else self.q

    def step(self, idx: torch.Tensor, sq: torch.Tensor, sweep: int) -> None:
        """T ← exp(ξ)·T from the correspondences of ``apply``'s points;
        this sweep's RMSE and count to slot ``sweep``."""
        idx = idx.to(torch.int32).contiguous()
        sq = sq.to(torch.float32).contiguous()
        if idx.shape != (self.n,) or sq.shape != (self.n,) or idx.device != self.p.device:
            raise ValueError(f"correspondences {tuple(idx.shape)}, {tuple(sq.shape)} on {idx.device}: "
                             f"want ({self.n},) on {self.p.device}")
        self._launch(PARTIALS, idx, sq)
        self._launch(SOLVE, sweep=sweep)
        metrics.count("icp_gn.launches")

    def result(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.T, self.rmse, self.cnt
