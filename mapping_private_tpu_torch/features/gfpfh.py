"""GFPFH — a global feature over voxel-class line crossings.

Counterpart of ``mapping_private_tpu/features/gfpfh.py`` (the reference's
deprecated cloud_algos/deprecated/gfpfh.cpp:355-430): lines between
random pairs of occupied, classified voxels; the classes each line
crosses (EMPTY for unoccupied cells) are histogrammed per (start class,
end class) pair, a (C, C, C+1) tensor flattened to C²·(C+1) bins (150
for the 5 RSD surface classes), built with one scatter-add.

The pair ends are drawn by inverse CDF over the occupancy from uniforms:
a ``torch.Generator``, or the uniforms ``u = (ua, ub)`` themselves (two
(num_pairs,) tensors in [0, 1)).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mapping_private_tpu_torch.features.rsd import EMPTY

NUM_CLASSES = 5


def gfpfh_global(
    type_grid: torch.Tensor,
    occ: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_pairs: int = 2048,
    samples_per_line: int = 16,
    u: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """(C²·(C+1),) global descriptor from a (X,Y,Z) class grid + occupancy."""
    X, Y, Z = occ.shape
    n = X * Y * Z
    dev = occ.device
    cdf = torch.cumsum(occ.reshape(-1).to(torch.float32), dim=0)
    total = torch.clamp_min(cdf[-1], 1.0)
    if u is None:
        u = tuple(torch.rand(num_pairs, generator=generator, device=dev) for _ in range(2))
    ua, ub = (t.to(dev) * total for t in u)
    ia = torch.clamp(torch.searchsorted(cdf, ua, right=True), 0, n - 1)
    ib = torch.clamp(torch.searchsorted(cdf, ub, right=True), 0, n - 1)

    def coords(i):
        return torch.stack([i // (Y * Z), (i // Z) % Y, i % Z], -1).to(torch.float32)

    a, b = coords(ia), coords(ib)  # (P,3)
    t = torch.linspace(0.0, 1.0, samples_per_line, device=dev)[None, :, None]  # (1,S,1)
    ijk = torch.round(a[:, None, :] * (1 - t) + b[:, None, :] * t).to(torch.int64)
    ii = torch.clamp(ijk[..., 0], 0, X - 1)
    jj = torch.clamp(ijk[..., 1], 0, Y - 1)
    kk = torch.clamp(ijk[..., 2], 0, Z - 1)
    cls = torch.where(occ[ii, jj, kk], type_grid[ii, jj, kk], EMPTY).to(torch.int64)  # (P,S)

    C = NUM_CLASSES
    tflat, oflat = type_grid.reshape(-1).to(torch.int64), occ.reshape(-1)
    valid_pair = oflat[ia] & oflat[ib]
    # bin = ((start*C + end)*(C+1) + crossed class), one scatter-add
    bins = ((tflat[ia] * C + tflat[ib]) * (C + 1))[:, None] + cls
    w = valid_pair.to(torch.float32)[:, None].expand(cls.shape)
    hist = torch.zeros(C * C * (C + 1), dtype=torch.float32, device=dev)
    hist.index_add_(0, bins.reshape(-1), w.reshape(-1))
    return hist / torch.clamp_min(torch.sum(hist), 1.0)
