"""ColorCHLAC / C3-HLAC voxel colour-correlation features as tensor contractions.

Counterpart of ``mapping_private_tpu/features/colorchlac.py`` (the
reference's per-voxel loops, color_chlac.hpp:1566-1758, with the
rotation-invariant 117-dim layout bin for bin).

With occ(v) the occupancy, u(v) ∈ R⁶ the colour vector [r, 255−r, g,
255−g, b, 255−b] of the voxel's mean colour and w(v) its binarized
analogue, every bin is one of three contractions over the grid: Σ u,
Σ u ⊗ u (upper triangle), and Σ u(v) ⊗ u(v+δ) over the 13
half-neighbourhood offsets (summed for the 117, per δ for the 981).
The neighbour sums are 13 shifted adds into one tensor, each shift a
slice into zeros: at a scene's size every (X, Y, Z, 6) f32 tensor is
hundreds of MB, so no rolled copy is made.  Subdivision histograms
(the sliding-box detector's) reshape the grid into blocks and contract
each block; a neighbour product counts in the centre voxel's block, as
in the reference.

The contractions sum over the grid in another order than XLA's, so
values agree with the JAX package within a relative tolerance; the
permutation and layout tables and the integer thresholds are exact.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.core.voxelgrid import VoxelGrid

# The reference's 13 half-neighbourhood offsets, in its order
# (color_chlac.hpp ctor / c3_hlac.cpp:180-201): 9 with dz=-1, 3 with
# (dy=-1, dz=0), 1 with (-1, 0, 0).
NEIGHBOR_OFFSETS_13 = tuple(
    [(i, j, -1) for i in (-1, 0, 1) for j in (-1, 0, 1)]
    + [(i, -1, 0) for i in (-1, 0, 1)]
    + [(-1, 0, 0)]
)

# normalization constants (color_chlac/include/color_chlac/color_chlac.h:39-46)
_N0 = 1.0 / 255.0
_N1 = 1.0 / 65025.0
_N1_RI = 1.0 / 845325.0  # 65025 * 13
_N1_BIN_RI = 1.0 / 13.0

_UPPER_TRI = [(i, j) for i in range(6) for j in range(i, 6)]  # 21 pairs
_BIN_CENTER_PAIRS = [
    (0, 2), (0, 3), (0, 4), (0, 5),
    (1, 2), (1, 3), (1, 4), (1, 5),
    (2, 4), (2, 5), (3, 4), (3, 5),
]  # 12 pairs (color_chlac.hpp:1612-1645 bin order)
_UPPER_I, _UPPER_J = (list(t) for t in zip(*_UPPER_TRI))
_BIN_I, _BIN_J = (list(t) for t in zip(*_BIN_CENTER_PAIRS))


def color_channels(
    grid: VoxelGrid, thresholds: Tuple[int, int, int] = (127, 127, 127)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(X,Y,Z,6) real and binary channel tensors and the occupancy."""
    occ = grid.occupancy().to(torch.float32)
    r, g, b = grid.mean("r"), grid.mean("g"), grid.mean("b")
    u = torch.stack([r, 255.0 - r, g, 255.0 - g, b, 255.0 - b], dim=-1)
    u = u * occ[..., None]
    tr, tg, tb = thresholds
    br = (r > tr).to(torch.float32)
    bg = (g > tg).to(torch.float32)
    bb = (b > tb).to(torch.float32)
    w = torch.stack([br, 1.0 - br, bg, 1.0 - bg, bb, 1.0 - bb], dim=-1)
    w = w * occ[..., None]
    return u, w, occ


def _shift_slices(shape, d):
    """(destination, source) index tuples with out[dst] = x[src] for
    x(v + d) aligned at v; None when the shift leaves nothing."""
    dst, src = [slice(None)] * len(shape), [slice(None)] * len(shape)
    for axis, s in enumerate(d):
        n = shape[axis]
        if abs(s) >= n:
            return None
        if s > 0:
            dst[axis], src[axis] = slice(0, n - s), slice(s, n)
        elif s < 0:
            dst[axis], src[axis] = slice(-s, n), slice(0, n + s)
    return tuple(dst), tuple(src)


def _shift(x: torch.Tensor, d: Tuple[int, int, int]) -> torch.Tensor:
    """x(v + d) aligned at v, zero beyond the border.  x: (X,Y,Z,...)."""
    out = torch.zeros_like(x)
    sl = _shift_slices(x.shape, d)
    if sl is not None:
        out[sl[0]] = x[sl[1]]
    return out


def neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    """S(v) = Σ_{δ∈13} x(v+δ), added in the offsets' order into one tensor."""
    out = torch.zeros_like(x)
    for d in NEIGHBOR_OFFSETS_13:
        sl = _shift_slices(x.shape, d)
        if sl is not None:
            out[sl[0]] += x[sl[1]]
    return out


def _pair_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_v a(v) ⊗ b(v) over the grid: (X,Y,Z,C)² → (C,C)."""
    return a.reshape(-1, a.shape[-1]).T @ b.reshape(-1, b.shape[-1])


def colorchlac117(
    grid: VoxelGrid, thresholds: Tuple[int, int, int] = (127, 127, 127)
) -> torch.Tensor:
    """Rotation-invariant 117-dim ColorCHLAC, bin-exact layout
    (color_chlac.hpp addColorCHLAC_{0,1}{,_bin} RI variants)."""
    u, w, _ = color_channels(grid, thresholds)
    su = neighbor_sum(u)
    sw = neighbor_sum(w)
    f0 = torch.sum(u, dim=(0, 1, 2)) * _N0  # [0..5]
    f1 = _pair_matrix(u, su).reshape(-1) * _N1_RI  # [6..41]
    m_u = _pair_matrix(u, u)
    f2 = m_u[_UPPER_I, _UPPER_J] * _N1  # [42..62]
    f3 = torch.sum(w, dim=(0, 1, 2))  # [63..68], ×1
    f4 = _pair_matrix(w, sw).reshape(-1) * _N1_BIN_RI  # [69..104]
    m_w = _pair_matrix(w, w)
    f5 = m_w[_BIN_I, _BIN_J]  # [105..116]
    return torch.cat([f0, f1, f2, f3, f4, f5])


def colorchlac981(
    grid: VoxelGrid, thresholds: Tuple[int, int, int] = (127, 127, 127)
) -> torch.Tensor:
    """Rotation-variant 981-dim ColorCHLAC, neighbour-major layout:

      [0..5]      Σ u                        × 1/255
      [6..473]    for δ_k, k=0..12: flatten(Σ u(v) ⊗ u(v+δ_k)) × 1/65025
      [474..494]  centre upper-tri           × 1/65025
      [495..500]  Σ w
      [501..968]  per-δ bin pairs            × 1
      [969..980]  bin centre pairs           × 1

    ``to_reference_layout_981`` gives the reference's interleaved bin
    order, ``rotate_feature_981`` the 90°-rotation group."""
    u, w, _ = color_channels(grid, thresholds)
    parts = [torch.sum(u, dim=(0, 1, 2)) * _N0]
    for d in NEIGHBOR_OFFSETS_13:
        parts.append(_pair_matrix(u, _shift(u, d)).reshape(-1) * _N1)
    m_u = _pair_matrix(u, u)
    parts.append(m_u[_UPPER_I, _UPPER_J] * _N1)
    parts.append(torch.sum(w, dim=(0, 1, 2)))
    for d in NEIGHBOR_OFFSETS_13:
        parts.append(_pair_matrix(w, _shift(w, d)).reshape(-1))
    m_w = _pair_matrix(w, w)
    parts.append(m_w[_BIN_I, _BIN_J])
    return torch.cat(parts)


def _pad_to_blocks(x: torch.Tensor, bs: int) -> torch.Tensor:
    """Zero-pad the three grid axes up to multiples of the block size."""
    X, Y, Z = x.shape[:3]
    px, py, pz = (-X) % bs, (-Y) % bs, (-Z) % bs
    if px or py or pz:
        out = x.new_zeros((X + px, Y + py, Z + pz) + tuple(x.shape[3:]))
        out[:X, :Y, :Z] = x
        x = out
    return x


def _blocks(x: torch.Tensor, bs: int) -> torch.Tensor:
    """(X,Y,Z,C) → (Bx,By,Bz, bs³, C), each block's voxels in one axis."""
    x = _pad_to_blocks(x, bs)
    X, Y, Z, C = x.shape
    xr = x.reshape(X // bs, bs, Y // bs, bs, Z // bs, bs, C).permute(0, 2, 4, 1, 3, 5, 6)
    return xr.reshape(X // bs, Y // bs, Z // bs, bs ** 3, C)


def _block_pair(a: torch.Tensor, b: torch.Tensor, bs: int) -> torch.Tensor:
    """Per-block Σ_v a(v) ⊗ b(v): (X,Y,Z,C)² → (Bx,By,Bz,C,C), one batched
    product over the blocks (the reference's hist_idx binning,
    color_chlac.hpp:1464-1504)."""
    ab, bb = _blocks(a, bs), _blocks(b, bs)
    return ab.transpose(-1, -2) @ bb


def _block_sum(x: torch.Tensor, bs: int) -> torch.Tensor:
    """Per-block Σ_v x(v): (X,Y,Z,...) → (Bx,By,Bz,...)."""
    x = _pad_to_blocks(x, bs)
    X, Y, Z = x.shape[:3]
    rest = tuple(x.shape[3:])
    return x.reshape((X // bs, bs, Y // bs, bs, Z // bs, bs) + rest).sum(dim=(1, 3, 5))


def occupied_count_subdiv(grid: VoxelGrid, block_size: int) -> torch.Tensor:
    """(Bx,By,Bz) occupied-voxel count per subdivision (the sliding-box
    detector's exist_voxel_num, search.cpp:450)."""
    return _block_sum(grid.occupancy().to(torch.float32), block_size)


def colorchlac117_subdiv(
    grid: VoxelGrid,
    block_size: int,
    thresholds: Tuple[int, int, int] = (127, 127, 127),
) -> torch.Tensor:
    """(Bx,By,Bz,117) per-subdivision rotation-invariant ColorCHLAC.

    Neighbour products count in the centre voxel's block, as the
    reference does, including those whose neighbour lies in the next
    block."""
    u, w, _ = color_channels(grid, thresholds)
    bs = block_size
    f0 = _block_sum(u, bs) * _N0
    base = f0.shape[:3]
    f1 = _block_pair(u, neighbor_sum(u), bs).reshape(base + (36,)) * _N1_RI
    m_u = _block_pair(u, u, bs)
    f2 = m_u[..., _UPPER_I, _UPPER_J] * _N1
    f3 = _block_sum(w, bs)
    f4 = _block_pair(w, neighbor_sum(w), bs).reshape(base + (36,)) * _N1_BIN_RI
    m_w = _block_pair(w, w, bs)
    f5 = m_w[..., _BIN_I, _BIN_J]
    return torch.cat([f0, f1, f2, f3, f4, f5], dim=-1)


def colorchlac981_subdiv(
    grid: VoxelGrid,
    block_size: int,
    thresholds: Tuple[int, int, int] = (127, 127, 127),
) -> torch.Tensor:
    """(Bx,By,Bz,981) per-subdivision rotation-variant ColorCHLAC
    (the layout of colorchlac981)."""
    u, w, _ = color_channels(grid, thresholds)
    bs = block_size
    f0 = _block_sum(u, bs) * _N0
    base = f0.shape[:3]
    parts = [f0]
    for d in NEIGHBOR_OFFSETS_13:
        parts.append(_block_pair(u, _shift(u, d), bs).reshape(base + (36,)) * _N1)
    m_u = _block_pair(u, u, bs)
    parts.append(m_u[..., _UPPER_I, _UPPER_J] * _N1)
    parts.append(_block_sum(w, bs))
    for d in NEIGHBOR_OFFSETS_13:
        parts.append(_block_pair(w, _shift(w, d), bs).reshape(base + (36,)))
    m_w = _block_pair(w, w, bs)
    parts.append(m_w[..., _BIN_I, _BIN_J])
    return torch.cat(parts, dim=-1)


def _rotation_matrix(mode: str) -> np.ndarray:
    """90° rotation matrices about z, y and x (generators of the
    24-element cube rotation group)."""
    if mode == "z":
        return np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]])
    if mode == "y":
        return np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]])
    if mode == "x":
        return np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]])
    raise ValueError(mode)


@functools.lru_cache(maxsize=None)
def _rotation_permutation_981(mode: str) -> np.ndarray:
    """Permutation perm with feature_rotated[i] = feature[perm[i]].

    Under rotation R, Σ u(v)⊗u(v+δ) moves to the offset R·δ; when R·δ is
    in the negative half-neighbourhood, −R·δ with the colour pair
    transposed.  Derived, in place of the reference's hand-unrolled
    tables (c3_hlac.cpp:49-160)."""
    R = _rotation_matrix(mode)
    offs = [np.array(d) for d in NEIGHBOR_OFFSETS_13]
    off_index = {tuple(d): k for k, d in enumerate(NEIGHBOR_OFFSETS_13)}
    perm = np.arange(981)

    def block_perm(base):
        for k, d in enumerate(offs):
            rd = R.T @ d  # the source-frame offset of target δ
            swap = False
            if tuple(rd) not in off_index:
                rd = -rd
                swap = True
            ks = off_index[tuple(rd)]
            for c1 in range(6):
                for c2 in range(6):
                    dst = base + k * 36 + c1 * 6 + c2
                    src = base + ks * 36 + ((c2 * 6 + c1) if swap else (c1 * 6 + c2))
                    perm[dst] = src

    block_perm(6)
    block_perm(501)
    return perm


def rotate_feature_981(feature: torch.Tensor, mode: str) -> torch.Tensor:
    """Feature vector of the voxel grid rotated by 90° about an axis."""
    perm = torch.as_tensor(_rotation_permutation_981(mode), device=feature.device)
    return feature[..., perm]


@functools.lru_cache(maxsize=None)
def _perm_own_to_reference_981() -> np.ndarray:
    """Permutation P with ref_layout[i] = own_layout[P[i]]: the
    reference's interleaved 981 bin order (color_chlac.hpp:296-801,
    c3_hlac.cpp:86-160 strides ``6 + c2*9 + c1*78`` / ``60 + c2*4 +
    c1*78``) against the own offset-major one (6 + 36·k + 6·c1 + c2)."""
    perm = np.arange(981)

    def ref_bin(base: int, c1: int, c2: int, k: int) -> int:
        row = base + 78 * c1
        if k < 9:
            return row + 9 * c2 + k
        return row + 54 + 4 * c2 + (k - 9)

    for c1 in range(6):
        for c2 in range(6):
            for k in range(13):
                perm[ref_bin(6, c1, c2, k)] = 6 + 36 * k + 6 * c1 + c2
                perm[ref_bin(501, c1, c2, k)] = 501 + 36 * k + 6 * c1 + c2
    return perm


def to_reference_layout_981(feature: torch.Tensor) -> torch.Tensor:
    """Own-layout 981 feature → the reference's interleaved bin order."""
    return feature[..., torch.as_tensor(_perm_own_to_reference_981(), device=feature.device)]


def from_reference_layout_981(feature: torch.Tensor) -> torch.Tensor:
    """Inverse of to_reference_layout_981."""
    inv = np.argsort(_perm_own_to_reference_981())
    return feature[..., torch.as_tensor(inv, device=feature.device)]


# ---------------------------------------------------------------------------
# RGB binarization-threshold learning
# (color_voxel_recognition/test/calc_scene_auto_threshold.cpp:60-160)
# ---------------------------------------------------------------------------

def rgb_voxel_histograms(grid: VoxelGrid) -> torch.Tensor:
    """(3, 256) int32 histograms of the occupied voxels' mean RGB, each
    mean truncated to its integer bin (PCL's uint8 repack).  Sum the
    results over scene sweeps."""
    occ = grid.occupancy().reshape(-1)
    hists = []
    for name in ("r", "g", "b"):
        q = torch.clamp(grid.mean(name).reshape(-1).to(torch.int32), 0, 255)
        q = torch.where(occ, q, 256)  # dead voxels: an overflow bin, sliced off
        hists.append(torch.bincount(q, minlength=257)[:256])
    return torch.stack(hists).to(torch.int32)


def calc_auto_threshold(hist) -> Tuple[int, int, int]:
    """Per-channel RGB binarization thresholds maximizing the reference's
    between-class-variance criterion (calc_scene_auto_threshold.cpp:115-152):
    the first j ∈ [1,255] attaining the strictly largest
    (eachAve[j] − totalAve)² · eachNum[j] / (N − eachNum[j]), 0 when no
    split improves on 0.  256 bins, host numpy."""
    h = np.asarray(hist.cpu() if isinstance(hist, torch.Tensor) else hist, np.float64)
    j = np.arange(256, dtype=np.float64)
    out = []
    for c in range(3):
        n = h[c].sum()
        if n == 0:
            out.append(0)
            continue
        total_ave = float((j * h[c]).sum() / n)
        each_num = np.cumsum(h[c])
        each_ave = np.where(
            each_num > 0, np.cumsum(j * h[c]) / np.maximum(each_num, 1), 0.0)
        valid = (each_num > 0) & (each_num < n)
        valid[0] = False  # the reference scans j = 1..255
        var = np.where(
            valid,
            (each_ave - total_ave) ** 2
            * (each_num / np.maximum(n - each_num, 1)),
            -1.0,
        )
        out.append(int(np.argmax(var)) if var.max() > 0 else 0)
    return tuple(out)


def calc_scene_auto_threshold(grids) -> Tuple[int, int, int]:
    """Learn (r, g, b) binarization thresholds from scene voxel grids
    (calc_scene_auto_threshold.cpp:53-169); feed the result as
    ``thresholds=`` to the colorchlac extractors."""
    total = None
    for g in grids:
        hst = rgb_voxel_histograms(g)
        total = hst if total is None else total + hst
    if total is None:
        raise ValueError("calc_scene_auto_threshold needs >= 1 voxel grid")
    return calc_auto_threshold(total.cpu().numpy())
