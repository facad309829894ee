"""RSD (Radius-based Surface Descriptor), GRSD and VOSCH.

Counterpart of ``mapping_private_tpu/features/rsd.py``:

- per-point RSD r_min/r_max (the reference's ``LocalRadiusEstimation``
  and ``pcl::RSDEstimation`` as extractGRSDSignature21 uses it,
  grsd_colorCHLAC_tools.hpp:165-186): one batched kNN and masked
  reductions in place of the per-point neighbour loops;
- the voxel surface type ``get_type`` (tools.hpp:104-126, thresholds as
  the reference's) and the golden corpus's ("era") variant;
- GRSD-20, -325 and PlusGRSD-110: a one-hot type grid, shifted copies and
  one contraction per offset;
- VOSCH = GRSD-20 ++ ColorCHLAC-117 (grsd_colorCHLAC_tools.h:124).

``rsd_radii_pcl`` takes the nearest neighbour as the base point; where
several surface points tie for it, it takes the lowest index, as
``lax.top_k`` orders them.  f32 centroids (summed in another order on
the card) move votes near the thresholds of ``get_type``: types agree
with the JAX package away from the thresholds.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from mapping_private_tpu_torch.core.voxelgrid import VoxelGrid
from mapping_private_tpu_torch.features.colorchlac import (
    NEIGHBOR_OFFSETS_13,
    _block_pair,
    _block_sum,
    _pair_matrix,
    _shift,
    colorchlac117,
    colorchlac117_subdiv,
)
from mapping_private_tpu_torch.ops.neighbors import knn_bruteforce

# surface types (grsd_colorCHLAC_tools.hpp:95-101)
NOISE, PLANE, CYLINDER, SPHERE, EDGE, EMPTY = 0, 1, 2, 3, 4, 5
NORMALIZE_GRSD = 20.0 / 26.0  # grsd_colorCHLAC_tools.h:32

# the 13 half-offsets plus their negatives = 26
NEIGHBOR_OFFSETS_26 = NEIGHBOR_OFFSETS_13 + tuple(
    (-a, -b, -c) for (a, b, c) in NEIGHBOR_OFFSETS_13
)


def _one_hot(types: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot over the last axis; values outside [0, n) give zeros
    (as ``jax.nn.one_hot`` does)."""
    return (types[..., None] == torch.arange(n, device=types.device)).to(torch.float32)


def rsd_radii(
    query_xyz: torch.Tensor,
    query_mask: torch.Tensor,
    surface_xyz: torch.Tensor,
    surface_mask: torch.Tensor,
    surface_normals: torch.Tensor,
    query_normals: torch.Tensor,
    radius: float,
    k: int = 32,
    plane_radius: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query (r_min, r_max) surface radius estimates: each neighbour
    within ``radius`` votes r = d/α (α the angle between the normals, d
    the distance), r_min/r_max the extreme votes clamped to
    ``plane_radius``."""
    idx, sq = knn_bruteforce(query_xyz, surface_xyz, surface_mask, k=k)
    d = torch.sqrt(torch.clamp_min(sq, 1e-20))
    valid = (idx >= 0) & (sq <= radius * radius) & (d > 1e-6) & query_mask[:, None]
    ni = surface_normals[torch.clamp_min(idx, 0).long()]  # (Q,k,3)
    cos_a = torch.clamp(torch.abs(torch.sum(query_normals[:, None, :] * ni, dim=-1)), 0.0, 1.0)
    alpha = torch.arccos(cos_a)  # [0, π/2]
    r_vote = torch.clamp(d / torch.clamp_min(alpha, 1e-3), 0.0, plane_radius)
    r_min = torch.min(torch.where(valid, r_vote, plane_radius), dim=1).values
    r_max = torch.max(torch.where(valid, r_vote, 0.0), dim=1).values
    r_min = torch.where(torch.any(valid, dim=1), r_min, 0.0)
    return r_min, r_max


def rsd_radii_pcl(
    query_xyz: torch.Tensor,
    query_mask: torch.Tensor,
    surface_xyz: torch.Tensor,
    surface_mask: torch.Tensor,
    surface_normals: torch.Tensor,
    radius: float,
    k: int = 192,
    nr_subdiv: int = 5,
    plane_radius: float = 0.2,
    max_dist_factor: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r_min, r_max) per query with PCL ``RSDEstimation`` / ``computeRSD``
    semantics (grsd_colorCHLAC_tools.hpp:165-186).

    Per query, b is the nearest surface point.  For every other
    neighbour i within ``radius`` the angle is between n_i and n_b
    (folded to ≤ π/2) and the distance ‖p_i − p_b‖ (skipped beyond
    ``radius``).  Distances fall into ``nr_subdiv`` bins; the per-bin min
    and max angles feed two least-squares fits d ≈ r·α giving r_max and
    r_min, clamped to ``plane_radius``.  Bin 0 is pre-seeded with angle 0.
    Queries with < 2 neighbours return (0, 0).  ``k`` caps the gather and
    must cover the densest neighbourhood."""
    idx, sq = knn_bruteforce(query_xyz, surface_xyz, surface_mask, k=k)
    valid = (idx >= 0) & (sq <= radius * radius)
    gi = torch.clamp_min(idx, 0).long()
    p = surface_xyz[gi]  # (Q,k,3)
    n = surface_normals[gi]
    # the base point: the lowest index among the refs tied for nearest, as
    # lax.top_k orders exact ties (torch.topk does not); a voxel centroid
    # of two points lies exactly between them
    tied = (sq == sq[:, :1]) & (idx >= 0)
    base = torch.argmin(torch.where(tied, gi, torch.iinfo(torch.int64).max), dim=1)
    rows = torch.arange(idx.shape[0], device=idx.device)
    p_b, n_b = p[rows, base], n[rows, base]
    cos = torch.clamp(torch.sum(n * n_b[:, None, :], dim=-1), -1.0, 1.0)
    angle = torch.arccos(cos)
    angle = torch.where(angle > math.pi / 2, math.pi - angle, angle)
    dist = torch.linalg.norm(p - p_b[:, None, :], dim=-1)
    max_dist = radius * max_dist_factor
    lane = torch.arange(k, device=idx.device)
    pair = valid & (lane[None, :] != base[:, None]) & (dist <= max_dist)
    bin_d = torch.clamp(torch.floor(nr_subdiv * dist / max_dist), 0, nr_subdiv - 1).to(torch.int64)

    big = 1e9
    sel = pair[:, None, :] & (bin_d[:, None, :] == torch.arange(nr_subdiv, device=idx.device)[None, :, None])
    a_bc = angle[:, None, :].expand(sel.shape)
    amin = torch.min(torch.where(sel, a_bc, big), dim=-1).values
    amax = torch.max(torch.where(sel, a_bc, -big), dim=-1).values
    present = torch.any(sel, dim=-1)
    # bin 0 is pre-seeded with (0, 0) and always present
    amin[:, 0] = 0.0
    amax[:, 0] = torch.clamp_min(amax[:, 0], 0.0)
    present[:, 0] = True

    f = (torch.arange(nr_subdiv, dtype=torch.float32, device=idx.device) + 0.5) * max_dist / nr_subdiv
    pm = torch.where(present, amin, 0.0)
    px = torch.where(present, amax, 0.0)
    amint_amin = torch.sum(pm * pm, dim=-1)
    amint_d = torch.sum(pm * f[None, :], dim=-1)
    amaxt_amax = torch.sum(px * px, dim=-1)
    amaxt_d = torch.sum(px * f[None, :], dim=-1)
    eps = 1e-12  # Eigen::NumTraits<double>::dummy_precision
    r_max = torch.where(amint_amin < eps, plane_radius,
                        torch.clamp_max(amint_d / torch.clamp_min(amint_amin, eps), plane_radius))
    r_min = torch.where(amaxt_amax < eps, plane_radius,
                        torch.clamp_max(amaxt_d / torch.clamp_min(amaxt_amax, eps), plane_radius))
    r_min, r_max = torch.minimum(r_min, r_max), torch.maximum(r_min, r_max)
    enough = (torch.sum(valid, dim=-1) >= 2) & query_mask
    return torch.where(enough, r_min, 0.0), torch.where(enough, r_max, 0.0)


def get_type(r_min: torch.Tensor, r_max: torch.Tensor) -> torch.Tensor:
    """Surface type per element, thresholds as the reference's
    (grsd_colorCHLAC_tools.hpp:104-126)."""
    t = torch.where(r_max - r_min < 0.050, SPHERE, EDGE)
    t = torch.where(r_min < 0.015, NOISE, t)
    t = torch.where(r_max > 0.175, CYLINDER, t)
    return torch.where(r_min > 0.100, PLANE, t).to(torch.int32)


_UPPER_TRI_6 = [(i, j) for i in range(6) for j in range(i, 6)]  # 21, last dropped

# ---------------------------------------------------------------------------
# Golden-corpus ("era") GRSD-20: the chain that generated
# color_chlac/demos/shape_data/*_GRSD_CCHLAC.pcd dims [:20] (see the JAX
# package's era block for the evidence): enum EMPTY=0, PLANE=1,
# CYLINDER=2, SPHERE=3, EDGE=4, NOISE=5; EDGE below r_min 0.037, CYLINDER
# above, PLANE above 0.1; transitions over the 13 half-offsets; the
# lower-triangle layout (i,j) for i=1..5, j=0..i; ×5/104; RSD with
# nr_subdiv=4 and normals radius 0.01.
# ---------------------------------------------------------------------------

EMPTY_ERA, PLANE_ERA, CYLINDER_ERA, SPHERE_ERA, EDGE_ERA, NOISE_ERA = range(6)
ERA_NORMALS_RADIUS = 0.01
ERA_NR_SUBDIV = 4
ERA_EDGE_RMIN = 0.037  # feasible window (0.0356, 0.0373] over the corpus
GRSD_GOLD_SCALE = 5.0 / 104.0

_LOWER_TRI_ERA = [(i, j) for i in range(1, 6) for j in range(0, i + 1)]  # 20


def _stack_entries(M: torch.Tensor, pairs) -> torch.Tensor:
    i, j = (list(t) for t in zip(*pairs))
    return M[..., i, j]


def get_type_era(r_min: torch.Tensor, r_max: torch.Tensor) -> torch.Tensor:
    """Era surface-type classifier (golden-corpus generation build)."""
    del r_max  # the era branches that consult r_max never fire
    t = torch.where(r_min < ERA_EDGE_RMIN, EDGE_ERA, CYLINDER_ERA)
    return torch.where(r_min > 0.1, PLANE_ERA, t).to(torch.int32)


def grsd20_era(type_grid: torch.Tensor, occ: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """GRSD-20 in the golden-file convention: 13 half-offset transitions,
    era enum (EMPTY=0), lower-triangle layout, ×5/104.  Unoccupied and
    out-of-grid neighbours count as class 0 = EMPTY."""
    occf = occ.to(torch.float32)
    onehot = _one_hot(type_grid, 6) * occf[..., None]
    M = torch.zeros((6, 6), dtype=torch.float32, device=occ.device)
    for d in NEIGHBOR_OFFSETS_13:
        s = _shift(onehot, d)
        nb_empty = 1.0 - torch.sum(s, dim=-1, keepdim=True)
        nb = torch.cat([nb_empty + s[..., :1], s[..., 1:]], dim=-1)
        M = M + _pair_matrix(onehot, nb)
    feat = _stack_entries(M, _LOWER_TRI_ERA)
    return feat * GRSD_GOLD_SCALE if normalize else feat


def grsd20_from_types(type_grid: torch.Tensor, occ: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """GRSD-20 from a (X,Y,Z) int32 type grid and occupancy: for each
    occupied voxel and each of the 26 offsets, count (source type,
    neighbour type or EMPTY); the upper triangle of the 6×6 counts, first
    20 entries.  Out-of-grid neighbours count as EMPTY."""
    occf = occ.to(torch.float32)
    onehot = _one_hot(type_grid, 6) * occf[..., None]
    M = torch.zeros((6, 6), dtype=torch.float32, device=occ.device)
    n_occupied_nbrs = torch.zeros_like(occf)
    for d in NEIGHBOR_OFFSETS_26:
        s = _shift(onehot, d)
        M = M + _pair_matrix(onehot, s)
        n_occupied_nbrs = n_occupied_nbrs + torch.sum(s[..., :5], dim=-1)
    # EMPTY neighbours: 26 minus the occupied ones
    empty_counts = torch.einsum("xyzc,xyz->c", onehot, (26.0 - n_occupied_nbrs) * occf)
    M[:, EMPTY] += empty_counts
    feat = _stack_entries(M, _UPPER_TRI_6[:20])
    return feat * NORMALIZE_GRSD if normalize else feat


def grsd20_subdiv(
    type_grid: torch.Tensor, occ: torch.Tensor, block_size: int, normalize: bool = False,
) -> torch.Tensor:
    """(Bx,By,Bz,20) per-subdivision GRSD (extractGRSDSignature21's
    subdivision mode, tools.hpp:131-295): each transition counts in the
    source voxel's block; unoccupied and out-of-grid neighbours are
    EMPTY."""
    occf = occ.to(torch.float32)
    onehot = _one_hot(type_grid, 6) * occf[..., None]
    bs = block_size
    M = None
    occ_nbrs = torch.zeros_like(occf)
    for d in NEIGHBOR_OFFSETS_26:
        s = _shift(onehot, d)
        Mp = _block_pair(onehot, s, bs)
        M = Mp if M is None else M + Mp
        occ_nbrs = occ_nbrs + torch.sum(s[..., :5], dim=-1)
    empty_w = (26.0 - occ_nbrs) * occf
    M[..., :, EMPTY] += _block_sum(onehot * empty_w[..., None], bs)
    feat = _stack_entries(M, _UPPER_TRI_6[:20])
    return feat * NORMALIZE_GRSD if normalize else feat


def vosch_subdiv(
    grid: VoxelGrid,
    type_grid: torch.Tensor,
    block_size: int,
    thresholds: Tuple[int, int, int] = (127, 127, 127),
    normalize_grsd: bool = False,
) -> torch.Tensor:
    """(Bx,By,Bz,137) per-subdivision VOSCH = GRSD-20 ++ ColorCHLAC-117,
    the feature of the ``color_voxel_recognition_2`` sliding-box detector
    (search_new.h:31-45); feed it to recognition.build_scene_data."""
    g = grsd20_subdiv(type_grid, grid.occupancy(), block_size, normalize=normalize_grsd)
    c = colorchlac117_subdiv(grid, block_size, thresholds)
    return torch.cat([g, c], dim=-1)


def grsd325_from_types(type_grid: torch.Tensor, occ: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """Rotation-variant GRSD-325 (extractGRSDSignature325,
    grsd_colorCHLAC_tools.hpp:306-452): per occupied voxel and each of the
    13 half-offsets, count (source type, neighbour type) for occupied
    neighbours only; bin = source + neighbour·5 + offset·25."""
    occf = occ.to(torch.float32)
    onehot = _one_hot(type_grid, 5) * occf[..., None]
    feats = []
    for d in NEIGHBOR_OFFSETS_13:
        M = _pair_matrix(onehot, _shift(onehot, d))  # (source, neighbour)
        feats.append(M.T.reshape(-1))
    feat = torch.cat(feats)
    return feat * NORMALIZE_GRSD if normalize else feat


NR_DIV = 7  # normal-angle divisions (grsd_colorCHLAC_tools.h:18)


def plus_grsd110_from_types(
    type_grid: torch.Tensor,
    occ: torch.Tensor,
    normal_grid: torch.Tensor,
    normalize: bool = False,
) -> torch.Tensor:
    """PlusGRSD-110 (extractPlusGRSDSignature110, tools.hpp:463-670):
    transitions over the 26 offsets between occupied voxels, binned by
    floor(sqrt(‖n_s×n_n‖)·7) (:616), packed as 7 × upper-triangle(5×5),
    plus 5 transitions-to-empty counts per source type.  ``normal_grid``
    (X,Y,Z,3): per-voxel mean normals, zero where invalid (an invalid
    neighbour normal counts as a transition to empty, :614)."""
    occf = occ.to(torch.float32)
    onehot = _one_hot(type_grid, 5) * occf[..., None]
    n = normal_grid
    n_ok = (torch.linalg.norm(n, dim=-1) > 1e-6) & occ
    tri = [(i, j) for i in range(5) for j in range(i, 5)]  # 15
    per_bin = torch.zeros((NR_DIV, 5, 5), dtype=torch.float32, device=occ.device)
    to_empty = torch.zeros((5,), dtype=torch.float32, device=occ.device)
    src_ok = onehot * n_ok[..., None].to(torch.float32)
    for d in NEIGHBOR_OFFSETS_26:
        nb_hot = _shift(onehot, d)
        nb_n = _shift(n, d)
        nb_ok = torch.linalg.norm(nb_n, dim=-1) > 1e-6
        cross = torch.linalg.norm(torch.linalg.cross(n, nb_n, dim=-1), dim=-1)
        abin = torch.clamp_max(torch.floor(torch.sqrt(torch.clamp_min(cross, 0.0)) * NR_DIV), NR_DIV - 1)
        valid_pair = nb_ok[..., None].to(torch.float32)
        for b in range(NR_DIV):
            sel = (abin == b).to(torch.float32)[..., None]
            per_bin[b] += _pair_matrix(src_ok * sel, nb_hot * valid_pair)
        nb_occupied = torch.sum(nb_hot, dim=-1)
        empty_like = torch.clamp_min(1.0 - nb_occupied * nb_ok.to(torch.float32), 0.0)
        to_empty = to_empty + torch.einsum("xyzc,xyz->c", src_ok, empty_like)
    parts = [_stack_entries(per_bin[b], tri) for b in range(NR_DIV)]
    feat = torch.cat(parts + [to_empty])  # 105 + 5
    return feat * NORMALIZE_GRSD if normalize else feat


def vosch(
    grid: VoxelGrid,
    type_grid: torch.Tensor,
    thresholds: Tuple[int, int, int] = (127, 127, 127),
    normalize_grsd: bool = False,
) -> torch.Tensor:
    """VOSCH = GRSD-20 ++ ColorCHLAC-117 → (137,), the golden-file format
    of color_chlac/demos/shape_data/*_GRSD_CCHLAC.pcd."""
    g = grsd20_from_types(type_grid, grid.occupancy(), normalize=normalize_grsd)
    c = colorchlac117(grid, thresholds)
    return torch.cat([g, c])
