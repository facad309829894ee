"""Sliding-box subspace detection — the reference's ``SearchObj``.

Counterpart of ``mapping_private_tpu/recognition/search.py``
(color_voxel_recognition/src/search.cpp): the scene is cut into
subdivisions, each with a feature vector and an occupied-voxel count; a
3-D summed-area table gives every box's feature in O(1) (clipValue's
8-corner inclusion-exclusion, search.cpp:484-530); boxes of the object's
extent slide over the scene in up to 6 axis-permutation modes (getRange
:218-249, search :384-414); the score is ‖axis_q · f‖ / ‖f‖ (searchPart
:450-461); the best boxes are ranked with overlap suppression
(checkOverlap :327-356).

Every box origin of a mode is one set of 8 slices of the table and one
(X·Y·Z, D) × (D, M) product, on the table's device.  The summed-area
tables are f32, as in the JAX package: their corner differences cancel
large sums, so box sums differ from the JAX ones by ~eps × the table's
total.  The candidate pick (``np.argpartition`` over rank_num·8 per mode)
and the greedy ranking run on the host, as the JAX package's do.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the 6 axis-permutation search modes: mode -> (xrange, yrange, zrange)
# indices into the object's (range1, range2, range3) (search.cpp:218-249)
_MODE_PERMS = (
    (0, 1, 2),  # S_MODE_1
    (0, 2, 1),  # S_MODE_2
    (1, 0, 2),  # S_MODE_3
    (1, 2, 0),  # S_MODE_4
    (2, 0, 1),  # S_MODE_5
    (2, 1, 0),  # S_MODE_6
)


def active_modes(r1: int, r2: int, r3: int) -> List[int]:
    """Distinct modes for an object extent (search.cpp search() :387-413)."""
    if r1 == r2 == r3:
        return [0]
    if r1 == r2:
        return [0, 1, 4]
    if r2 == r3:
        return [0, 4, 5]
    if r1 == r3:
        return [0, 4, 2]
    return [0, 1, 2, 3, 4, 5]


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Integral tables of the subdivided scene.

    int_feat: (X+1, Y+1, Z+1, D) zero-padded SAT of subdivision features.
    int_exist: (X+1, Y+1, Z+1) SAT of occupied-voxel counts.
    """

    int_feat: torch.Tensor
    int_exist: torch.Tensor

    @property
    def dims(self) -> Tuple[int, int, int]:
        s = self.int_exist.shape
        return s[0] - 1, s[1] - 1, s[2] - 1


def _sat(x: torch.Tensor) -> torch.Tensor:
    """Triple cumsum over the grid axes, zero-padded in front of each."""
    s = torch.cumsum(torch.cumsum(torch.cumsum(x, dim=0), dim=1), dim=2)
    pad = [0, 0] * (x.ndim - 3) + [1, 0, 1, 0, 1, 0]
    return F.pad(s, pad)


def build_scene_data(
    features: torch.Tensor,
    exist_num: torch.Tensor,
    scene_axis=None,
    scene_mean=None,
) -> SceneData:
    """SAT construction (SearchObj::setData, search.cpp:538+).

    features: (X, Y, Z, D_raw) per-subdivision feature vectors.
    exist_num: (X, Y, Z) occupied-voxel counts.
    scene_axis: optional (dim, D_raw) compression axis (setSceneAxis),
      applied to each subdivision feature before integration, as
      detect_object.cpp does before setData.
    """
    f = features.to(torch.float32)
    if scene_axis is not None:
        if scene_mean is not None:
            f = f - torch.as_tensor(scene_mean, dtype=torch.float32, device=f.device)
        axis = torch.as_tensor(scene_axis, dtype=torch.float32, device=f.device)
        f = f @ axis.T
    return SceneData(int_feat=_sat(f), int_exist=_sat(exist_num.to(torch.float32)))


def _box_sums(sat: torch.Tensor, rx: int, ry: int, rz: int) -> torch.Tensor:
    """All-origin box sums from a zero-padded SAT: (X+1, Y+1, Z+1, ...) →
    (X−rx+1, Y−ry+1, Z−rz+1, ...), clipValue's 8 corners as 8 slices."""
    X, Y, Z = sat.shape[0] - 1, sat.shape[1] - 1, sat.shape[2] - 1
    xe, ye, ze = X - rx + 1, Y - ry + 1, Z - rz + 1

    def corner(dx, dy, dz):
        return sat[dx * rx : dx * rx + xe, dy * ry : dy * ry + ye, dz * rz : dz * rz + ze]

    return (
        corner(1, 1, 1)
        - corner(0, 1, 1)
        - corner(1, 0, 1)
        - corner(1, 1, 0)
        + corner(0, 0, 1)
        + corner(0, 1, 0)
        + corner(1, 0, 0)
        - corner(0, 0, 0)
    )


def _mode_scores(
    scene_feat: torch.Tensor,
    scene_exist: torch.Tensor,
    rx: int,
    ry: int,
    rz: int,
    axis_q: torch.Tensor,
    exist_threshold: float,
) -> torch.Tensor:
    """Similarity grid of one mode: (X−rx+1, Y−ry+1, Z−rz+1)."""
    f = _box_sums(scene_feat, rx, ry, rz)  # (..., D)
    e = _box_sums(scene_exist[..., None], rx, ry, rz)[..., 0]
    proj = f @ axis_q.T  # (..., M)
    num = torch.linalg.norm(proj, dim=-1)
    den = torch.clamp_min(torch.linalg.norm(f, dim=-1), 1e-20)
    return torch.where(e > exist_threshold, num / den, -1.0)


@dataclasses.dataclass
class Detection:
    """One ranked detection: box origin (subdivision coords), extent, score."""

    x: int
    y: int
    z: int
    xrange: int
    yrange: int
    zrange: int
    mode: int
    score: float


def _overlaps(a: Detection, b: Detection) -> bool:
    """Axis-aligned interval overlap in all 3 dims (checkOverlap :327-356)."""
    return (
        a.x < b.x + b.xrange and b.x < a.x + a.xrange
        and a.y < b.y + b.yrange and b.y < a.y + a.yrange
        and a.z < b.z + b.zrange and b.z < a.z + a.zrange
    )


def search_object(
    scene: SceneData,
    axis_q,
    ranges: Sequence[int],
    rank_num: int = 5,
    exist_threshold: float = 10.0,
    with_rotation: bool = True,
    score_floor: float = 0.0,
) -> List[Detection]:
    """Sliding-box subspace detection of one object.

    Args:
      scene: integral tables from build_scene_data.
      axis_q: (dim_model, dim) object subspace (recognition.subspace_axis).
      ranges: (range1, range2, range3) object extent in subdivisions.
      rank_num: number of ranked detections to keep.
      with_rotation: try all distinct axis permutations (search vs
        searchWithoutRotation, search.cpp:384-427).

    Returns up to rank_num non-overlapping Detections, best first.
    """
    r = tuple(int(v) for v in ranges)
    X, Y, Z = scene.dims
    modes = active_modes(*r) if with_rotation else [0]
    axis_q = torch.as_tensor(axis_q, dtype=torch.float32, device=scene.int_feat.device)

    candidates: List[Detection] = []
    for m in modes:
        perm = _MODE_PERMS[m]
        rx, ry, rz = r[perm[0]], r[perm[1]], r[perm[2]]
        if X - rx + 1 <= 0 or Y - ry + 1 <= 0 or Z - rz + 1 <= 0:
            continue
        sim = _mode_scores(scene.int_feat, scene.int_exist, rx, ry, rz, axis_q,
                           float(exist_threshold)).cpu().numpy()
        # keep the best rank_num*8 per mode: overlap suppression needs slack
        flat = sim.ravel()
        k = min(len(flat), rank_num * 8)
        top = np.argpartition(-flat, k - 1)[:k]
        for t in top:
            s = float(flat[t])
            if s <= score_floor:
                continue
            zi = t % sim.shape[2]
            yi = (t // sim.shape[2]) % sim.shape[1]
            xi = t // (sim.shape[1] * sim.shape[2])
            candidates.append(Detection(int(xi), int(yi), int(zi), rx, ry, rz, m, s))

    # greedy overlap-suppressed ranking (maxAssign/maxCpy semantics)
    candidates.sort(key=lambda d: -d.score)
    ranked: List[Detection] = []
    for c in candidates:
        if len(ranked) >= rank_num:
            break
        if any(_overlaps(c, kept) for kept in ranked):
            continue
        ranked.append(c)
    return ranked


def search_objects_multi(
    scene: SceneData,
    axes_q: Sequence,
    ranges_list: Sequence[Sequence[int]],
    rank_num: int = 5,
    exist_threshold: float = 10.0,
    with_rotation: bool = True,
    score_floor: float = 0.0,
) -> List[List[Detection]]:
    """Multi-object variant (``SearchObjMulti``, search.h:185-270): one
    scene SAT shared by all object subspaces."""
    return [
        search_object(scene, aq, rg, rank_num=rank_num, exist_threshold=exist_threshold,
                      with_rotation=with_rotation, score_floor=score_floor)
        for aq, rg in zip(axes_q, ranges_list)
    ]
