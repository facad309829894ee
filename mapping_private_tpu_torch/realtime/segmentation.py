"""Real-time organized-cloud segmentation: image normals, multi-plane
RANSAC, lattice connected components and mean-shift normal segmentation.

Counterpart of ``mapping_private_tpu/realtime/segmentation.py`` (the
pcl::cuda pipeline of realtime_segmentation.cpp:73-300):

- ``fast_normals_image`` ← computeFastPointNormals (:230-231);
- ``multi_plane_ransac`` ← SampleConsensusModel1PointPlane +
  MultiRandomSampleConsensus (:265-295): a hypothesis is one point with
  its normal, planes accepted best first until ``min_coverage`` of the
  points is explained;
- ``connected_components_image`` ← the GPU connected-components pass;
- ``mean_shift_normals`` / ``segment_normal_image`` ← meanShiftSegmentation
  on the normal image (:259).

As in the JAX package, the neighbour shifts of the normals and of the
mean shift wrap around the image (``roll`` with no border mask), so a
border pixel sees the opposite border; only the connected components mask
the wrap.  Multi-plane RANSAC's round draws the row ``u[count]`` of its
uniforms, ``count`` being the planes accepted so far (the JAX
``fold_in(key, count)``).  The connected components read convergence on
the host once per ``_SWEEPS_PER_CHECK`` sweeps, never past ``max_iters``
(sweeps after the fixed point change nothing); ``_components`` and
``_segment`` also return the number of sweeps run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mapping_private_tpu_torch.fit.ransac import sample_live_indices

_SWEEPS_PER_CHECK = 8
_SHIFTS = ((-1, 0), (1, 0), (0, -1), (0, 1))  # up, down, left, right


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def fast_normals_image(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Cross-product normals from pixel neighbours.

    points: (H, W, 3) organized cloud; valid: (H, W).  Returns (H, W, 3)
    unit normals (0 where undefined), turned toward the camera (−z)."""
    dx = torch.roll(points, -1, 1) - torch.roll(points, 1, 1)
    dy = torch.roll(points, -1, 0) - torch.roll(points, 1, 0)
    n = torch.linalg.cross(dx, dy, dim=-1)
    ln = _norm(n)
    vx = valid & torch.roll(valid, -1, 1) & torch.roll(valid, 1, 1)
    vy = valid & torch.roll(valid, -1, 0) & torch.roll(valid, 1, 0)
    ok = vx & vy & (ln[..., 0] > 1e-12)
    n = torch.where(ok[..., None], n / torch.clamp_min(ln, 1e-30), 0.0)
    return n * torch.where(n[..., 2:3] > 0, -1.0, 1.0)


def multi_plane_ransac(
    xyz: torch.Tensor,
    normals: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator],
    num_hypotheses: int = 1024,
    max_planes: int = 6,
    threshold: float = 0.05,
    min_coverage: float = 0.9,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential multi-plane extraction with 1-point-plane hypotheses.

    xyz, normals: (N, 3); mask: (N,) live.  ``u`` (max_planes,
    num_hypotheses) replaces the draws from ``generator``: the round that
    has accepted ``count`` planes samples with ``u[count]``.

    Returns planes (max_planes, 4) [n, d] (zeros in unused slots), labels
    (N,) int32 (−1 = unexplained) and the plane count, a 0-d int32 tensor."""
    dev = xyz.device
    if u is None:
        u = torch.rand((max_planes, num_hypotheses), generator=generator, device=dev)
    u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    total = torch.clamp_min(torch.sum(mask, dtype=torch.float32), 1.0)
    live = mask.clone()
    labels = torch.full((xyz.shape[0],), -1, dtype=torch.int32, device=dev)
    planes = torch.zeros((max_planes, 4), dtype=torch.float32, device=dev)
    count = 0
    for _ in range(max_planes):  # rounds after the JAX loop is done change nothing: stop there
        idx = sample_live_indices(None, live, (num_hypotheses,), u=u[count])
        p0, nh = xyz[idx], normals[idx]
        d = -torch.sum(nh * p0, dim=-1)
        dist = torch.abs(xyz @ nh.T + d[None, :])  # (N, H)
        inl = (dist < threshold) & live[:, None]
        scores = torch.sum(inl, dim=0, dtype=torch.float32)
        scores = torch.where(_norm(nh)[:, 0] > 1e-6, scores, 0.0)  # zero normals score 0
        best = torch.argmax(scores)  # the first maximum, as jnp.argmax
        if not bool(scores[best] > 0):
            break
        best_inl = inl[:, best]
        labels = torch.where(best_inl, count, labels)
        planes[count] = torch.cat([nh[best], d[best][None]])
        live = live & ~best_inl
        count += 1
        explained = 1.0 - torch.sum(live, dtype=torch.float32) / total
        if bool(explained >= min_coverage):
            break
    return planes, labels, torch.tensor(count, dtype=torch.int32, device=dev)


def _cc_sweep(labels: torch.Tensor, adjacency_ok: torch.Tensor, valid: torch.Tensor, dead: int) -> torch.Tensor:
    new = labels
    for a, (dy, dx) in enumerate(_SHIFTS):
        nb = torch.roll(labels, (-dy, -dx), dims=(0, 1))
        if dy == -1:  # mask off the wrap-around row or column
            nb[0, :] = dead
        elif dy == 1:
            nb[-1, :] = dead
        if dx == -1:
            nb[:, 0] = dead
        elif dx == 1:
            nb[:, -1] = dead
        new = torch.minimum(new, torch.where(adjacency_ok[..., a] & valid, nb, dead))
    return torch.where(valid, new, dead)


def _components(adjacency_ok: torch.Tensor, valid: torch.Tensor, max_iters: int) -> Tuple[torch.Tensor, int]:
    """``connected_components_image``'s labels and the sweeps it ran."""
    h, w = valid.shape
    dead = h * w
    init = torch.arange(h * w, dtype=torch.int32, device=valid.device).reshape(h, w)
    labels = torch.where(valid, init, dead)
    done = 0
    while done < max_iters:
        block = min(_SWEEPS_PER_CHECK, max_iters - done)
        for _ in range(block - 1):
            labels = _cc_sweep(labels, adjacency_ok, valid, dead)
        new = _cc_sweep(labels, adjacency_ok, valid, dead)
        done += block
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return labels, done


def connected_components_image(
    adjacency_ok: torch.Tensor, valid: torch.Tensor, max_iters: int = 256
) -> torch.Tensor:
    """4-neighbour connected components on an image lattice.

    adjacency_ok: (H, W, 4) bool, whether a pixel connects to its (up,
    down, left, right) neighbour.  Returns (H, W) int32 labels: the flat
    index of the component's least pixel, H·W for invalid pixels.  Stops
    at the fixed point or after ``max_iters`` sweeps, like the JAX
    ``while_loop``; a component too long to settle in ``max_iters`` sweeps
    comes out split, in both packages."""
    return _components(adjacency_ok, valid, max_iters)[0]


def mean_shift_normals(
    normal_img: torch.Tensor,
    valid: torch.Tensor,
    range_bandwidth: float = 0.3,
    window: int = 2,
    iterations: int = 5,
) -> torch.Tensor:
    """Mean-shift filtering of a normal image (meanShiftSegmentation's
    front half): each normal moves to the mean of the window's
    neighbours whose normals lie within ``range_bandwidth``."""
    n = normal_img
    bw2 = range_bandwidth * range_bandwidth
    for _ in range(iterations):
        acc = torch.zeros_like(n)
        wsum = torch.zeros(n.shape[:2], dtype=n.dtype, device=n.device)
        for dy in range(-window, window + 1):
            for dx in range(-window, window + 1):
                nb = torch.roll(n, (-dy, -dx), dims=(0, 1))
                vb = torch.roll(valid, (-dy, -dx), dims=(0, 1))
                d2 = torch.sum((nb - n) ** 2, dim=-1)
                wgt = ((d2 < bw2) & vb & valid).to(n.dtype)
                acc = acc + nb * wgt[..., None]
                wsum = wsum + wgt
        out = acc / torch.clamp_min(wsum, 1.0)[..., None]
        ln = _norm(out)
        n = torch.where(ln > 1e-9, out / torch.clamp_min(ln, 1e-30), n)
    return n


def _segment(
    normal_img: torch.Tensor, valid: torch.Tensor, range_bandwidth: float, min_size: int
) -> Tuple[torch.Tensor, int]:
    """``segment_normal_image``'s labels and the sweeps its connected
    components ran."""
    n = mean_shift_normals(normal_img, valid, range_bandwidth)
    bw2 = range_bandwidth * range_bandwidth
    adj = []
    for dy, dx in _SHIFTS:
        nb = torch.roll(n, (-dy, -dx), dims=(0, 1))
        vb = torch.roll(valid, (-dy, -dx), dims=(0, 1))
        adj.append((torch.sum((nb - n) ** 2, dim=-1) < bw2) & vb)
    labels, sweeps = _components(torch.stack(adj, dim=-1), valid, 256)
    h, w = valid.shape
    sizes = torch.zeros((h * w + 1,), dtype=torch.int32, device=valid.device)
    sizes.index_add_(0, labels.reshape(-1).long(), valid.reshape(-1).to(torch.int32))
    big = sizes[torch.clamp(labels, 0, h * w).long()] >= min_size
    return torch.where(valid & big, labels, h * w), sweeps


def segment_normal_image(
    normal_img: torch.Tensor,
    valid: torch.Tensor,
    range_bandwidth: float = 0.3,
    min_size: int = 30,
) -> torch.Tensor:
    """Mean-shift segmentation (meanShiftSegmentation, :259): filter the
    normals, then connected components over "normals agree" adjacency;
    components under ``min_size`` pixels dissolve to label H·W."""
    return _segment(normal_img, valid, range_bandwidth, min_size)[0]
