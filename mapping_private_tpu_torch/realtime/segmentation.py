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
``fold_in(key, count)``).

Two connected-components passes:

- ``connected_components_image`` is the JAX package's: the least label
  moves one pixel a sweep, and the loop stops at the fixed point or after
  ``max_iters`` sweeps (convergence read on the host once per
  ``_SWEEPS_PER_CHECK`` sweeps), so a component longer than that comes out
  split.  ``_components`` also returns the sweeps run.
- ``segment_normal_image`` labels its symmetric "normals agree" graph
  exactly, on any image (``_exact_components``): min-label hooking with
  pointer jumping (FastSV), whose paths halve each round, so a 640 x 480
  frame settles in 12-18 rounds, one host read each (a 150,000-pixel
  serpentine included), where one-pixel sweeps need thousands.  Its
  labels are those the capped loop reaches wherever that converges.
  ``_segment`` returns the rounds, which it also counts as
  ``segment.component_rounds``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mapping_private_tpu_torch.fit.ransac import sample_live_indices
from mapping_private_tpu_torch.utils.metrics import metrics

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


def _multi_plane_ransac(xyz, normals, mask, generator, num_hypotheses, max_planes, threshold, min_coverage, u):
    """``multi_plane_ransac``'s planes, labels and count, each plane's seed
    row (its hypothesis point, -1 in unused slots) and the rounds run."""
    dev = xyz.device
    if u is None:
        u = torch.rand((max_planes, num_hypotheses), generator=generator, device=dev)
    u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    total = torch.clamp_min(torch.sum(mask, dtype=torch.float32), 1.0)
    live = mask.clone()
    labels = torch.full((xyz.shape[0],), -1, dtype=torch.int32, device=dev)
    planes = torch.zeros((max_planes, 4), dtype=torch.float32, device=dev)
    seeds = torch.full((max_planes,), -1, dtype=torch.int64, device=dev)
    count = rounds = 0
    for _ in range(max_planes):  # rounds after the JAX loop is done change nothing: stop there
        rounds += 1
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
        seeds[count] = idx[best]
        live = live & ~best_inl
        count += 1
        explained = 1.0 - torch.sum(live, dtype=torch.float32) / total
        if bool(explained >= min_coverage):
            break
    return planes, labels, torch.tensor(count, dtype=torch.int32, device=dev), seeds, rounds


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
    return _multi_plane_ransac(xyz, normals, mask, generator, num_hypotheses, max_planes, threshold,
                               min_coverage, u)[:3]


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
    neighbours whose normals lie within ``range_bandwidth``.

    Each pass gathers the window's (2·window + 1)² wrapped neighbours at
    once (the JAX package's rolls) and weighs them together; the sums run
    over the neighbours in the JAX package's order, one add each."""
    n = normal_img
    h, w = valid.shape
    bw2 = range_bandwidth * range_bandwidth
    offsets = torch.arange(-window, window + 1, device=n.device)
    dy, dx = offsets.repeat_interleave(len(offsets)), offsets.repeat(len(offsets))  # the rolls' order
    rows = (torch.arange(h, device=n.device)[None, :] + dy[:, None]) % h  # roll by -dy reads row i + dy
    cols = (torch.arange(w, device=n.device)[None, :] + dx[:, None]) % w
    src = rows[:, :, None] * w + cols[:, None, :]  # (S, H, W) each shift's source pixel
    both = valid.reshape(-1)[src] & valid
    for _ in range(iterations):
        nb = n.reshape(-1, 3)[src]  # (S, H, W, 3)
        wgt = ((torch.sum((nb - n) ** 2, dim=-1) < bw2) & both).to(n.dtype)
        part = nb * wgt[..., None]
        acc = torch.zeros_like(n)
        wsum = torch.zeros(n.shape[:2], dtype=n.dtype, device=n.device)
        for k in range(src.shape[0]):
            acc = acc + part[k]
            wsum = wsum + wgt[k]
        out = acc / torch.clamp_min(wsum, 1.0)[..., None]
        ln = _norm(out)
        n = torch.where(ln > 1e-9, out / torch.clamp_min(ln, 1e-30), n)
    return n


def _exact_components(right: torch.Tensor, down: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Labels of the connected components of an image's undirected
    4-neighbour graph, and the rounds run.

    right: (H, W - 1) bool, pixel (i, j) joined to (i, j + 1); down:
    (H - 1, W) bool, (i, j) joined to (i + 1, j); both false at an invalid
    pixel.  Labels: the flat index of the component's least pixel, H·W for
    invalid pixels.  Each round hooks every pixel's root onto the least
    grandparent across its edges (stochastic and aggressive hooking) and
    halves every path (shortcutting); the labels only fall and stay within
    their component, so a round that changes nothing leaves every pixel
    pointing at the least pixel of its component.  One host read a round."""
    h, w = valid.shape
    n = h * w
    flat = torch.arange(n, device=valid.device).reshape(h, w)
    a = torch.cat([flat[:, :-1][right], flat[:-1, :][down]])
    b = torch.cat([flat[:, 1:][right], flat[1:, :][down]])
    src, dst = torch.cat([a, b]), torch.cat([b, a])  # each edge both ways
    f = flat.reshape(-1)
    rounds = 0
    while True:
        rounds += 1
        gf = f[f]
        hooked = gf[dst]
        new = f.scatter_reduce(0, f[src], hooked, "amin")  # stochastic hooking: a root takes the least
        new.scatter_reduce_(0, src, hooked, "amin")  # aggressive hooking: a pixel takes the least
        new = torch.minimum(new, gf)  # shortcutting
        if torch.equal(new, f):
            break
        f = new
    return torch.where(valid.reshape(-1), f, n).reshape(h, w).to(torch.int32), rounds


def _segment(
    normal_img: torch.Tensor, valid: torch.Tensor, range_bandwidth: float, min_size: int
) -> Tuple[torch.Tensor, int]:
    """``segment_normal_image``'s labels and the rounds its connected
    components ran (counted as ``segment.component_rounds``)."""
    n = mean_shift_normals(normal_img, valid, range_bandwidth)
    bw2 = range_bandwidth * range_bandwidth
    # the "normals agree" edges, each once: bit for bit the (right, down)
    # entries of the capped loop's adjacency, which is symmetric
    right = (torch.sum((n[:, 1:] - n[:, :-1]) ** 2, dim=-1) < bw2) & valid[:, 1:] & valid[:, :-1]
    down = (torch.sum((n[1:] - n[:-1]) ** 2, dim=-1) < bw2) & valid[1:] & valid[:-1]
    labels, rounds = _exact_components(right, down, valid)
    metrics.count("segment.component_rounds", rounds)
    h, w = valid.shape
    sizes = torch.zeros((h * w + 1,), dtype=torch.int32, device=valid.device)
    sizes.index_add_(0, labels.reshape(-1).long(), valid.reshape(-1).to(torch.int32))
    big = sizes[torch.clamp(labels, 0, h * w).long()] >= min_size
    return torch.where(valid & big, labels, h * w), rounds


def segment_normal_image(
    normal_img: torch.Tensor,
    valid: torch.Tensor,
    range_bandwidth: float = 0.3,
    min_size: int = 30,
) -> torch.Tensor:
    """Mean-shift segmentation (meanShiftSegmentation, :259): filter the
    normals, then the exact connected components of the "normals agree"
    graph (4-neighbour, no wrap), on an image of any size; components under
    ``min_size`` pixels dissolve to label H·W."""
    return _segment(normal_img, valid, range_bandwidth, min_size)[0]
