"""Sequential Hough-voting shape segmentation.

Counterpart of ``mapping_private_tpu/models/hough_segmentation.py``
(the reference's hough_segmentation package, sequential_hough.cpp and
segmentation_by_voting.cpp).  Per scene it repeatedly (a) scores H
random line and circle hypotheses on the table-projected 2-D points at
once, (b) votes each hypothesis into a quantized parameter space with
its inlier count, (c) takes the cell with the most votes, averages its
hypotheses, passes the candidate through the hypothesis gates (the
clustering feature, the curvature-subset refit, the line length, the
too-many-planar-curvatures test, and optionally the RSD and normal
features), grows the winner's inliers into a cuboid or a cylinder,
removes them and repeats; a significant-plane pass may run first and a
rest-of-points pass (euclidean clusters as PCA boxes or circle-fit
cylinders) after.  ``segment_by_voting`` clusters the scene first and
votes one model per cluster.  HoughConfig and VotingConfig keep the JAX
package's defaults and the reference line numbers they cite.

Each round's device work is the (H, N) inlier counts for lines and for
circles and the votes; the short outer loop (one iteration per extracted
object) runs on the host, as in the JAX package.  Results are host data:
``HoughSegment`` holds numpy arrays and Python numbers, and its boxes
hold CPU tensors.

Port notes, each keeping the JAX result:

- Draws: each round takes (H, 2) line and (H, 3) circle uniforms, the
  significant-plane pass (H', 3).  Both entry points take a
  ``torch.Generator`` or ``u``, the list of those uniforms in the order
  the JAX package draws them (``tests/jax_ref.py::hough_uniforms``
  reproduces its key chain).
- Binning divides by f32 tensors: a CUDA division by a Python scalar
  multiplies by its reciprocal, which moves values at a bin's edge.
  ``.to(torch.int32)`` truncates toward zero as ``.astype(int32)`` does.
- The circle hash multiplies int32 by −1640531535 and wraps, in
  ``torch.int32`` on every device as in the JAX package; its 2^20
  buckets are the product's low 20 bits, which an int64 product would
  give as well.
- Votes scatter-add int32 counts (exact) and the first maximum wins
  (``torch.argmax`` as ``jnp.argmax``).
- Cluster orders on the host (``np.unique``, ``np.argsort(-counts)``)
  are the JAX package's numpy calls, so equal-size clusters keep its
  order; ``jnp.nanpercentile`` is ``torch.nanquantile`` (linear).
- The rest-of-points dedup list holds every emitted segment's centroid,
  the significant plane's included, as the JAX package's does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.features.rsd import rsd_radii
from mapping_private_tpu_torch.fit.box import OrientedBox, fit_box_pca, fit_box_zup
from mapping_private_tpu_torch.fit.ransac import fit_plane_ransac, sample_live_indices
from mapping_private_tpu_torch.ops.cluster import euclidean_cluster
from mapping_private_tpu_torch.ops.filters import statistical_outlier_mask
from mapping_private_tpu_torch.ops.mls import mls
from mapping_private_tpu_torch.ops.neighbors import knn_bruteforce
from mapping_private_tpu_torch.ops.normals import estimate_normals
from mapping_private_tpu_torch.ops.region_growing import region_grow


@dataclasses.dataclass(frozen=True)
class HoughConfig:
    num_hypotheses: int = 512
    line_threshold: float = 0.01  # sequential_hough.cpp:113
    circle_threshold: float = 0.01  # :114
    min_radius: float = 0.010
    max_radius: float = 0.100
    max_objects: int = 5
    min_inliers: int = 50  # minimum_line_inliers / minimum_circle_inliers
    # parameter-space quantization (clustering tolerance, :142-143)
    rho_bin: float = 0.01
    theta_bins: int = 90
    center_bin: float = 0.01
    radius_bin: float = 0.005
    grow_xy_margin: float = 0.015  # vertical growth corridor around the model
    # size classification (:181-189)
    flat_value: float = 0.25
    tall_value: float = 0.75
    medium_value: float = 0.50
    short_value: float = 0.25
    # --- hypothesis gates (reference defaults :88-136, recipes readme/) ---
    use_feature_gates: bool = True
    # MLS smoothing preamble (sequential_hough.cpp:1815-1860; the real-data
    # recipes run it with -smoothing_search_radius 0.020,
    # readme/sequential_hough:1-5); off by default
    mls_smoothing: bool = False
    smoothing_search_radius: float = 0.020
    normal_search_k: int = 16  # normal_search_radius 0.02 as a kNN cap
    curvature_threshold: float = 0.010  # :88
    rsd_search_radius: float = 0.020  # :89
    rsd_plane_radius: float = 0.200  # :90
    low_r_min: float = 0.020  # :91
    high_r_min: float = 0.080  # :92
    rsd_feature_for_circles: bool = False  # plausibility band as a gate
    clustering_feature_for_lines: bool = True  # :128
    clustering_feature_for_circles: bool = True  # :129
    inliers_clustering_tolerance: float = 0.015  # :130-131
    # the effective inlier-clustering tolerance adapts to the cloud:
    # max(inliers_clustering_tolerance, spacing_multiplier * p90 NN spacing)
    clustering_spacing_multiplier: float = 2.5
    # scale-free form of the reference's ≤1-matching-curvatures rejection
    # (sequential_hough.cpp:760-764): a minimum FRACTION of the kept
    # inliers must carry the model family's curvature
    min_matching_curvature_fraction: float = 0.10
    normal_feature_for_lines: bool = False  # executed ref path: commented out
    normal_feature_for_circles: bool = False
    # among side-facing candidate inliers (|n_xy| ≥ 0.5) at least this
    # fraction must point radially from the circle centre; 0 disables
    circle_side_radiality_fraction: float = 0.0
    # a circle is valid only when its votes reach this multiple of the
    # live point count (more_votes_for_circles, :4196-4238); 0 disables
    circle_vote_density_min: float = 0.0
    line_normals_angle_threshold: float = 2.5  # degrees, :137
    circle_normals_angle_threshold: float = 10.0  # :138
    minimum_line_length: float = 0.025  # :115
    maximum_line_length: float = 0.250  # :116
    too_many_planar_curvatures: int = 1000  # :199 (recipes pass 1000)
    # --- significant plane (:95-99, sign :178) ---
    significant_plane: bool = False
    significant_plane_threshold: float = 0.02
    minimum_inliers_of_significant_plane: int = 300
    significant_plane_clustering_tolerance: float = 0.03
    minimum_size_of_significant_plane_cluster: int = 100
    # --- rest of the points (:183, :192-193) ---
    deal_with_the_rest_of_the_points: bool = True
    r_clustering_tolerance: float = 0.025
    minimum_size_of_r_clusters: int = 50
    # a rest cluster is dropped when its second-largest extent is below
    # r_cluster_min_extent, or when its XY centroid lies within
    # r_cluster_dedup_radius of an already-accepted segment; 0 disables
    r_cluster_min_extent: float = 0.02
    r_cluster_dedup_radius: float = 0.09
    # emit a cylinder instead of a PCA box when >= this fraction of a rest
    # cluster's XY footprint lies within circle_threshold of its Kåsa circle
    r_cluster_circle_fit: bool = True
    r_cluster_circle_inlier_fraction: float = 0.6
    # hypotheses within this distance of the winning model count as its
    # votes (segmentation_by_voting.cpp:123; sequential_hough.cpp:142-143)
    param_cluster_tolerance: float = 0.025


@dataclasses.dataclass
class HoughSegment:
    kind: str  # 'cuboid' | 'cylinder' | 'box' (rest-of-points PCA box) | 'plane'
    size_class: str  # 'tall' | 'medium' | 'short' | 'flat'
    inliers: np.ndarray  # (N,) bool
    num_inliers: int
    box: Optional[OrientedBox] = None  # cuboid params, CPU tensors
    cylinder: Optional[Tuple[np.ndarray, float, float, float]] = None
    # cylinder = (center_xy, radius, z_min, z_max)
    votes: int = 0


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _line_hypotheses(xy, mask, generator, H, threshold, u=None):
    """H 2-point line hypotheses → params (normal, rho ≥ 0, theta), inlier
    counts (H,) int32."""
    idx = sample_live_indices(generator, mask, (H, 2), u)
    p0, p1 = xy[idx[:, 0]], xy[idx[:, 1]]
    t = p1 - p0
    tlen = torch.linalg.norm(t, dim=-1, keepdim=True)
    ok = tlen[:, 0] > 1e-9
    t = t / torch.clamp_min(tlen, 1e-30)
    nrm = torch.stack([-t[:, 1], t[:, 0]], dim=-1)  # (H,2)
    c = -torch.sum(nrm * p0, dim=-1)
    # canonicalize: rho = −c ≥ 0 with nrm flipped accordingly (Hough form)
    nrm = nrm * torch.where(c > 0, -1.0, 1.0)[:, None]
    rho = torch.abs(c)
    theta = torch.atan2(nrm[:, 1], nrm[:, 0])  # (−π, π]
    d = torch.abs(xy @ nrm.T + (-rho)[None, :]).T  # (H,N)
    counts = torch.sum((d < threshold) & mask[None, :], dim=1, dtype=torch.int32)
    return nrm, rho, theta, torch.where(ok, counts, 0)


def _circle_hypotheses(xy, mask, generator, H, threshold, rmin, rmax, u=None):
    """H 3-point circle hypotheses → (centres (H,2), radii (H,), inlier
    counts (H,) int32)."""
    idx = sample_live_indices(generator, mask, (H, 3), u)
    a, b, c3 = xy[idx[:, 0]], xy[idx[:, 1]], xy[idx[:, 2]]
    d = 2.0 * (a[:, 0] * (b[:, 1] - c3[:, 1]) + b[:, 0] * (c3[:, 1] - a[:, 1])
               + c3[:, 0] * (a[:, 1] - b[:, 1]))
    ok = torch.abs(d) > 1e-12
    d = torch.where(ok, d, 1.0)
    a2, b2, c2 = torch.sum(a * a, -1), torch.sum(b * b, -1), torch.sum(c3 * c3, -1)
    ux = (a2 * (b[:, 1] - c3[:, 1]) + b2 * (c3[:, 1] - a[:, 1]) + c2 * (a[:, 1] - b[:, 1])) / d
    uy = (a2 * (c3[:, 0] - b[:, 0]) + b2 * (a[:, 0] - c3[:, 0]) + c2 * (b[:, 0] - a[:, 0])) / d
    center = torch.stack([ux, uy], -1)
    radius = torch.linalg.norm(a - center, dim=-1)
    ok = ok & (radius >= rmin) & (radius <= rmax)
    dc = torch.linalg.norm(xy[None, :, :] - center[:, None, :], dim=-1)
    dd = torch.abs(dc - radius[:, None])
    counts = torch.sum((dd < threshold) & mask[None, :], dim=1, dtype=torch.int32)
    return center, radius, torch.where(ok, counts, 0)


def _vote_argmax(bin_ids: torch.Tensor, weights: torch.Tensor, num_bins: int):
    """Scatter-add int32 weights into bins; (best bin, its votes), the first
    bin on a tie."""
    acc = torch.zeros((num_bins,), dtype=torch.int32, device=weights.device)
    acc.index_add_(0, bin_ids.long(), weights)
    best = torch.argmax(acc)
    return best, acc[best]


def _circle_bins(center, radius, cfg: HoughConfig):
    """(H,) int32 hashed (cx, cy, r) bins: the id space is hashed into
    2^20 buckets by an int32 multiply that wraps (collisions only merge
    votes)."""
    dev = center.device
    cb = _f32(cfg.center_bin, dev)
    cx_id = torch.clamp(((center[:, 0] + 5.0) / cb).to(torch.int32), 0, 1023)
    cy_id = torch.clamp(((center[:, 1] + 5.0) / cb).to(torch.int32), 0, 1023)
    r_id = torch.clamp((radius / _f32(cfg.radius_bin, dev)).to(torch.int32), 0, 63)
    ids = (cx_id * 1024 + cy_id) * 64 + r_id
    knuth = torch.tensor(-1640531535, dtype=torch.int32, device=dev)  # 2654435761 as int32
    return (ids * knuth) & ((1 << 20) - 1)


def _hough_round(xy, mask, cfg: HoughConfig, generator: Optional[torch.Generator] = None, u=None):
    """One extraction round.  Returns a dict of both candidates' params,
    votes and inlier masks (device tensors); the winner is chosen on the
    host.  ``u`` is the round's (line (H, 2), circle (H, 3)) uniforms in
    place of the generator's draws (line first, as the JAX package's
    key split gives them)."""
    H = cfg.num_hypotheses
    dev = xy.device
    ul, uc = (None, None) if u is None else (torch.as_tensor(v, device=dev) for v in u)

    # --- lines: vote in (rho, theta) parameter space ------------------------
    nrm, rho, theta, lc = _line_hypotheses(xy, mask, generator, H, cfg.line_threshold, ul)
    rho_id = torch.clamp((rho / _f32(cfg.rho_bin, dev)).to(torch.int32), 0, 999)
    pi = _f32(math.pi, dev)
    th_id = torch.clamp(((theta + pi) / _f32(2 * math.pi, dev) * _f32(cfg.theta_bins, dev)).to(torch.int32),
                        0, cfg.theta_bins - 1)
    line_bins = rho_id * cfg.theta_bins + th_id
    lbest, lvotes = _vote_argmax(line_bins, lc, 1000 * cfg.theta_bins)
    in_bin = (line_bins == lbest) & (lc > 0)
    w = in_bin.to(torch.float32) * lc.to(torch.float32)
    wsum = torch.clamp_min(torch.sum(w), 1e-9)
    line_n = torch.sum(nrm * w[:, None], dim=0) / wsum
    line_n = line_n / torch.clamp_min(torch.linalg.norm(line_n), 1e-12)
    line_rho = torch.sum(rho * w) / wsum
    line_d = torch.abs(xy @ line_n - line_rho)
    line_inl = (line_d < cfg.line_threshold) & mask
    # vote share: the fraction of valid hypotheses whose model lies within
    # the parameter-clustering tolerance of the winner (the reference's
    # voting_threshold percentage, segmentation_by_voting.cpp:94); (−n, −rho)
    # is the same line as (n, rho), so each hypothesis's rho is aligned with
    # the winner's normal first
    lvalid = lc > 0
    ldot = nrm @ line_n
    lsgn = torch.where(ldot >= 0.0, 1.0, -1.0)
    cos10 = torch.cos(torch.deg2rad(_f32(10.0, dev)))
    lnear = lvalid & (torch.abs(lsgn * rho - line_rho) < cfg.param_cluster_tolerance) & (torch.abs(ldot) > cos10)
    line_hyp_frac = torch.sum(lnear, dtype=torch.float32) / torch.clamp_min(
        torch.sum(lvalid, dtype=torch.float32), 1.0)

    # --- circles: vote in (cx, cy, r) parameter space -----------------------
    center, radius, cc = _circle_hypotheses(xy, mask, generator, H, cfg.circle_threshold, cfg.min_radius,
                                            cfg.max_radius, uc)
    circ_bins = _circle_bins(center, radius, cfg)
    cbest, cvotes = _vote_argmax(circ_bins, cc, 1 << 20)
    cin = (circ_bins == cbest) & (cc > 0)
    cw = cin.to(torch.float32) * cc.to(torch.float32)
    cwsum = torch.clamp_min(torch.sum(cw), 1e-9)
    circ_c = torch.sum(center * cw[:, None], dim=0) / cwsum
    circ_r = torch.sum(radius * cw) / cwsum
    circ_d = torch.abs(torch.linalg.norm(xy - circ_c, dim=-1) - circ_r)
    circ_inl = (circ_d < cfg.circle_threshold) & mask
    cvalid = cc > 0
    cnear = (cvalid & (torch.linalg.norm(center - circ_c, dim=-1) < cfg.param_cluster_tolerance)
             & (torch.abs(radius - circ_r) < cfg.param_cluster_tolerance))
    circ_hyp_frac = torch.sum(cnear, dtype=torch.float32) / torch.clamp_min(
        torch.sum(cvalid, dtype=torch.float32), 1.0)

    return dict(
        line_votes=lvotes, line_count=torch.sum(line_inl, dtype=torch.int32), line_inl=line_inl,
        line_n=line_n, line_rho=line_rho, line_hyp_frac=line_hyp_frac,
        circ_votes=cvotes, circ_count=torch.sum(circ_inl, dtype=torch.int32), circ_inl=circ_inl,
        circ_c=circ_c, circ_r=circ_r, circ_hyp_frac=circ_hyp_frac,
    )


def _classify_size(extents: np.ndarray, cfg) -> str:
    """tall/medium/short/flat classification (sequential_hough.cpp:3727-3816);
    flat additionally requires the *height* to be the small dimension (a
    pancake, not a pole).  Heights compare against tall/medium_value
    (:187-189)."""
    e = np.asarray(extents, np.float64)
    height = float(e[2])
    footprint = np.sort(e[:2])
    is_smallest = height <= footprint[0] + 1e-9
    if is_smallest and height / max(footprint.sum(), 1e-9) < cfg.flat_value:
        return "flat"
    if height > cfg.tall_value:
        return "tall"
    if height > cfg.medium_value:
        return "medium"
    return "short"


# ---------------------------------------------------------------------------
# hypothesis gates


def _clustering_gate(xyz, inl, planar, tol: float, want_planar: bool):
    """ClusteringFeatureForLines/Circles (sequential_hough.cpp:662-1255):
    euclidean-cluster the candidate's inliers; per cluster count the points
    whose curvature matches the model family (planar for lines, circular
    for circles); keep the cluster with the most matching curvatures.

    Returns (kept_mask, n_match_best): the winning cluster's members (all
    False when there is none) and its matching-curvature count (the
    reference rejects the model when ≤ 1)."""
    n = xyz.shape[0]
    labels = euclidean_cluster(xyz, inl, tol)
    match = planar if want_planar else ~planar
    counts = torch.zeros((n + 1,), dtype=torch.int32, device=xyz.device)
    counts.index_add_(0, labels.long(), (inl & match).to(torch.int32))
    counts[n] = 0
    best = torch.argmax(counts)
    return (labels == best) & inl, counts[best]


def _line_refit(xy, sel):
    """LS line on the selected points (adjustLineModel at half threshold).
    Returns (normal (2,), rho, ok)."""
    w = sel.to(torch.float32)
    wsum = torch.clamp_min(torch.sum(w), 1e-9)
    mean = torch.sum(xy * w[:, None], dim=0) / wsum
    d = (xy - mean) * w[:, None]
    cov = d.T @ d / wsum
    a, b, c = cov[0, 0], cov[0, 1], cov[1, 1]
    theta = 0.5 * torch.atan2(2.0 * b, a - c)
    direc = torch.stack([torch.cos(theta), torch.sin(theta)])
    nrm = torch.stack([-direc[1], direc[0]])
    rho = torch.sum(nrm * mean)
    flip = torch.where(rho < 0, -1.0, 1.0)
    return nrm * flip, torch.abs(rho), torch.sum(sel) >= 2


def _circle_refit(xy, sel):
    """Kåsa algebraic LS circle on the selected points (adjustCircleModel).
    Returns (center (2,), radius, ok)."""
    w = sel.to(torch.float32)
    wsum = torch.clamp_min(torch.sum(w), 1e-9)
    mean = torch.sum(xy * w[:, None], dim=0) / wsum
    u = (xy - mean) * w[:, None]
    Suu = torch.sum(u[:, 0] * u[:, 0])
    Svv = torch.sum(u[:, 1] * u[:, 1])
    Suv = torch.sum(u[:, 0] * u[:, 1])
    Suuu = torch.sum(u[:, 0] ** 3)
    Svvv = torch.sum(u[:, 1] ** 3)
    Suvv = torch.sum(u[:, 0] * u[:, 1] ** 2)
    Svuu = torch.sum(u[:, 1] * u[:, 0] ** 2)
    rhs = 0.5 * torch.stack([Suuu + Suvv, Svvv + Svuu])
    det = Suu * Svv - Suv * Suv
    ok = torch.abs(det) > 1e-12
    Ainv = torch.stack([torch.stack([Svv, -Suv]), torch.stack([-Suv, Suu])]) / torch.where(ok, det, 1.0)
    uc = Ainv @ rhs
    center = uc + mean
    r = torch.sqrt(torch.clamp_min(torch.sum(uc * uc) + (Suu + Svv) / wsum, 1e-12))
    return center, r, ok & (torch.sum(sel) >= 3)


def _unit_rows(v):
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)


def _normal_gate_line(normals_xy, inl, line_n, thresh_deg):
    """NormalFeatureForLines (:1257-1354): keep inliers whose xy-normal is
    ⊥ the line direction within thresh (i.e. parallel to the line normal)."""
    cosang = torch.abs(_unit_rows(normals_xy) @ line_n)
    return inl & (cosang > torch.cos(torch.deg2rad(_f32(thresh_deg, line_n.device))))


def _normal_gate_circle(xy, normals_xy, inl, center, thresh_deg):
    """NormalFeatureForCircles (:1356-1455): radial xy-normals."""
    cosang = torch.abs(torch.sum(_unit_rows(xy - center) * _unit_rows(normals_xy), dim=-1))
    return inl & (cosang > torch.cos(torch.deg2rad(_f32(thresh_deg, xy.device))))


def _point_features(cloud: PointCloud, cfg):
    """Curvature + xy-normals + RSD r_min channels for the gates (the
    reference's smoothing→normals→RSD preamble, :1815-2185), and the p90
    nearest-neighbour spacing of the live cloud."""
    if cloud.has_channel("normal") and cloud.has_channel("curvature"):
        cloud_n = cloud  # MLS preamble already attached smoothed features
    else:
        cloud_n = estimate_normals(cloud, k=cfg.normal_search_k)
    normals = cloud_n.channel("normal")
    curvature = cloud_n.channel("curvature")
    xyz = cloud.padded_xyz()
    r_min, _r_max = rsd_radii(xyz, cloud.mask, xyz, cloud.mask, normals, normals,
                              radius=cfg.rsd_search_radius, k=16, plane_radius=cfg.rsd_plane_radius)
    _, sq1 = knn_bruteforce(xyz, xyz, cloud.mask, k=1, exclude_self=True)
    d1 = torch.sqrt(torch.clamp_min(sq1[:, 0], 0.0))
    d1 = torch.where(cloud.mask, d1, torch.nan)
    spacing_p90 = torch.nanquantile(d1, 0.9)
    return normals[:, :2], curvature, r_min, spacing_p90


def _host_box(box: OrientedBox) -> OrientedBox:
    return OrientedBox(center=box.center.cpu(), axes=box.axes.cpu(), extents=box.extents.cpu())


def _pca_box_objects(
    xyz: np.ndarray, live: np.ndarray, cfg: HoughConfig, device,
    accepted_xy: Optional[np.ndarray] = None,
) -> List[HoughSegment]:
    """Deal-with-the-rest-of-the-points pass (:6357-6600): euclidean-
    cluster what remains, fit a PCA oriented box per cluster, largest
    first.  A cluster that is a sliver, or whose XY centroid lies near an
    ``accepted_xy`` centroid (or an accepted rest cluster's), is dropped;
    a cluster whose footprint fits its Kåsa circle becomes a cylinder
    (segmentation_by_voting.cpp:239-320)."""
    xyz_t = torch.as_tensor(xyz, device=device)
    labels = euclidean_cluster(xyz_t, torch.as_tensor(live, device=device),
                               cfg.r_clustering_tolerance).cpu().numpy()
    out: List[HoughSegment] = []
    n = len(xyz)
    avoid = list(accepted_xy) if accepted_xy is not None else []
    lbls, cnts = np.unique(labels[labels < n], return_counts=True)
    for i in np.argsort(-cnts):  # largest first — dedup favors the body
        lbl, cnt = lbls[i], cnts[i]
        if cnt < cfg.minimum_size_of_r_clusters:
            continue
        sel = labels == lbl
        sel_t = torch.as_tensor(sel, device=device)
        box = _host_box(fit_box_pca(xyz_t, sel_t))
        # express height as the z-span for size classes
        zsel = xyz[sel][:, 2]
        ext = np.asarray(box.extents).copy()
        ext_sorted = np.sort(ext)[::-1]
        extents = np.array([ext_sorted[0], ext_sorted[1], float(zsel.max() - zsel.min())])
        if cfg.r_cluster_min_extent > 0 and ext_sorted[1] < cfg.r_cluster_min_extent:
            continue  # sliver (a strip of outliers, not an object)
        cen = xyz[sel][:, :2].mean(0)
        if cfg.r_cluster_dedup_radius > 0 and avoid:
            if np.min(np.linalg.norm(np.asarray(avoid) - cen, axis=1)) < cfg.r_cluster_dedup_radius:
                continue  # leftover of an already-claimed object
        seg = None
        if cfg.r_cluster_circle_fit:
            c2, r2, okc = _circle_refit(xyz_t[:, :2], sel_t)
            c2, r2 = c2.cpu().numpy(), float(r2)
            if bool(okc) and cfg.min_radius <= r2 <= cfg.max_radius:
                d = np.abs(np.linalg.norm(xyz[sel][:, :2] - c2, axis=1) - r2)
                if (d < cfg.circle_threshold).mean() >= cfg.r_cluster_circle_inlier_fraction:
                    seg = HoughSegment(
                        kind="cylinder",
                        size_class=_classify_size(np.array([2 * r2, 2 * r2, extents[2]]), cfg),
                        inliers=sel, num_inliers=int(cnt),
                        cylinder=(c2, r2, float(zsel.min()), float(zsel.max())),
                    )
        if seg is None:
            seg = HoughSegment(kind="box", size_class=_classify_size(extents, cfg), inliers=sel,
                               num_inliers=int(cnt), box=box)
        out.append(seg)
        avoid.append(cen)
    out.sort(key=lambda s: -s.num_inliers)
    return out


def _significant_plane_pass(
    xyz: np.ndarray, live: np.ndarray, cfg: HoughConfig, device, generator=None, u=None,
) -> Tuple[Optional[HoughSegment], np.ndarray]:
    """Significant-plane handling (:2347-3913): RANSAC plane → accept if
    enough inliers → the biggest euclidean cluster becomes a planar object.
    ``u`` is the plane fit's (max(H, 128), 3) uniforms."""
    xyz_t = torch.as_tensor(xyz, device=device)
    _, inl = fit_plane_ransac(xyz_t, torch.as_tensor(live, device=device), generator,
                              threshold=cfg.significant_plane_threshold,
                              num_hypotheses=max(cfg.num_hypotheses, 128),
                              u=None if u is None else torch.as_tensor(u, device=device))
    inl_np = inl.cpu().numpy() & live
    if int(inl_np.sum()) < cfg.minimum_inliers_of_significant_plane:
        return None, live
    labels = euclidean_cluster(xyz_t, torch.as_tensor(inl_np, device=device),
                               cfg.significant_plane_clustering_tolerance).cpu().numpy()
    n = len(xyz)
    ok = labels[labels < n]
    if ok.size == 0:
        return None, live
    lbl, cnt = np.unique(ok, return_counts=True)
    best = lbl[np.argmax(cnt)]
    if int(cnt.max()) < cfg.minimum_size_of_significant_plane_cluster:
        return None, live
    sel = labels == best
    box = _host_box(fit_box_pca(xyz_t, torch.as_tensor(sel, device=device)))
    zsel = xyz[sel][:, 2]
    ext_sorted = np.sort(np.asarray(box.extents))[::-1]
    extents = np.array([float(ext_sorted[0]), float(ext_sorted[1]), float(zsel.max() - zsel.min())])
    seg = HoughSegment(kind="plane", size_class=_classify_size(extents, cfg), inliers=sel,
                       num_inliers=int(sel.sum()), box=box)
    return seg, live & ~sel


def _next_draw(draws: Optional[Iterator], what: str):
    if draws is None:
        return None
    try:
        return next(draws)
    except StopIteration:
        raise ValueError(f"the uniforms u ran out before {what}") from None


def hough_segment(
    cloud: PointCloud,
    generator: Optional[torch.Generator] = None,
    cfg: HoughConfig = HoughConfig(),
    table_z: Optional[float] = None,
    u: Optional[Sequence] = None,
) -> List[HoughSegment]:
    """Sequentially extract cuboid/cylinder objects from a tabletop cloud
    on the cloud's device.

    The cloud should already be table-relative (or pass table_z to
    subtract).  Draws come from ``generator``, or from ``u``: the
    significant plane's (max(H, 128), 3) uniforms when
    ``cfg.significant_plane``, then one (line (H, 2), circle (H, 3)) pair
    a round.  Returns segments best-first; each claims a disjoint set of
    points."""
    if cfg.mls_smoothing:
        cloud = mls(cloud, search_radius=cfg.smoothing_search_radius)
    dev = cloud.xyz.device
    xyz_t = cloud.padded_xyz()
    xy = xyz_t[:, :2].contiguous()
    xyz = xyz_t.cpu().numpy()
    z_off = float(table_z) if table_z is not None else 0.0
    z = xyz[:, 2] - z_off
    live_np = cloud.mask.cpu().numpy().copy()
    draws = None if u is None else iter(u)

    gates = cfg.use_feature_gates
    if gates:
        normals_xy, curvature, r_min, spacing_p90 = _point_features(cloud, cfg)
        planar = (curvature < cfg.curvature_threshold) & cloud.mask
        planar_np = planar.cpu().numpy()
        cluster_tol = max(float(np.float32(cfg.inliers_clustering_tolerance)),
                          float(np.float32(cfg.clustering_spacing_multiplier)
                                * np.nan_to_num(spacing_p90.cpu().numpy(), nan=0.0)))
    else:
        normals_xy = r_min = planar = planar_np = cluster_tol = None

    segments: List[HoughSegment] = []

    if cfg.significant_plane:
        seg, live_np = _significant_plane_pass(xyz, live_np, cfg, dev, generator,
                                               _next_draw(draws, "the significant plane"))
        if seg is not None:
            segments.append(seg)

    for it in range(cfg.max_objects):
        if int(live_np.sum()) < cfg.min_inliers:
            break
        live = torch.as_tensor(live_np, device=dev)
        r = _hough_round(xy, live, cfg, generator, _next_draw(draws, f"round {it}"))
        lv, cv = int(r["line_votes"]), int(r["circ_votes"])
        lcount, ccount = int(r["line_count"]), int(r["circ_count"])
        if max(lcount, ccount) < cfg.min_inliers:
            break

        # ---------------- line candidate + gates ----------------
        line_inl = r["line_inl"]
        line_n, line_rho = r["line_n"], r["line_rho"]
        valid_line = lcount >= cfg.min_inliers
        if valid_line and gates and cfg.clustering_feature_for_lines:
            kept, n_planar = _clustering_gate(xyz_t, line_inl, planar, cluster_tol, True)
            kept_n, n_planar = int(torch.sum(kept)), int(n_planar)
            if n_planar <= 1 or n_planar < cfg.min_matching_curvature_fraction * kept_n:
                valid_line = False
            else:
                line_inl = kept
                # adjust on the planar subset at half threshold
                subset = kept & planar
                nrm2, rho2, okfit = _line_refit(xy, subset)
                if bool(okfit):
                    half = (torch.abs(xy @ nrm2 - rho2) < cfg.line_threshold / 2) & subset
                    nrm3, rho3, ok3 = _line_refit(xy, half)
                    if bool(ok3) and int(torch.sum(half)) >= 2:
                        line_n, line_rho = nrm3, rho3
        if valid_line and gates and cfg.normal_feature_for_lines:
            line_inl = _normal_gate_line(normals_xy, line_inl, line_n, cfg.line_normals_angle_threshold)
            if int(torch.sum(line_inl)) == 0:
                valid_line = False
        if valid_line:
            # length-of-line gate on the kept inliers' extent along the line
            sel = line_inl.cpu().numpy()
            if sel.any():
                tv = (xy @ torch.stack([-line_n[1], line_n[0]])).cpu().numpy()[sel]
                lol = float(tv.max() - tv.min())
                if lol < cfg.minimum_line_length or lol > cfg.maximum_line_length:
                    valid_line = False
            else:
                valid_line = False
        line_size = int(torch.sum(line_inl)) if valid_line else 0
        if line_size < cfg.min_inliers:
            valid_line = False

        # ---------------- circle candidate + gates ----------------
        circ_inl = r["circ_inl"]
        circ_c, circ_r = r["circ_c"], r["circ_r"]
        valid_circle = ccount >= cfg.min_inliers
        if valid_circle and cfg.circle_vote_density_min > 0:
            if cv < cfg.circle_vote_density_min * int(live_np.sum()):
                valid_circle = False
        if valid_circle and gates and cfg.clustering_feature_for_circles:
            kept, n_circ = _clustering_gate(xyz_t, circ_inl, planar, cluster_tol, False)
            kept_n, n_circ = int(torch.sum(kept)), int(n_circ)
            if n_circ <= 1 or n_circ < cfg.min_matching_curvature_fraction * kept_n:
                valid_circle = False
            else:
                circ_inl = kept
                c2, r2, okc = _circle_refit(xy, kept)
                if bool(okc) and cfg.min_radius <= float(r2) <= cfg.max_radius:
                    half = (torch.abs(torch.linalg.norm(xy - c2, dim=-1) - r2) < cfg.circle_threshold / 2) & kept
                    c3, r3, ok3 = _circle_refit(xy, half)
                    if bool(ok3) and cfg.min_radius <= float(r3) <= cfg.max_radius:
                        circ_c, circ_r = c3, r3
        if valid_circle and gates:
            # too-many-planar-curvatures: the circle disk must not be a
            # flat region (:4210-4232)
            dcen = np.linalg.norm(xyz[:, :2] - circ_c.cpu().numpy(), axis=1)
            n_planar_in = int((planar_np & live_np & (dcen < float(circ_r) + cfg.circle_threshold)).sum())
            if n_planar_in > cfg.too_many_planar_curvatures:
                valid_circle = False
        if valid_circle and gates and cfg.rsd_feature_for_circles:
            rm = r_min.cpu().numpy()
            sel = circ_inl.cpu().numpy()
            plaus = (rm > cfg.low_r_min) & (rm < cfg.high_r_min)
            if sel.any() and plaus[sel].mean() < 0.5:
                valid_circle = False
        if valid_circle and gates and cfg.normal_feature_for_circles:
            circ_inl = _normal_gate_circle(xy, normals_xy, circ_inl, circ_c, cfg.circle_normals_angle_threshold)
            if int(torch.sum(circ_inl)) == 0:
                valid_circle = False
        if valid_circle and gates and cfg.circle_side_radiality_fraction > 0:
            cand_side = circ_inl & (torch.linalg.norm(normals_xy, dim=-1) >= 0.5)
            n_side = int(torch.sum(cand_side))
            radial = _normal_gate_circle(xy, normals_xy, cand_side, circ_c, cfg.circle_normals_angle_threshold)
            frac = int(torch.sum(radial)) / max(n_side, 1)
            if n_side == 0 or frac < cfg.circle_side_radiality_fraction:
                valid_circle = False
        circ_size = int(torch.sum(circ_inl)) if valid_circle else 0
        if circ_size < cfg.min_inliers:
            valid_circle = False

        # --------- decide line vs circle (larger filtered cloud, :4238) ----
        if not valid_line and not valid_circle:
            break
        use_circle = valid_circle and (not valid_line or circ_size >= line_size)

        if use_circle:
            grow = (torch.linalg.norm(xy - circ_c, dim=-1) < circ_r + cfg.grow_xy_margin) & live
            claimed = grow.cpu().numpy()
            zi = z[claimed]
            r_f = float(circ_r)
            seg_extents = np.array([2 * r_f, 2 * r_f, zi.max() - max(zi.min(), 0.0)])
            seg = HoughSegment(
                kind="cylinder", size_class=_classify_size(seg_extents, cfg), inliers=claimed,
                num_inliers=int(claimed.sum()),
                cylinder=(circ_c.cpu().numpy(), r_f, float(zi.min()), float(zi.max())), votes=cv,
            )
        else:
            # grow the full connected object from the line-corridor seed
            # (the reference's region-grow of winner inliers, :2827-2900)
            seeds = (torch.abs(xy @ line_n - line_rho) < cfg.line_threshold + cfg.grow_xy_margin) & live
            lab = region_grow(xyz_t, live, radius=cfg.grow_xy_margin * 2, seed_mask=seeds).cpu().numpy()
            # an infinite 2-D line seeds every object it crosses — keep only
            # the region holding the most line inliers (the reference
            # clusters line inliers and keeps the winning cluster, :2827+)
            n_cap = lab.shape[0]
            seeded = lab < n_cap
            if seeded.any():
                counts = np.bincount(lab[seeded & line_inl.cpu().numpy()], minlength=n_cap + 1)
                claimed = lab == int(counts.argmax())
            else:
                claimed = seeds.cpu().numpy()
            box = _host_box(fit_box_zup(xyz_t, torch.as_tensor(claimed, device=dev)))
            seg = HoughSegment(kind="cuboid", size_class=_classify_size(np.asarray(box.extents), cfg),
                               inliers=claimed, num_inliers=int(claimed.sum()), box=box, votes=lv)
        if seg.num_inliers < cfg.min_inliers:
            break
        segments.append(seg)
        live_np = live_np & ~seg.inliers

    # The rest-of-points pass runs after the loop however it ended (the
    # reference's deal_with_the_rest_of_the_points sits after the while
    # loop, sequential_hough.cpp:6357); its dedup list holds every emitted
    # segment, the significant plane's included.
    if cfg.deal_with_the_rest_of_the_points and live_np.any():
        acc = [xyz[s.inliers][:, :2].mean(0) for s in segments if s.inliers is not None and s.inliers.any()]
        segments.extend(_pca_box_objects(xyz, live_np, cfg, dev, accepted_xy=np.asarray(acc) if acc else None))
    return segments


def hough_mark_classes(cloud: PointCloud, segments: List[HoughSegment]) -> np.ndarray:
    """Per-point class marks — `hough_classification`'s marked output cloud
    (hough_classification.cpp:4294-4599: 3 for flat boxes, 2 for upright
    boxes, 4 for cylinders; unclaimed points stay 0).  Returns (N,) int32
    aligned with the cloud's rows."""
    marks = np.zeros((cloud.capacity,), np.int32)
    for s in segments:
        if s.kind == "cylinder":
            v = 4
        elif s.size_class == "flat":
            v = 3
        else:
            v = 2
        marks[s.inliers] = v
    return marks


# ---------------------------------------------------------------------------
# segmentation-by-voting: cluster-first per-object model voting
# (segmentation_by_voting.cpp: the scene is euclidean-clustered into object
# candidates FIRST (:876-940), then each cluster gets its own Hough
# line/circle vote (:971-2523) and is classified whole as a cylinder or a
# box; cylinder dimensions are logged to a sizes table (:423-445).  The
# using_{lines,circles}_for_segmentation_by_voting.cpp siblings are the
# allow_* switches.)


@dataclasses.dataclass(frozen=True)
class VotingConfig:
    """Defaults cite segmentation_by_voting.cpp:77-123."""

    # statistical outlier filter (:79-80)
    mean_k_filter: int = 25
    std_dev_filter: float = 1.0
    # MLS smoothing preamble for real Kinect scans (the RSD r_min estimates
    # the rsd_feature gate reads need it there)
    mls_smoothing: bool = False
    smoothing_search_radius: float = 0.020
    # scene → object clusters (:85-86)
    clustering_tolerance_of_objects: float = 0.025
    minimum_size_of_objects_clusters: int = 100
    # per-cluster model voting (:92-104)
    line_threshold: float = 0.010
    circle_threshold: float = 0.010
    voting_threshold: float = 0.25  # winning-model hypothesis share (:94)
    minimum_radius: float = 0.010
    maximum_radius: float = 0.100
    minimum_line_inliers: int = 10
    minimum_circle_inliers: int = 50
    num_hypotheses: int = 512
    param_cluster_tolerance: float = 0.025  # :123
    # feature gates (:106-122), executed semantics (:1246-1560): each gate
    # rejects when the surviving inliers are already fewer than
    # minimum_circle_inliers, then PRUNES them — curvature keeps
    # curvature > curvature_threshold (:1266), rsd keeps |circle_radius −
    # r_min| < radius_threshold (:1356), and percentage compares the
    # survivors with the originally fitted count (:1517)
    curvature_threshold: float = 0.010
    normal_search_k: int = 16
    rsd_search_radius: float = 0.020
    rsd_plane_radius: float = 0.200
    radius_threshold: float = 0.025  # :114
    curvature_feature: bool = True
    rsd_feature: bool = True
    percentage_feature: bool = True
    circle_percentage: float = 50.0  # :122 — % surviving the gates
    # the line variant's own knob (using_lines_for_segmentation_by_voting.cpp:122)
    line_percentage: float = 50.0
    # model-family restriction (using_lines/-circles variants)
    allow_lines: bool = True
    allow_circles: bool = True
    # size classes (shared thresholds with HoughConfig)
    flat_value: float = 0.25
    tall_value: float = 0.75
    medium_value: float = 0.50
    short_value: float = 0.25


def _voting_hough_cfg(cfg: VotingConfig) -> HoughConfig:
    """The HoughConfig of the per-cluster rounds."""
    return HoughConfig(
        num_hypotheses=cfg.num_hypotheses,
        line_threshold=cfg.line_threshold,
        circle_threshold=cfg.circle_threshold,
        min_radius=cfg.minimum_radius,
        max_radius=cfg.maximum_radius,
        param_cluster_tolerance=cfg.param_cluster_tolerance,
    )


def segment_by_voting(
    cloud: PointCloud,
    generator: Optional[torch.Generator] = None,
    cfg: VotingConfig = VotingConfig(),
    u: Optional[Sequence] = None,
) -> Tuple[List[HoughSegment], List[dict]]:
    """Cluster the scene into objects, then vote a circle/line model per
    cluster and classify it whole (cylinder vs box), on the cloud's
    device.  Draws come from ``generator``, or from ``u``: one (line
    (H, 2), circle (H, 3)) pair for each cluster large enough to vote, in
    ascending label order.

    Returns (segments, sizes): one segment per surviving cluster, and the
    sizes-table rows (the reference's cylinder-sizes text file — one dict
    per model with kind/radius/height/center or extents)."""
    if cfg.mls_smoothing:
        cloud = mls(cloud, search_radius=cfg.smoothing_search_radius)

    dev = cloud.xyz.device
    xyz_t = cloud.padded_xyz()
    keep = statistical_outlier_mask(xyz_t, cloud.mask, k=cfg.mean_k_filter, alpha=cfg.std_dev_filter)
    xyz = xyz_t.cpu().numpy()
    xy = xyz_t[:, :2].contiguous()
    draws = None if u is None else iter(u)

    hcfg = _voting_hough_cfg(cfg)
    if cfg.curvature_feature or cfg.rsd_feature:
        pf_cfg = HoughConfig(normal_search_k=cfg.normal_search_k, curvature_threshold=cfg.curvature_threshold,
                             rsd_search_radius=cfg.rsd_search_radius, rsd_plane_radius=cfg.rsd_plane_radius)
        _nxy, curvature, r_min, _sp = _point_features(cloud, pf_cfg)
        curvature_np = curvature.cpu().numpy()
        r_min_np = r_min.cpu().numpy()
    else:
        curvature_np = r_min_np = None

    labels = euclidean_cluster(xyz_t, keep, cfg.clustering_tolerance_of_objects).cpu().numpy()
    n = cloud.capacity
    segments: List[HoughSegment] = []
    sizes: List[dict] = []
    for lbl, cnt in zip(*np.unique(labels[labels < n], return_counts=True)):
        if cnt < cfg.minimum_size_of_objects_clusters:
            continue
        member = labels == lbl
        member_t = torch.as_tensor(member, device=dev)
        r = _hough_round(xy, member_t, hcfg, generator, _next_draw(draws, f"cluster {lbl}"))
        zc = xyz[member][:, 2]
        height = float(zc.max() - zc.min())

        # ---- circle decision (whole cluster becomes a cylinder) ----
        accept_circle = False
        circ_r = float(r["circ_r"])
        if cfg.allow_circles:
            fitted = r["circ_inl"].cpu().numpy()
            n_fitted = int(fitted.sum())
            sel = fitted
            accept_circle = (n_fitted >= cfg.minimum_circle_inliers
                             and cfg.minimum_radius <= circ_r <= cfg.maximum_radius
                             and float(r["circ_hyp_frac"]) >= cfg.voting_threshold)
            # sequential pruning gates (reference executed path, :1246-1560)
            if accept_circle and cfg.curvature_feature:
                sel = sel & (curvature_np > cfg.curvature_threshold)
            if accept_circle and cfg.rsd_feature:
                if int(sel.sum()) < cfg.minimum_circle_inliers:
                    accept_circle = False
                else:
                    sel = sel & (np.abs(circ_r - r_min_np) < cfg.radius_threshold)
            if accept_circle:
                n_kept = int(sel.sum())
                if n_kept < cfg.minimum_circle_inliers:
                    accept_circle = False
                elif cfg.percentage_feature:
                    accept_circle = 100.0 * n_kept / n_fitted >= cfg.circle_percentage

        if accept_circle:
            center = r["circ_c"].cpu().numpy()
            seg = HoughSegment(
                kind="cylinder", size_class=_classify_size(np.array([2 * circ_r, 2 * circ_r, height]), cfg),
                inliers=member, num_inliers=int(cnt),
                cylinder=(center, circ_r, float(zc.min()), float(zc.max())), votes=int(r["circ_votes"]),
            )
            sizes.append({"kind": "cylinder", "radius": circ_r, "height": height,
                          "center": [float(center[0]), float(center[1])]})
            segments.append(seg)
            continue

        # ---- line decision (cluster becomes an upright box) ----
        accept_line = False
        if cfg.allow_lines:
            fitted_l = r["line_inl"].cpu().numpy()
            n_fitted_l = int(fitted_l.sum())
            sel_l = fitted_l
            accept_line = (n_fitted_l >= cfg.minimum_line_inliers
                           and float(r["line_hyp_frac"]) >= cfg.voting_threshold)
            # line inliers should sit on planar (low-curvature) surfaces
            if accept_line and cfg.curvature_feature:
                sel_l = sel_l & (curvature_np < cfg.curvature_threshold)
            if accept_line:
                n_kept_l = int(sel_l.sum())
                if n_kept_l < cfg.minimum_line_inliers:
                    accept_line = False
                elif cfg.percentage_feature:
                    accept_line = 100.0 * n_kept_l / n_fitted_l >= cfg.line_percentage
        if accept_line:
            box = _host_box(fit_box_zup(xyz_t, member_t))
            seg = HoughSegment(kind="cuboid", size_class=_classify_size(np.asarray(box.extents), cfg),
                               inliers=member, num_inliers=int(cnt), box=box, votes=int(r["line_votes"]))
        else:
            # neither model voted in — still an object cluster (the
            # reference visualizes it unmodeled); PCA box envelope
            box = _host_box(fit_box_pca(xyz_t, member_t))
            ext = np.asarray(box.extents)
            seg = HoughSegment(kind="box", size_class=_classify_size(np.array([*np.sort(ext[:2])[::-1], height]), cfg),
                               inliers=member, num_inliers=int(cnt), box=box)
        sizes.append({"kind": seg.kind, "extents": [float(v) for v in np.asarray(seg.box.extents)],
                      "height": height})
        segments.append(seg)

    segments.sort(key=lambda s: -s.num_inliers)
    return segments, sizes


def cylinder_sizes_text(sizes: List[dict]) -> str:
    """Render the sizes table as the reference's cylinder-sizes text file
    (segmentation_by_voting.cpp:423-445 logs one line per accepted model)."""
    lines = []
    for row in sizes:
        if row["kind"] == "cylinder":
            cx, cy = row["center"]
            lines.append(f"cylinder radius {row['radius']:.4f} height {row['height']:.4f}"
                         f" center {cx:.4f} {cy:.4f}")
        else:
            e = " ".join(f"{v:.4f}" for v in row["extents"])
            lines.append(f"{row['kind']} extents {e} height {row['height']:.4f}")
    return "\n".join(lines) + ("\n" if lines else "")
