"""Plain reference of the table pipeline, frame by frame, and the comparison.

From the ring's host arrays and the RANSAC uniforms the benchmark drew
(never anything the program made), in float64 on the device with host
numpy where the work is small:

1. the box filter (its test in float32) and the statistical denoise: the
   mean distance of each live point to its k nearest live points, kept
   within mean +- alpha std; it depends on the frame alone, so it is taken
   once for each ring frame and serves every record of that frame;
2. the table detector: the height band, per-voxel centroids (voxels in
   the ascending order of their packed cell key, as the detector orders
   its rows, so that a uniform picks the same row), k-NN normals, the
   candidates with near-vertical normals clustered over k-NN edges within
   the tolerance and the normal angle, a RANSAC plane per candidate from
   the same uniforms (MSAC score, two total-least-squares refits), the
   best vertical plane, its bounds and radial hull, and the object
   clusters above it within the hull that start near the table;
3. the table memory: each observation's convex hull matched to a known
   table by the >50% overlap rule or its centre inside; each object
   reconstructed (MLS with a Gaussian-weighted order-2 height polynomial
   over its 16 nearest points, a cylinder by MSAC over 512 two-point
   hypotheses from the memory's uniforms, replayed from the benchmark's
   generator, a z-up box, the cylinder taken above 80% inliers); objects
   named by the nearest centroid of the table's last observation within
   8 cm.

The denoise is judged against the reference's own; the detector and the
memory are run from the judged side's kept rows (see ``check``), and two
kinds of tie are decided as the judged side decided them: a voxel within
``GATE_TIE_M`` of a gate of the object search, and a cylinder hypothesis
within ``CYL_TIE`` of the best score.

Numbers compared, each the largest over the window's frames:
``denoise_share_differ`` (rows kept by one side only, over the rows
inside the box), ``denoise_cut_margin`` (how far, in the reference's
standard deviations, a row kept by one side only lies from the reference's
mean +- alpha std cut),
``plane_angle_rad`` and ``plane_offset_m`` (the table planes),
``hull_radius_m`` (the hull's centre and per-bin radii),
``object_center_m`` (each object's centroid to the nearest of the other
side's, both ways), ``memory_frames_differ``, the frames whose table
id or object names differ (a count, not a largest gap), ``cylinder_m``
(radius and axis point; inf where one side calls an object a cylinder
and the other a box) and ``cylinder_axis_rad`` of the objects both sides
call cylinders, and ``box_m`` (centre and extents) of those both call
boxes; objects are paired by the nearest centroid.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import scipy.spatial
import torch

from perfbench.references import plain

INF = float("inf")
# Ties, decided as the judged side decided them.  A voxel centroid differs
# by up to 4e-7 m between the program's float32 sums (in an order that
# atomic adds pick anew each run) and float64; a voxel that lies within
# GATE_TIE_M of a gate of the object search passes it as the judged side's
# voxel did.  A cylinder hypothesis whose MSAC score lies within CYL_TIE of
# the best (a share of the best) is taken where its axis is the nearest to
# the judged side's.  Rounding an object's voxel centroids to float32
# (3e-8 m) has put the float64 best 6.7e-5 of its score ahead of the
# program's pick, and float32 scores of the same hypotheses stray from
# float64 by 1.2e-4 of the best and more; CYL_TIE covers such ties.
GATE_TIE_M = 1e-5
CYL_TIE = 2e-4


# -- 1. box filter and denoise -------------------------------------------------
def denoise_keep(xyz: torch.Tensor, box, k: int, alpha: float):
    """(N,) keep mask over all rows, the rows inside the box, and (N,) each
    row's distance from the cut in standard deviations (inf outside the box).
    The box test is taken in float32, the precision the configuration
    states: a point at float32 1.6 lies on a face at 1.6, where float64
    would put it outside."""
    x32, box32 = xyz.float(), torch.tensor(box, dtype=torch.float32, device=xyz.device)
    live = ((x32 >= box32[:3]) & (x32 <= box32[3:])).all(1)
    pts = xyz[live]
    _, d2 = plain.knn(pts, pts, k, exclude_self=True)
    avg = d2.sqrt().mean(1)
    mean = avg.mean()
    std = torch.sqrt(torch.clamp_min((avg * avg).mean() - mean * mean, 0.0))
    keep = torch.zeros_like(live)
    keep[live] = (avg - mean).abs() < alpha * std
    margin = torch.full(live.shape, INF, dtype=xyz.dtype, device=xyz.device)
    margin[live] = ((avg - mean).abs() - alpha * std).abs() / std
    return keep, len(pts), margin


# -- 2. the table detector ------------------------------------------------------
def packed_key(cell: np.ndarray) -> np.ndarray:
    """(.., 3) int cell -> 30-bit key, 10 bits an axis (two's complement wrap)."""
    c = cell.astype(np.int64) & 1023
    return (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]


def voxel_centroids(p: torch.Tensor, leaf: float, capacity: int) -> torch.Tensor:
    """Per-voxel centroids, in ascending packed-key order.  The cell of a
    point is taken in float32, the precision the configuration states:
    the scene's box faces lie on cell boundaries, where float64 would put
    a whole face in the next cell."""
    leaf32 = torch.tensor(leaf, dtype=torch.float32, device=p.device)
    cell = torch.floor(p.float() / leaf32).cpu().numpy()
    keys, inv = np.unique(packed_key(cell), return_inverse=True)
    inv = torch.as_tensor(inv, device=p.device)
    n = min(len(keys), capacity)
    sums = torch.zeros((len(keys), 3), dtype=p.dtype, device=p.device).index_add_(0, inv, p)
    cnt = torch.zeros(len(keys), dtype=p.dtype, device=p.device).index_add_(0, inv, torch.ones_like(p[:, 0]))
    return (sums / cnt[:, None])[:n]


def components(n: int, src: np.ndarray, dst: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Label of each of ``rows``: the least row of its connected component
    over the undirected edges (src, dst); -1 elsewhere."""
    g = scipy.sparse.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    _, lab = scipy.sparse.csgraph.connected_components(g, directed=False)
    least = np.full(lab.max() + 1, n)
    np.minimum.at(least, lab[rows], rows)
    out = np.full(n, -1)
    out[rows] = least[lab[rows]]
    return out


def clusters(xyz: torch.Tensor, rows: np.ndarray, tol: float, k: int, top: int, min_size: int,
             nrm: torch.Tensor = None, cos_angle: float = None):
    """The ``top`` largest Euclidean clusters among ``rows`` (k-NN edges
    within ``tol``, and within the normal angle if given), equal sizes by
    ascending least row: a list of row arrays of at least ``min_size``."""
    n = len(xyz)
    if len(rows) < 2:
        return []
    sub = xyz[torch.as_tensor(rows, device=xyz.device)]
    idx, d2 = plain.knn(sub, sub, min(k, len(rows) - 1), exclude_self=True)
    ok = d2 <= tol * tol
    if nrm is not None:
        ns = nrm[torch.as_tensor(rows, device=xyz.device)]
        ok &= (ns[:, None, :] * ns[idx]).sum(-1).abs() >= cos_angle
    i, kk = np.nonzero(ok.cpu().numpy())
    lab = components(n, rows[i], rows[idx.cpu().numpy()[i, kk]], rows)
    roots, sizes = np.unique(lab[rows], return_counts=True)
    order = np.lexsort((roots, -sizes))[:top]
    return [np.nonzero(lab == roots[o])[0] for o in order if sizes[o] >= min_size]


def least_eigvec(cov: torch.Tensor) -> torch.Tensor:
    _, vec = np.linalg.eigh(cov.cpu().numpy())
    return torch.as_tensor(vec[..., 0], device=cov.device)


def plane_dist(xyz: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    return (plain.mm(xyz, plane[:3, None])[:, 0] + plane[3]).abs()


def ransac_plane(xyz: torch.Tensor, member: np.ndarray, u: np.ndarray, t: float):
    """Plane (4,) and inliers (M,) bool of one candidate, MSAC over the
    hypotheses drawn by ``u`` (H, 3), then two total-least-squares refits."""
    m = len(xyz)
    cdf = np.cumsum(member)
    idx = np.clip(np.searchsorted(cdf, u * cdf[-1], side="right"), 0, m - 1)
    idx = torch.as_tensor(idx, device=xyz.device)
    p0, p1, p2 = xyz[idx[:, 0]], xyz[idx[:, 1]], xyz[idx[:, 2]]
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    nl = n.norm(dim=1, keepdim=True)
    n = n / nl.clamp_min(1e-30)
    d = -(n * p0).sum(1)
    mem = torch.as_tensor(member, device=xyz.device)
    dist = (plain.mm(n, xyz.T) + d[:, None]).abs()
    score = torch.where(mem, t * t - torch.clamp_max(dist * dist, t * t), 0.0).sum(1) / (t * t)
    score = torch.where(nl[:, 0] < 1e-12, -1.0, score)
    b = int(torch.argmax(score))
    plane = torch.cat([n[b], d[b : b + 1]])
    for _ in range(2):
        inl = (plane_dist(xyz, plane) < t) & mem
        w = inl.to(xyz.dtype)[:, None]
        mean = (xyz * w).sum(0) / w.sum().clamp_min(3.0)
        dc = (xyz - mean) * w
        n2 = least_eigvec(plain.mm(dc.T, dc) / w.sum().clamp_min(3.0))
        n2 = n2 * torch.sign((n2 * plane[:3]).sum() + 1e-30)
        plane = torch.cat([n2, -(n2 * mean).sum()[None]])
    return plane, (plane_dist(xyz, plane) < t) & mem


def hull_bins(rel: torch.Tensor, bins: int) -> torch.Tensor:
    ang = torch.atan2(rel[:, 1], rel[:, 0])
    return torch.clamp(((ang + math.pi) / (2 * math.pi) * bins).long(), 0, bins - 1)


def detect(p: torch.Tensor, u: np.ndarray, c: dict, follow: np.ndarray = None) -> dict:
    """The detector on the kept points ``p`` (float rows): found, plane,
    hull centre and radii, the table's inlier xy, the objects' points and
    (m,) which voxels they hold.  ``follow``, the judged side's (m,)
    object voxels, decides the gates of the voxels that lie within
    ``GATE_TIE_M`` of one; ``gate_ties`` counts those where it differs."""
    p = p[(p[:, 2] >= c["table_min_height"]) & (p[:, 2] <= c["table_max_height"])]
    xyz = voxel_centroids(p, c["leaf_size"], c["down_capacity"])
    m = len(xyz)
    nrm = plain.normals(xyz, c["k_normals"])
    cos_eps = math.cos(c["eps_angle"])
    cand = np.nonzero((nrm[:, 2].abs() >= cos_eps).cpu().numpy())[0]
    tables = clusters(xyz, cand, c["clusters_growing_tolerance"], c["cluster_knn"],
                      c["max_table_candidates"], c["clusters_min_pts"], nrm,
                      math.cos(c["region_angle_threshold"]))
    best = (-2, None, None)
    for ci in range(c["max_table_candidates"]):
        member = np.zeros(m, bool)
        if ci < len(tables):
            member[tables[ci]] = True
        plane, inl = ransac_plane(xyz, member, u[ci], c["sac_distance_threshold"])
        count = int(inl.sum()) if float(plane[2].abs()) >= cos_eps else -1
        if count > best[0]:
            best = (count, plane, inl)
    count, plane, inl = best
    plane = plane * (1.0 if float(plane[2]) >= 0 else -1.0)
    out = {"found": count >= c["min_table_inliers"], "plane": plane.cpu().numpy()}
    if not out["found"]:
        return out
    t = xyz[inl]
    tmin, tmax = t.min(0).values, t.max(0).values
    center = t[:, :2].mean(0)
    rel = t[:, :2] - center
    radii = torch.zeros(c["hull_bins"], dtype=xyz.dtype, device=xyz.device)
    radii.scatter_reduce_(0, hull_bins(rel, c["hull_bins"]), rel.norm(dim=1), "amax")
    above = ((xyz[:, 0] > tmin[0]) & (xyz[:, 0] < tmax[0]) & (xyz[:, 1] > tmin[1])
             & (xyz[:, 1] < tmax[1]) & (xyz[:, 2] > tmax[2] + c["delta_z"]))
    proj = xyz - (plain.mm(xyz, plane[:3, None])[:, 0] + plane[3])[:, None] * plane[:3]
    prel = proj[:, :2] - center
    b = hull_bins(prel, c["hull_bins"])
    nb = c["hull_bins"]
    rad = torch.maximum(radii[b], torch.maximum(radii[(b + 1) % nb], radii[(b - 1) % nb]))
    above &= prel.norm(dim=1) <= rad
    above = above.cpu().numpy()
    out["gate_ties"] = 0
    if follow is not None and len(follow) == m:
        # each voxel's distance to the nearest gate: the table's bounds, the
        # height above it, the hull; within GATE_TIE_M the judged side decides
        margin = torch.stack([(xyz[:, 0] - tmin[0]).abs(), (xyz[:, 0] - tmax[0]).abs(),
                              (xyz[:, 1] - tmin[1]).abs(), (xyz[:, 1] - tmax[1]).abs(),
                              (xyz[:, 2] - tmax[2] - c["delta_z"]).abs(),
                              (prel.norm(dim=1) - rad).abs()], 1).min(1).values.cpu().numpy()
        tie = margin < GATE_TIE_M
        out["gate_ties"] = int(np.count_nonzero(above[tie] != follow[tie]))
        above[tie] = follow[tie]
    objs = clusters(xyz, np.nonzero(above)[0], c["object_cluster_tolerance"],
                    c["cluster_knn"], c["max_objects"], c["object_cluster_min_pts"])
    x = xyz.cpu().numpy()
    objs = [o for o in objs if x[o][:, 2].min() <= float(tmax[2]) + c["object_min_distance_from_table"]]
    members = np.zeros(m, bool)
    for o in objs:
        members[o] = True
    out.update(hull_center=center.cpu().numpy(), hull_radii=radii.cpu().numpy(),
               table_xy=x[inl.cpu().numpy()][:, :2], objects=[x[o] for o in objs], members=members)
    return out


# -- 3a. the object reconstruction ---------------------------------------------
MLS_RADIUS, MLS_K = 0.02, 16
CYL_HYPOTHESES, CYL_NORMAL_WEIGHT, CYL_MAX_RADIUS, CYL_SHARE = 512, 0.1, 0.5, 0.8
MIN_FIT_POINTS = 12


def mls(p: torch.Tensor):
    """Moving least squares over each point's ``MLS_K`` nearest (itself
    included), Gaussian weights exp(-d^2 / r^2): the weighted plane, its
    normal turned towards the sensor at the origin, an order-2 height
    polynomial over the tangent plane solved by LAPACK; the point moved
    onto the polynomial, the normal from its gradient."""
    idx, d2 = plain.knn(p, p, min(MLS_K, len(p)))
    nb, w = p[idx], torch.exp(-d2 / MLS_RADIUS**2)
    wsum = w.sum(1, keepdim=True).clamp_min(1e-12)
    mean = (nb * w[..., None]).sum(1) / wsum
    d = (nb - mean[:, None]) * w.sqrt()[..., None]
    n = least_eigvec(plain.mm(d.transpose(1, 2), d) / wsum[..., None])
    n = torch.where(((-p) * n).sum(1, keepdim=True) < 0, -n, n)
    plane_pt = p - ((p - mean) * n).sum(1, keepdim=True) * n
    ax = torch.zeros_like(n)
    ax[:, 0] = (n[:, 0].abs() < 0.9).to(p.dtype)
    ax[:, 1] = 1.0 - ax[:, 0]
    tu = torch.linalg.cross(n, ax)
    tu = tu / tu.norm(dim=1, keepdim=True)
    tv = torch.linalg.cross(n, tu)
    rel = nb - plane_pt[:, None]
    ui, vi, hi = ((rel * t[:, None]).sum(-1) for t in (tu, tv, n))
    basis = torch.stack([torch.ones_like(ui), ui, vi, ui * ui, ui * vi, vi * vi], -1)
    bw = basis * w[..., None]
    H = plain.mm(bw.transpose(1, 2), basis) + 1e-9 * torch.eye(6, dtype=p.dtype, device=p.device)
    g = plain.mm(bw.transpose(1, 2), hi[..., None])[..., 0]
    coef = torch.as_tensor(np.linalg.solve(H.cpu().numpy(), g.cpu().numpy()[..., None])[..., 0], device=p.device)
    new_n = n - coef[:, 1:2] * tu - coef[:, 2:3] * tv
    return plane_pt + coef[:, :1] * n, new_n / new_n.norm(dim=1, keepdim=True)


def axis_dist(x: torch.Tensor, point: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    rel = x - point
    return (rel - (rel * axis).sum(-1, keepdim=True) * axis).norm(dim=-1)


def cylinder_hypotheses(p: torch.Tensor, nrm: torch.Tensor, u: torch.Tensor, t: float):
    """The two-point hypotheses that ``u`` (H, 2) draws, each with its MSAC
    score: axis the cross product of the two normals, axis point the
    midpoint of the normal lines' common perpendicular, radius the first
    point's distance to it; a point's distance blends |distance to axis -
    radius| with radius x the angle of its normal to the radial direction
    (weight 0.1).  Returns (score (H,), -1 where degenerate; axis (H, 3);
    axis point (H, 3); radius (H,))."""
    n = len(p)
    # a uniform picks a row as float32 u x count does, the precision it is drawn in
    pick = (u.float() * torch.tensor(float(n), dtype=torch.float32, device=u.device)).floor()
    idx = pick.long().clamp(0, n - 1)
    p1, p2, n1, n2 = p[idx[:, 0]], p[idx[:, 1]], nrm[idx[:, 0]], nrm[idx[:, 1]]
    ax = torch.linalg.cross(n1, n2)
    axlen = ax.norm(dim=1, keepdim=True)
    ax = ax / axlen.clamp_min(1e-30)
    w0 = p1 - p2
    a, b, c = (n1 * n1).sum(1), (n1 * n2).sum(1), (n2 * n2).sum(1)
    d, e = (n1 * w0).sum(1), (n2 * w0).sum(1)
    den = a * c - b * b
    ok = den > 1e-12
    den = torch.where(ok, den, 1.0)
    sc, tc = torch.where(ok, (b * e - c * d) / den, 0.0), torch.where(ok, (a * e - b * d) / den, 0.0)
    apt = 0.5 * (p1 + sc[:, None] * n1 + p2 + tc[:, None] * n2)
    rad = axis_dist(p1, apt, ax)
    rel = p[None] - apt[:, None]
    perp = rel - (rel * ax[:, None]).sum(-1, keepdim=True) * ax[:, None]
    pd = perp.norm(dim=-1)
    cosang = ((perp / pd[..., None].clamp_min(1e-12)) * nrm[None]).sum(-1).abs().clamp(0.0, 1.0)
    dist = (1 - CYL_NORMAL_WEIGHT) * (pd - rad[:, None]).abs() + CYL_NORMAL_WEIGHT * rad[:, None] * torch.arccos(cosang)
    score = (t * t - torch.clamp_max(dist * dist, t * t)).sum(1) / (t * t)
    bad = (axlen[:, 0] < 1e-6) | (rad > CYL_MAX_RADIUS)
    return torch.where(bad, -1.0, score), ax, apt, rad


def cylinder(p: torch.Tensor, nrm: torch.Tensor, u: torch.Tensor, t: float, follow_axis=None):
    """MSAC over ``cylinder_hypotheses``, then two sweeps of the inliers'
    mean radius and centroid's projection onto the axis.  ``follow_axis``,
    the judged side's axis, picks among the hypotheses that score within
    ``CYL_TIE`` of the best.  Returns (point, axis, radius, inlier share,
    the pick's score short of the best, as a share of it)."""
    n = len(p)
    score, ax, apt, rad = cylinder_hypotheses(p, nrm, u, t)
    best = top = int(torch.argmax(score))
    if follow_axis is not None:
        fa = torch.as_tensor(np.asarray(follow_axis, np.float64), device=p.device).to(p.dtype)
        best = int(torch.argmax(torch.where(score >= score[top] * (1 - CYL_TIE), (ax @ fa).abs(), -1.0)))
    shortfall = float((score[top] - score[best]) / score[top])
    pt, axis, r = apt[best], ax[best], rad[best]
    for _ in range(2):
        dd = axis_dist(p, pt, axis)
        inl = ((dd - r).abs() < t).to(p.dtype)
        cnt = inl.sum().clamp_min(3.0)
        r = (dd * inl).sum() / cnt
        pt = pt + (((p * inl[:, None]).sum(0) / cnt - pt) * axis).sum() * axis
    share = float(((axis_dist(p, pt, axis) - r).abs() < t).sum()) / n
    return pt.cpu().numpy(), axis.cpu().numpy(), float(r), share, shortfall


def box_zup(p: torch.Tensor):
    """Gravity-aligned box: yaw from the principal axis of the xy
    covariance, bounds in that frame.  Returns (centre (3,), extents (3,))."""
    xy = p[:, :2] - p[:, :2].mean(0)
    cov = plain.mm(xy.T, xy) / len(p)
    th = 0.5 * torch.atan2(2 * cov[0, 1], cov[0, 0] - cov[1, 1])
    ct, st = torch.cos(th), torch.sin(th)
    axes = torch.zeros((3, 3), dtype=p.dtype, device=p.device)
    axes[0, 0], axes[0, 1], axes[1, 0], axes[1, 1], axes[2, 2] = ct, st, -st, ct, 1.0
    proj = plain.mm(p, axes.T)
    lo, hi = proj.min(0).values, proj.max(0).values
    return (0.5 * (lo + hi) @ axes).cpu().numpy(), (hi - lo).cpu().numpy()


def reconstruct(pts: np.ndarray, gen: torch.Generator, t: float, device, dtype, follow=None) -> dict:
    """One object: its type, cylinder (point, axis, radius) and box (centre,
    extents); too few points make a box with no fit (no draw).  ``follow``
    is the judged side's reconstruction of the object, whose cylinder axis
    decides a tie of hypotheses."""
    if len(pts) < MIN_FIT_POINTS:
        return {"type": "box", "cylinder": None, "box": None, "tie": 0.0}
    u = torch.rand((CYL_HYPOTHESES, 2), generator=gen, device=gen.device)
    p = torch.as_tensor(pts, device=device).to(dtype)
    q, nrm = mls(p)
    fa = follow["cylinder"]["axis"] if follow is not None and follow.get("cylinder") is not None else None
    pt, axis, r, share, tie = cylinder(q, nrm, u.to(device), t, fa)
    center, extents = box_zup(q)
    return {"type": "cylinder" if share > CYL_SHARE else "box",
            "cylinder": {"point": pt, "axis": axis, "radius": r},
            "box": {"center": center, "extents": extents}, "tie": tie}


# -- 3b. the table memory's matching and naming --------------------------------
def convex_hull(xy: np.ndarray) -> np.ndarray:
    """Counter-clockwise hull vertices (qhull)."""
    xy = np.unique(np.asarray(xy, np.float64), axis=0)
    if len(xy) < 3:
        return xy
    return xy[scipy.spatial.ConvexHull(xy).vertices]


def area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def clip(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of convex counter-clockwise polygons a and b."""
    out = list(a)
    for e0, e1 in zip(b, np.roll(b, -1, axis=0)):
        side = lambda p: (e1[0] - e0[0]) * (p[1] - e0[1]) - (e1[1] - e0[1]) * (p[0] - e0[0])  # noqa: E731
        src, out = out, []
        for cur, nxt in zip(src, src[1:] + src[:1]):
            sc, sn = side(cur), side(nxt)
            if sc >= 0:
                out.append(cur)
            if (sc >= 0) != (sn >= 0) and sc != sn:
                out.append(cur + (nxt - cur) * (sc / (sc - sn)))
        if not out:
            return np.zeros((0, 2))
    return np.asarray(out)


def inside(poly: np.ndarray, q: np.ndarray) -> bool:
    e = np.roll(poly, -1, axis=0) - poly
    return bool(np.all(e[:, 0] * (q[1] - poly[:, 1]) - e[:, 1] * (q[0] - poly[:, 0]) >= 0))


class Memory:
    def __init__(self, match_dist: float, sac_threshold: float):
        self.tables = []  # [polygon, height, names and centres of the last observation]
        self.next_id = 0
        self.match_dist, self.sac_threshold = match_dist, sac_threshold

    def update(self, table_xy: np.ndarray, height: float, objects, gen, device, dtype, follows=None):
        """(table id, [(name, reconstruction)] in the objects' order); the
        reconstruction draws from ``gen``, one object after another.
        ``follows``: the judged side's reconstruction of each object, or None."""
        poly = convex_hull(table_xy)
        center = poly.mean(0)
        tid = None
        for i, (old, _, _) in enumerate(self.tables):
            if len(old) > 2 and len(poly) > 2:
                cl = clip(old, poly)
                if len(cl) > 2 and (area(cl) / max(area(old), 1e-9) > 0.5
                                    or area(cl) / max(area(poly), 1e-9) > 0.5):
                    tid = i
                    break
            if len(old) > 2 and inside(old, center):
                tid = i
                break
        if tid is None:
            tid = len(self.tables)
            self.tables.append([poly, height, []])
        else:
            self.tables[tid][0] = convex_hull(np.vstack([self.tables[tid][0], poly]))
        prev, taken, named, fits = self.tables[tid][2], set(), [], []
        for i, pts in enumerate(objects):
            fits.append(reconstruct(pts, gen, self.sac_threshold, device, dtype,
                                    None if follows is None else follows[i]))
            c = pts.mean(0)
            cands = sorted((np.linalg.norm(c - pc), pn) for pn, pc in prev if pn not in taken)
            if cands and cands[0][0] < self.match_dist:
                name = cands[0][1]
                taken.add(name)
            else:
                name = f"object_{self.next_id}"
                self.next_id += 1
            named.append((name, c))
        self.tables[tid][2] = named
        return tid, [n for n, _ in named], fits


# -- the answers and their comparison ------------------------------------------
def replay(state: torch.Tensor, device) -> torch.Generator:
    """The benchmark's generator as it stood before the memory's update."""
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return gen


def nearest_fits(judged: dict, centers: np.ndarray):
    """The judged side's reconstruction of the object nearest each centre."""
    jc = np.asarray(judged.get("centers", np.zeros((0, 3))), np.float64)
    if not len(jc) or not len(centers):
        return None
    near = np.linalg.norm(centers[:, None, :] - jc[None, :, :], axis=2).argmin(1)
    return [judged["fits"][j] for j in near]


def reference_answers(cfg, ring, records, device, dtype=torch.float64, tf32=False, judged=None):
    """The reference's answer to every record's frame, in their order: its
    own denoise, and the detector and memory from the judged side's kept
    rows (``judged``: its answers, one a record), its ties decided as the
    judged side decided them; or, without ``judged``, from its own."""
    mem, out = Memory(cfg["memory"]["match_dist_m"], cfg["memory"]["sac_threshold"]), []
    dn, det_cfg = cfg["denoise"], cfg["detector"]
    denoised = {}  # ring frame -> its denoise: a function of the frame alone, taken once
    with plain.precision(tf32):
        for i, rec in enumerate(records):
            xyz = torch.as_tensor(ring["frames"][rec["j"]], device=device).to(dtype)
            if rec["j"] not in denoised:
                keep, live, margin = denoise_keep(xyz, cfg["box"], dn["k"], dn["alpha"])
                denoised[rec["j"]] = keep, {"keep": keep.cpu().numpy(), "live": live,
                                            "margin": margin.cpu().numpy()}
            keep, own = denoised[rec["j"]]
            ans = dict(own, found=False)
            j = judged[i] if judged is not None else {}
            rows = keep if not j else torch.as_tensor(j["keep"][: len(xyz)], device=device)
            if int(rows.sum()) >= dn["min_nr_pts"] and rec["u"] is not None:
                det = detect(xyz[rows], rec["u"].cpu().numpy().astype(np.float64), det_cfg,
                             j.get("members"))
                ans.update(det)
                if det["found"]:
                    centers = np.array([o.mean(0) for o in det["objects"]]).reshape(-1, 3)
                    ans["tid"], ans["names"], ans["fits"] = mem.update(
                        det["table_xy"], 0.0, det["objects"], replay(rec["gen_state"], device),
                        device, dtype, nearest_fits(j, centers) if j else None)
                    ans["centers"] = centers
            out.append(ans)
    return out


def program_answers(records):
    out = []
    for rec in records:
        ans = {"keep": rec["keep"].cpu().numpy(), "found": rec["det"] is not None}
        if rec["det"] is not None:
            d = rec["det"]
            kept = d.object_sizes.cpu().numpy() > 0
            live = rec["down"].mask.cpu().numpy()
            ans.update(members=(d.object_masks.cpu().numpy().any(0) & live)[live],
                       plane=d.plane.cpu().numpy(), hull_center=d.hull.center.cpu().numpy(),
                       hull_radii=d.hull.radii.cpu().numpy(), tid=rec["tid"], names=rec["names"],
                       centers=d.object_centers.cpu().numpy()[kept], fits=rec["fits"])
        out.append(ans)
    return out


def compare_fits(gaps: dict, g: dict, w: dict) -> None:
    """The objects' reconstructions, each of ``g``'s paired with the
    nearest of ``w``'s by centroid; a pair whose types differ reads inf in
    ``cylinder_m``."""
    gc, wc = np.asarray(g["centers"], np.float64), np.asarray(w["centers"], np.float64)
    if not len(gc) or not len(wc):
        return
    near = np.linalg.norm(gc[:, None, :] - wc[None, :, :], axis=2).argmin(1)
    for gf, wf in zip(g["fits"], (w["fits"][j] for j in near)):
        if gf["type"] != wf["type"]:
            gaps["cylinder_m"] = INF
        elif gf["type"] == "cylinder":
            a, b = gf["cylinder"], wf["cylinder"]
            n1, n2 = np.asarray(a["axis"], np.float64), np.asarray(b["axis"], np.float64)
            gaps["cylinder_axis_rad"] = max(gaps["cylinder_axis_rad"], math.atan2(
                np.linalg.norm(np.cross(n1, n2)), abs(float(n1 @ n2))))
            gaps["cylinder_m"] = max(gaps["cylinder_m"], abs(float(a["radius"]) - float(b["radius"])),
                                     float(np.linalg.norm(np.asarray(a["point"]) - b["point"])))
        elif gf["box"] is not None and wf["box"] is not None:
            a, b = gf["box"], wf["box"]
            gaps["box_m"] = max(gaps["box_m"], float(np.abs(np.asarray(a["center"]) - b["center"]).max()),
                                float(np.abs(np.asarray(a["extents"]) - b["extents"]).max()))


def compare(got, want) -> dict:
    """Each number over the frames: the largest gap (inf where one side
    found a table and the other did not), or a count."""
    gaps = dict(denoise_share_differ=0.0, denoise_cut_margin=0.0, plane_angle_rad=0.0,
                plane_offset_m=0.0, hull_radius_m=0.0, object_center_m=0.0,
                memory_frames_differ=0.0, cylinder_m=0.0,
                cylinder_axis_rad=0.0, box_m=0.0)
    up = lambda key, v: gaps.__setitem__(key, max(gaps[key], float(v)))  # noqa: E731
    for g, w in zip(got, want):
        wk = np.zeros(max(len(g["keep"]), len(w["keep"])), bool)  # rows past the frame: dead
        gk = wk.copy()
        wk[: len(w["keep"])], gk[: len(g["keep"])] = w["keep"], g["keep"]
        differ = gk != wk
        up("denoise_share_differ", np.count_nonzero(differ) / max(w["live"], 1))
        if differ.any():
            up("denoise_cut_margin", w["margin"][differ[: len(w["margin"])]].max())
        if g["found"] != w["found"]:
            for key in ("plane_angle_rad", "plane_offset_m", "hull_radius_m", "object_center_m",
                        "cylinder_m", "cylinder_axis_rad", "box_m"):
                up(key, INF)
            up("memory_frames_differ", 1)
            continue
        if not g["found"]:
            continue
        n1, n2 = np.asarray(g["plane"][:3], np.float64), np.asarray(w["plane"][:3], np.float64)
        up("plane_angle_rad", math.atan2(np.linalg.norm(np.cross(n1, n2)), float(n1 @ n2)))
        up("plane_offset_m", abs(float(g["plane"][3]) - float(w["plane"][3])))
        up("hull_radius_m", max(np.linalg.norm(g["hull_center"] - w["hull_center"]),
                                np.abs(g["hull_radii"] - w["hull_radii"]).max()))
        gc, wc = np.asarray(g["centers"], np.float64), np.asarray(w["centers"], np.float64)
        if len(gc) and len(wc):  # each centre to the nearest of the other side's, both ways
            d = np.linalg.norm(gc[:, None, :] - wc[None, :, :], axis=2)
            up("object_center_m", max(d.min(1).max(), d.min(0).max()))
        elif len(gc) or len(wc):
            up("object_center_m", INF)
        gaps["memory_frames_differ"] += float(g["tid"] != w["tid"] or g["names"] != w["names"])
        compare_fits(gaps, g, w)
    return gaps


def _numbers(traffic, records, warm, got, want):
    window = [i for i, r in enumerate(records) if r["k"] >= warm]
    gaps = compare([got[i] for i in window], [want[i] for i in window])
    return [{"name": n, "value": gaps[n] if window else INF, "limit": traffic["limits"][n]}
            for n in gaps]


def check(cfg, traffic, ring, records, warm, device):
    """The program judged: its denoise against the reference's own, and
    the stages after it against the reference run from the program's kept
    rows (one borderline row moves a voxel centroid, and with it the
    clusters downstream, so each stage is judged from the state the judged
    side reached), its ties decided as the judged side decided them.
    ``denoise_cut_margin`` holds the rows that differ to the cut's edge,
    so the two kept sets differ only where rounding can."""
    got = program_answers(records)
    want = reference_answers(cfg, ring, records, device, judged=got)
    return _numbers(traffic, records, warm, got, want)


def witness(cfg, traffic, ring, records, warm, device):
    """``check``'s numbers against the reference run wholly from its own
    kept rows: how far the program's answers lie from the reference's own
    chain (read by ``perfbench/control.py``, not by a run)."""
    return _numbers(traffic, records, warm, program_answers(records),
                    reference_answers(cfg, ring, records, device))


def control(cfg, traffic, ring, records, warm, device):
    """``check``'s numbers with the control in the program's place: the
    reference in float32 with TF32 matrix products, judged the same way."""
    got = reference_answers(cfg, ring, records, device, torch.float32, tf32=True)
    want = reference_answers(cfg, ring, records, device, judged=got)
    return _numbers(traffic, records, warm, got, want)
