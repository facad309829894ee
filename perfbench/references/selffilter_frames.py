"""Plain reference of the robot self-filter, frame by frame, and the comparison.

From the configuration, the ring's host arrays and the uniforms the
program drew (never anything else the program made), in float64 on the
device with host numpy where the work is small:

1. the robot: the URDF's links moved by forward kinematics (fixed,
   revolute, continuous and prismatic joints), box, cylinder (24 sides,
   open ends, as the node meshes a primitive) and STL links, every
   triangle rasterised by a barycentric z-buffer over the pixels of its
   block's bounding window, with perspective-correct depth; the scene
   generator renders the ring's frames with it, and its robot images
   serve the check;
2. once a ring frame: the cut (a pixel with a measurement nearer than the
   robot's surface + the margin is the robot's), the clamped smoothing
   (the 3 x 3 binomial blur as two banded matrix products), the
   unprojection, the image normals (neighbours across the image's edges
   wrap, as the node's), the mean shift of the normal image and the exact
   4-connected components of its "normals agree" graph (scipy), with the
   small ones dissolved;
3. each window frame's planes follow the judged side: round r starts from
   the judged side's live pixels before round r (its mask, less its
   labels below r), draws the same hypotheses from the same uniforms
   (the inverse CDF of the live pixels, in float32 as drawn), scores them
   in float64, and takes the judged side's pick where float32 rounding
   explains the gap to the best (``PLANE_TIE_M``), else its own best.

Numbers compared, each the largest over the window's frames:
``silhouette_share`` (pixels the robot covers on one side only, of all
pixels), ``render_rel`` (the robot's relative depth error, on pixels
both sides hit whose 3 x 3 neighbourhood shows one link geometry in the
reference's render),
``cut_share`` (pixels cut by one side only), ``smooth_rel`` (the smoothed
depth's relative error, on pixels valid on both sides with no cut
difference within the smoothing's reach), ``plane_count_differ`` (a
count), ``plane_angle_rad`` and ``plane_offset_m`` (each plane against the
reference's of the same round), ``plane_label_share`` (live pixels whose
plane differs, of the live pixels) and ``segment_share`` (pixels valid on
either side outside the segments that the two partitions pair as each
other's largest overlap, of those pixels).

The control, the reference in float32 with its matrix products in TF32
(``plain.precision``), renders, cuts, smooths, fits and segments on its
own and is judged as the program is.
"""
from __future__ import annotations

import math
import xml.etree.ElementTree as ET

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import torch

from perfbench.references import plain

INF = float("inf")
# A plane search's pick is followed where float32 rounding explains it: the
# gap between the float64 inlier counts of the judged side's pick and of
# the best is at most the live pixels that lie within PLANE_TIE_M of either
# hypothesis' band edge.  The program's float32 image normals tilt by up
# to ~5e-5 rad from the float64 ones (its planes' angles), which moves a
# pixel a metre from the hypothesis point ~5e-5 m across the band.
PLANE_TIE_M = 5e-5
_CHUNK_ELEMS = 1 << 22  # elements of one block of the rasteriser
_SCORE_ELEMS = 1 << 26  # elements of one block of the plane scores


# -- 1. the robot and the scene ------------------------------------------------------
def look_at(eye, target) -> np.ndarray:
    """World -> camera (x right, y down, z forward), the world's +z up."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    z = target - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, np.cross(z, x), z])
    T[:3, 3] = -T[:3, :3] @ eye
    return T


def camera_from_root(cfg) -> np.ndarray:
    x, y, z, yaw = cfg["robot"]["root_xyz_yaw"]
    root = np.eye(4)
    root[:3, :3] = [[math.cos(yaw), -math.sin(yaw), 0], [math.sin(yaw), math.cos(yaw), 0], [0, 0, 1]]
    root[:3, 3] = [x, y, z]
    return look_at(cfg["camera"]["eye_m"], cfg["camera"]["target_m"]) @ root


def finger_triangles(segments: int, rings: int) -> np.ndarray:
    """A gripper finger along +x: a tapered, slightly bent tube 0.09 m long
    with end caps, (2 segments (rings + 1), 3, 3) float32, as an STL holds it."""
    a = 2 * np.pi * np.arange(segments + 1) / segments
    s = np.linspace(0.0, 1.0, rings + 1)
    r, bend = 0.012 - 0.006 * s, 0.01 * s * s
    ring = np.stack([np.broadcast_to(0.09 * s[:, None], (rings + 1, segments + 1)),
                     r[:, None] * np.cos(a)[None] + bend[:, None], r[:, None] * np.sin(a)[None]], -1)
    tris = []
    for k in range(rings):
        for i in range(segments):
            tris += [[ring[k, i], ring[k, i + 1], ring[k + 1, i]], [ring[k, i + 1], ring[k + 1, i + 1], ring[k + 1, i]]]
    for k in (0, rings):
        centre = [0.09 * s[k], bend[k], 0.0]
        for i in range(segments):
            tris.append([centre, ring[k, i + 1], ring[k, i]])
    return np.asarray(tris, np.float32)


def mesh_files(cfg) -> dict:
    """The robot's mesh files: {path under the URDF's root: (T, 3, 3) float32}."""
    return {path: finger_triangles(*spec["finger"]) for path, spec in cfg["robot"]["meshes"].items()}


def box_mesh(center, size):
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float64)
    tris = [[0, 1, 3], [0, 3, 2], [4, 7, 5], [4, 6, 7], [0, 5, 1], [0, 4, 5],
            [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]]
    return np.asarray(center, np.float64) + corners * 0.5 * np.asarray(size, np.float64), np.asarray(tris)


def cylinder_mesh(base, radius: float, k_min: float, k_max: float, segments: int = 24):
    """An open tube along +z from base + k_min to base + k_max."""
    ang = 2.0 * np.pi * np.arange(segments) / segments
    ring = radius * np.stack([np.cos(ang), np.sin(ang), np.zeros(segments)], 1)
    base = np.asarray(base, np.float64)
    verts = np.vstack([base + [0, 0, k_min] + ring, base + [0, 0, k_max] + ring])
    j = (np.arange(segments) + 1) % segments
    i = np.arange(segments)
    tris = np.stack([np.stack([i, j, segments + i], 1), np.stack([j, segments + j, segments + i], 1)], 1)
    return verts, tris.reshape(-1, 3)


def _rpy(r, p, y) -> np.ndarray:
    cr, sr, cp, sp, cy, sy = math.cos(r), math.sin(r), math.cos(p), math.sin(p), math.cos(y), math.sin(y)
    return (np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]]) @ np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
            @ np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]]))


def _origin(el) -> np.ndarray:
    T = np.eye(4)
    if el is not None:
        T[:3, :3] = _rpy(*(float(v) for v in (el.get("rpy") or "0 0 0").split()))
        T[:3, 3] = [float(v) for v in (el.get("xyz") or "0 0 0").split()]
    return T


class Robot:
    """The URDF's links (collision geometry, else visual) as meshes in their
    link frames, and its joints."""

    def __init__(self, urdf: str, files: dict):
        root = ET.fromstring(urdf)
        self.parts = []  # (link, vertices (n, 3) float64 in the link frame, triangles (m, 3))
        for link in root.findall("link"):
            for tag in ("collision", "visual"):
                found = False
                for el in link.findall(tag):
                    geom = el.find("geometry")
                    if geom is None:
                        continue
                    v, t = self._geometry(geom, files)
                    T = _origin(el.find("origin"))
                    self.parts.append((link.get("name"), v @ T[:3, :3].T + T[:3, 3], t))
                    found = True
                if found:
                    break
        self.joints = []
        for j in root.findall("joint"):
            axis = j.find("axis")
            axis = np.array([float(v) for v in (axis.get("xyz") if axis is not None else "1 0 0").split()])
            self.joints.append((j.get("name"), j.get("type", "fixed"), j.find("parent").get("link"),
                                j.find("child").get("link"), _origin(j.find("origin")), axis))
        children = {j[3] for j in self.joints}
        self.root = next(link.get("name") for link in root.findall("link") if link.get("name") not in children)

    @staticmethod
    def _geometry(geom, files):
        if geom.find("box") is not None:
            return box_mesh(np.zeros(3), [float(v) for v in geom.find("box").get("size").split()])
        if geom.find("cylinder") is not None:
            c = geom.find("cylinder")
            length = float(c.get("length"))
            return cylinder_mesh(np.zeros(3), float(c.get("radius")), -length / 2, length / 2)
        m = geom.find("mesh")
        tris = files[m.get("filename").replace("package://", "")].astype(np.float64)
        scale = np.array([float(v) for v in (m.get("scale") or "1 1 1").split()])
        return tris.reshape(-1, 3) * scale, np.arange(3 * len(tris)).reshape(-1, 3)

    def poses(self, q: dict) -> dict:
        """Link -> (4, 4) pose in the root frame."""
        out, todo = {self.root: np.eye(4)}, list(self.joints)
        while todo:
            name, kind, parent, child, origin, axis = next(j for j in todo if j[2] in out)
            T = out[parent] @ origin
            J = np.eye(4)
            if kind in ("revolute", "continuous"):
                a = axis / np.linalg.norm(axis)
                K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
                t = float(q.get(name, 0.0))
                J[:3, :3] = np.eye(3) + math.sin(t) * K + (1 - math.cos(t)) * K @ K
            elif kind == "prismatic":
                J[:3, 3] = axis * float(q.get(name, 0.0))
            out[child] = T @ J
            todo.remove(next(j for j in todo if j[0] == name))
        return out

    def mesh(self, q: dict, cam_from_root: np.ndarray, dtype, device):
        """(vertices in the camera frame, triangles, each triangle's geometry
        number): every link moved by its pose (a matrix product)."""
        poses = self.poses(q)
        verts, tris, part, off = [], [], [], 0
        for k, (link, v, t) in enumerate(self.parts):
            T = torch.as_tensor(cam_from_root @ poses[link], dtype=dtype, device=device)
            vv = torch.as_tensor(v, dtype=dtype, device=device)
            verts.append(plain.mm(vv, T[:3, :3].T) + T[:3, 3])
            tris.append(t + off)
            part.append(np.full(len(t), k))
            off += len(v)
        return torch.cat(verts), np.concatenate(tris), np.concatenate(part)


def scene_mesh(cfg):
    """The static scene's (vertices in the world, triangles)."""
    g = cfg["scene_geometry"]
    parts = [box_mesh(b["center_m"], b["size_m"]) for b in g["boxes"]]
    parts += [cylinder_mesh(c["base_m"], c["radius_m"], 0.0, c["height_m"]) for c in g["cylinders"]]
    verts, tris, off = [], [], 0
    for v, t in parts:
        verts.append(v)
        tris.append(t + off)
        off += len(v)
    return np.concatenate(verts), np.concatenate(tris)


def rasterise(verts: torch.Tensor, tris: np.ndarray, part: np.ndarray, shape, f: float, z_near: float = 0.1):
    """Z-buffer of triangles seen from the origin (pinhole, focal ``f``,
    centre ((W - 1) / 2, (H - 1) / 2), pixel centres at whole coordinates):
    (depth (H, W) in ``verts``' dtype, 0 where nothing is seen; part (H, W)
    of the nearest triangle, -1 there).  A triangle with a vertex nearer
    than ``z_near`` or of no area is skipped; a pixel on an edge is inside."""
    h, w = shape
    dev, dt = verts.device, verts.dtype
    z = verts[:, 2]
    zc = torch.clamp_min(z, 1e-6)
    px, py = verts[:, 0] / zc * f + (w - 1) / 2.0, verts[:, 1] / zc * f + (h - 1) / 2.0
    tri = torch.as_tensor(tris, device=dev).long()
    live = (z[tri] > z_near).all(1).cpu().numpy()
    X, Y = px[tri].cpu().numpy(), py[tri].cpu().numpy()
    c0 = np.clip(np.floor(X.min(1)) - 1, 0, w).astype(int)
    c1 = np.clip(np.ceil(X.max(1)) + 2, 0, w).astype(int)
    r0 = np.clip(np.floor(Y.min(1)) - 1, 0, h).astype(int)
    r1 = np.clip(np.ceil(Y.max(1)) + 2, 0, h).astype(int)
    keep = np.flatnonzero(live & (c0 < c1) & (r0 < r1))
    zbuf = torch.full((h, w), INF, dtype=dt, device=dev)
    pbuf = torch.full((h, w), -1, dtype=torch.int64, device=dev)
    vv, uu = torch.meshgrid(torch.arange(h, dtype=dt, device=dev), torch.arange(w, dtype=dt, device=dev),
                            indexing="ij")
    part_t = torch.as_tensor(part, device=dev)
    s = 0
    while s < len(keep):  # blocks of consecutive triangles, as many as their window allows
        i = keep[s]
        ra, rb, ca, cb = r0[i], r1[i], c0[i], c1[i]
        e = s + 1
        while e < len(keep):
            i = keep[e]
            na, nb, nc, nd = min(ra, r0[i]), max(rb, r1[i]), min(ca, c0[i]), max(cb, c1[i])
            if (e + 1 - s) * (nb - na) * (nd - nc) > _CHUNK_ELEMS:
                break
            ra, rb, ca, cb = na, nb, nc, nd
            e += 1
        b = keep[s:e]
        s = e
        ids = tri[torch.as_tensor(b, device=dev)]
        x, y, zz = px[ids], py[ids], zc[ids]  # (C, 3)
        u, v = uu[ra:rb, ca:cb], vv[ra:rb, ca:cb]
        area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
        ok = area.abs() > 1e-9
        area = torch.where(ok, area, 1.0)[:, None, None]

        def edge(i, j):
            return ((x[:, j] - x[:, i])[:, None, None] * (v - y[:, i, None, None])
                    - (y[:, j] - y[:, i])[:, None, None] * (u - x[:, i, None, None])) / area

        b0, b1, b2 = edge(1, 2), edge(2, 0), edge(0, 1)
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & ok[:, None, None]
        inv_z = b0 / zz[:, 0, None, None] + b1 / zz[:, 1, None, None] + b2 / zz[:, 2, None, None]
        depth = torch.where(inside, 1.0 / torch.clamp_min(inv_z, 1e-9), INF)
        dmin, kmin = depth.min(0)
        closer = dmin < zbuf[ra:rb, ca:cb]
        zbuf[ra:rb, ca:cb] = torch.where(closer, dmin, zbuf[ra:rb, ca:cb])
        pbuf[ra:rb, ca:cb] = torch.where(closer, part_t[torch.as_tensor(b, device=dev)][kmin], pbuf[ra:rb, ca:cb])
    return torch.where(torch.isfinite(zbuf), zbuf, 0.0), pbuf


def render_robot(cfg, robot: Robot, q: dict, dtype, device):
    """The robot's (depth, part) images for joint state ``q``."""
    v, t, part = robot.mesh(q, camera_from_root(cfg), dtype, device)
    return rasterise(v, t, part, cfg["image_shape"], cfg["focal_px"])


def render_scene(cfg, dtype, device) -> torch.Tensor:
    v, t = scene_mesh(cfg)
    T = torch.as_tensor(look_at(cfg["camera"]["eye_m"], cfg["camera"]["target_m"]), dtype=dtype, device=device)
    vc = plain.mm(torch.as_tensor(v, dtype=dtype, device=device), T[:3, :3].T) + T[:3, 3]
    return rasterise(vc, t, np.zeros(len(t), int), cfg["image_shape"], cfg["focal_px"])[0]


def kinect_frame(cfg, robot: torch.Tensor, scene: torch.Tensor) -> np.ndarray:
    """What the Kinect reads: the nearer of robot and scene, its disparity
    rounded to the sensor's step; (H, W) float32 metres, 0 = no reading."""
    near = torch.where((robot > 0) & ((robot < scene) | (scene == 0)), robot, scene).double()
    bf, step = cfg["baseline_focal"], cfg["disparity_step_px"]
    disp = torch.round(bf / near.clamp_min(1e-6) / step) * step
    return torch.where(near > 0, bf / disp.clamp_min(1e-6), 0.0).float().cpu().numpy()


# -- 2. a ring frame's chain ---------------------------------------------------------
def _roll(x, dy, dx):
    """x[i + dy, j + dx], wrapping around the image."""
    return torch.roll(x, (-dy, -dx), dims=(0, 1))


def _band(n: int, dtype, device) -> torch.Tensor:
    """The (n, n) 1-2-1 band: the binomial blur along one axis, zero past the ends."""
    i = torch.arange(n, device=device)
    return ((i[:, None] == i[None, :]) * 2.0 + ((i[:, None] - i[None, :]).abs() == 1)).to(dtype)


def smooth(depth: torch.Tensor, iterations: int, tol: float, bf: float) -> torch.Tensor:
    """Clamped smoothing: each pixel stays within its own disparity +- tol
    (the node's 1 px);
    each pass takes the validity-weighted 3 x 3 binomial mean of the valid
    depths (the image's border padded with nothing)."""
    valid = depth > 0
    disp = torch.where(valid, bf / depth.clamp_min(1e-6), 0.0)
    to_depth = lambda d: torch.where(d > 0, bf / d.clamp_min(1e-6), 0.0)  # noqa: E731
    lo, hi = to_depth(disp + tol), to_depth((disp - tol).clamp_min(1e-3))
    bh, bw = _band(depth.shape[0], depth.dtype, depth.device), _band(depth.shape[1], depth.dtype, depth.device)
    blur = lambda x: plain.mm(plain.mm(bh, x), bw)  # noqa: E731
    wsum = blur(valid.to(depth.dtype)).clamp_min(1e-6)
    d = depth
    for _ in range(iterations):
        avg = blur(torch.where(valid, d, 0.0)) / wsum
        d = torch.where(valid, torch.minimum(torch.maximum(avg, lo), hi), d)
    return torch.where(valid, d, 0.0)


def unproject(depth: torch.Tensor, f: float) -> torch.Tensor:
    h, w = depth.shape
    v, u = torch.meshgrid(torch.arange(h, dtype=depth.dtype, device=depth.device),
                          torch.arange(w, dtype=depth.dtype, device=depth.device), indexing="ij")
    return torch.stack([(u - (w - 1) / 2) / f * depth, (v - (h - 1) / 2) / f * depth, depth], -1)


def image_normals(p: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Cross product of the two neighbour differences, unit, towards the camera."""
    n = torch.linalg.cross(_roll(p, 0, 1) - _roll(p, 0, -1), _roll(p, 1, 0) - _roll(p, -1, 0), dim=-1)
    ln = n.norm(dim=-1, keepdim=True)
    ok = valid & _roll(valid, 0, 1) & _roll(valid, 0, -1) & _roll(valid, 1, 0) & _roll(valid, -1, 0)
    n = torch.where((ok & (ln[..., 0] > 1e-12))[..., None], n / ln.clamp_min(1e-30), 0.0)
    return torch.where(n[..., 2:3] > 0, -n, n)


def mean_shift(n: torch.Tensor, valid: torch.Tensor, bandwidth: float, window: int = 2, iterations: int = 5):
    for _ in range(iterations):
        acc, wsum = torch.zeros_like(n), torch.zeros_like(n[..., 0])
        for dy in range(-window, window + 1):
            for dx in range(-window, window + 1):
                nb = _roll(n, dy, dx)
                wt = ((((nb - n) ** 2).sum(-1) < bandwidth**2) & _roll(valid, dy, dx) & valid).to(n.dtype)
                acc, wsum = acc + nb * wt[..., None], wsum + wt
        out = acc / wsum.clamp_min(1.0)[..., None]
        ln = out.norm(dim=-1, keepdim=True)
        n = torch.where(ln > 1e-9, out / ln.clamp_min(1e-30), n)
    return n


def segments(n: torch.Tensor, valid: torch.Tensor, bandwidth: float, min_size: int) -> np.ndarray:
    """(H·W,) the least pixel of each pixel's component of the "normals
    agree" graph (4 neighbours, no wrap), H·W outside valid components of
    at least ``min_size`` pixels."""
    h, w = valid.shape
    right = ((((n[:, 1:] - n[:, :-1]) ** 2).sum(-1) < bandwidth**2) & valid[:, 1:] & valid[:, :-1]).cpu().numpy()
    down = ((((n[1:] - n[:-1]) ** 2).sum(-1) < bandwidth**2) & valid[1:] & valid[:-1]).cpu().numpy()
    idx = np.arange(h * w).reshape(h, w)
    a = np.concatenate([idx[:, :-1][right], idx[:-1][down]])
    b = np.concatenate([idx[:, 1:][right], idx[1:][down]])
    g = scipy.sparse.coo_matrix((np.ones(len(a)), (a, b)), shape=(h * w, h * w))
    _, comp = scipy.sparse.csgraph.connected_components(g, directed=False)
    least = np.full(comp.max() + 1, h * w)
    np.minimum.at(least, comp, np.arange(h * w))
    ok = valid.reshape(-1).cpu().numpy()
    size = np.bincount(comp[ok], minlength=len(least))
    return np.where(ok & (size[comp] >= min_size), least[comp], h * w)


def chain(cfg, ring, j: int, dtype, device, robot: torch.Tensor, part: torch.Tensor) -> dict:
    """Ring frame j's cut, smoothing, points, normals, live mask (a valid
    pixel with a unit normal) and segments given the robot's render."""
    s = cfg["filter"]
    meas = torch.as_tensor(ring["frames"][j], device=device).to(dtype)
    keep = ~((robot > 0) & (meas > 0) & (meas < robot + s["margin_m"]))
    depth = smooth(torch.where(keep, meas, 0.0), s["smooth_iterations"], 1.0, cfg["baseline_focal"])
    p = unproject(depth, cfg["focal_px"])
    n = image_normals(p, depth > 0)
    mask = (depth > 0) & (n.norm(dim=-1) > 0.5)
    seg = segments(mean_shift(n, mask, s["range_bandwidth"]), mask, s["range_bandwidth"], s["min_segment_px"])
    return {"robot": robot, "part": part, "keep": keep, "depth": depth, "xyz": p.reshape(-1, 3),
            "normals": n.reshape(-1, 3), "mask": mask.reshape(-1), "segments": seg}


# -- 3. the planes ---------------------------------------------------------------------
def sample(live: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Rows drawn from the live ones by the inverse CDF, as the uniforms
    were drawn: the floor(u·count)-th live row in float32 (the last row
    where that is the count)."""
    rows = np.flatnonzero(live)
    k = np.floor(u.astype(np.float32) * np.float32(len(rows))).astype(np.int64)
    return np.where(k < len(rows), rows[np.minimum(k, max(len(rows) - 1, 0))], len(live) - 1)


def distances(xyz, nh, d) -> torch.Tensor:
    """(N, H) |n·p + d| of every row to every hypothesis plane."""
    return (plain.mm(xyz, nh.T) + d[None, :]).abs()


def scores(xyz, live, nh, d, thr) -> torch.Tensor:
    """Each hypothesis' inlier count among the live rows (0 for a zero normal)."""
    rows = max(1, _SCORE_ELEMS // max(nh.shape[0], 1))
    total = torch.zeros(nh.shape[0], dtype=xyz.dtype, device=xyz.device)
    for s in range(0, xyz.shape[0], rows):
        total += ((distances(xyz[s : s + rows], nh, d) < thr) & live[s : s + rows, None]).sum(0)
    return torch.where(nh.norm(dim=1) > 1e-6, total, 0.0)


def covered(live: np.ndarray, total: int, share: float) -> bool:
    """Whether the planes explain ``share`` of the pixels, tested in float32
    as the configuration states (a share within float32 rounding of the
    limit would otherwise stop one side only)."""
    f = np.float32
    return bool(f(1.0) - f(live.sum()) / f(total) >= f(share))


def hypotheses(c: dict, live: np.ndarray, u: np.ndarray):
    idx = sample(live, u)
    it = torch.as_tensor(idx, device=c["xyz"].device)
    nh = c["normals"][it]
    return idx, nh, -(nh * c["xyz"][it]).sum(1)


def planes_own(c: dict, u: np.ndarray, s: dict) -> dict:
    """The multi-plane search on a chain's own points: planes (P, 4), labels,
    count and each plane's seed row, as the node keeps them."""
    mask = c["mask"].cpu().numpy()
    live, total = mask.copy(), max(mask.sum(), 1)
    labels = np.full(len(mask), -1)
    planes, seeds = np.zeros((s["max_planes"], 4)), np.full(s["max_planes"], -1)
    count = 0
    for _ in range(s["max_planes"]):
        idx, nh, d = hypotheses(c, live, u[count])
        sc = scores(c["xyz"], torch.as_tensor(live, device=nh.device), nh, d, s["plane_threshold_m"])
        best = int(torch.argmax(sc))
        if not sc[best] > 0:
            break
        inl = ((distances(c["xyz"], nh[best : best + 1], d[best : best + 1])[:, 0] < s["plane_threshold_m"])
               .cpu().numpy() & live)
        labels[inl] = count
        planes[count] = np.r_[nh[best].cpu().numpy(), float(d[best])]
        seeds[count] = idx[best]
        live &= ~inl
        count += 1
        if covered(live, total, s["min_coverage"]):
            break
    return {"planes": planes, "labels": labels, "count": count, "seeds": seeds}


def planes_follow(c: dict, judged: dict, u: np.ndarray, s: dict) -> dict:
    """The search in float64 on ``c``'s points, round by round from the
    judged side's live pixels, its pick followed where rounding explains
    it.  Returns the reference's planes, labels and count."""
    mask, jl = judged["mask"], judged["labels"]
    total, thr = max(mask.sum(), 1), s["plane_threshold_m"]
    labels = np.full(len(mask), -1)
    planes = np.zeros((s["max_planes"], 4))
    count = 0
    for r in range(s["max_planes"]):
        live = mask & ~((jl >= 0) & (jl < r))
        idx, nh, d = hypotheses(c, live, u[r])
        live_t = torch.as_tensor(live, device=nh.device)
        sc = scores(c["xyz"], live_t, nh, d, thr)
        pick = int(torch.argmax(sc))
        if not sc[pick] > 0:
            break
        if r < judged["count"]:
            theirs = np.flatnonzero(idx == judged["seeds"][r])
            if len(theirs):
                h = int(theirs[0])
                both = distances(c["xyz"], nh[[pick, h]], d[[pick, h]])
                border = int((((both - thr).abs() < PLANE_TIE_M) & live_t[:, None]).sum())
                if float(sc[pick] - sc[h]) <= border:
                    pick = h
        inl = (distances(c["xyz"], nh[pick : pick + 1], d[pick : pick + 1])[:, 0] < thr).cpu().numpy() & live
        labels[inl & (labels < 0)] = r
        planes[r] = np.r_[nh[pick].cpu().numpy(), float(d[pick])]
        count += 1
        if r >= judged["count"]:  # a plane more than the judged side found: the counts differ
            break
        if covered(mask & ~((jl >= 0) & (jl <= r)), total, s["min_coverage"]):
            break
    return {"planes": planes, "labels": labels, "count": count}


# -- 4. judging ----------------------------------------------------------------------------
def program_answers(rec) -> dict:
    """A program record's answers on the host."""
    out = rec["out"]
    return {"j": rec["j"], "u": out.uniforms.cpu().numpy(), "robot": out.robot_depth.cpu().numpy(),
            "keep": rec["keep"], "depth": out.depth.cpu().numpy(), "mask": out.mask.reshape(-1).cpu().numpy(),
            "planes": rec["planes"], "labels": rec["labels"], "count": rec["count"],
            "seeds": out.plane_seeds.cpu().numpy(), "segments": rec["segments"].reshape(-1)}


def _answers(c: dict, u: np.ndarray, s: dict, judged: dict = None) -> dict:
    if "host" not in c:  # a ring frame's images, read once
        c["host"] = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v) for k, v in c.items()
                     if k not in ("xyz", "normals")}
    host = c["host"]
    planes = planes_own(c, u, s) if judged is None else planes_follow(c, judged, u, s)
    return dict(host, **planes, u=u)


def _chains(cfg, ring, js, dtype, device, tf32):
    """Each ring frame's chain: in float64 from the ring's own robot
    renders, else rendered anew in ``dtype``."""
    out = {}
    with plain.precision(tf32):
        robot = None if dtype == torch.float64 else Robot("\n".join(cfg["robot"]["urdf"]), mesh_files(cfg))
        for j in sorted(set(js)):
            if robot is None:
                rd = torch.as_tensor(ring["robot_depth"][j], device=device)
                rp = torch.as_tensor(ring["robot_part"][j], device=device)
            else:
                rd, rp = render_robot(cfg, robot, ring["joints"][j], dtype, device)
            out[j] = chain(cfg, ring, j, dtype, device, rd, rp)
    return out


def reference_answers(cfg, ring, got, device, judged=None) -> list:
    """The float64 reference of each window frame, its planes following
    ``judged`` (a list parallel to ``got``) where given."""
    chains = _chains(cfg, ring, [g["j"] for g in got], torch.float64, device, False)
    return [_answers(chains[g["j"]], g["u"], cfg["filter"], judged[i] if judged else None)
            for i, g in enumerate(got)]


def _dilate(x: np.ndarray, r: int) -> np.ndarray:
    t = torch.as_tensor(x, dtype=torch.float32)[None, None]
    return torch.nn.functional.max_pool2d(t, 2 * r + 1, 1, r)[0, 0].numpy() > 0


def _same_around(p: np.ndarray) -> np.ndarray:
    """Pixels whose 3 x 3 neighbourhood (clipped at the border) all carry p's value."""
    h, w = p.shape
    pad = np.pad(p, 1, mode="edge")
    ok = np.ones(p.shape, bool)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            ok &= pad[dy : dy + h, dx : dx + w] == p
    return ok


def partition_differ(a: np.ndarray, b: np.ndarray, on: np.ndarray) -> float:
    """Share of the ``on`` pixels outside the pairs of segments (a's, b's)
    that are each other's largest overlap."""
    if not on.any():
        return 0.0
    pa, pb = a[on].astype(np.int64), b[on].astype(np.int64)
    base = max(int(pa.max()), int(pb.max())) + 1
    key, n = np.unique(pa * base + pb, return_counts=True)
    x, y = key // base, key % base
    best_a, best_b = {}, {}  # each segment's largest overlap on the other side
    for xi, yi, c in zip(x.tolist(), y.tolist(), n.tolist()):
        if c > best_a.get(xi, (0, -1))[0]:
            best_a[xi] = (c, yi)
        if c > best_b.get(yi, (0, -1))[0]:
            best_b[yi] = (c, xi)
    agree = sum(c for xi, yi, c in zip(x.tolist(), y.tolist(), n.tolist())
                if best_a[xi][1] == yi and best_b[yi][1] == xi)
    return 1.0 - agree / int(on.sum())


def _angle(n1, n2) -> float:
    n1, n2 = n1 / np.linalg.norm(n1), n2 / np.linalg.norm(n2)
    return math.atan2(float(np.linalg.norm(np.cross(n1, n2))), float(n1 @ n2))


def image_numbers(cfg, g: dict, w: dict) -> dict:
    """The render's, cut's, smoothing's and segments' numbers of one frame."""
    out = {}
    gr, wr = np.asarray(g["robot"], np.float64), w["robot"]
    out["silhouette_share"] = np.mean((gr > 0) != (wr > 0))
    inner = (gr > 0) & (wr > 0) & _same_around(w["part"])
    out["render_rel"] = np.max(np.abs(gr[inner] - wr[inner]) / wr[inner]) if inner.any() else 0.0
    cut_differ = g["keep"] != w["keep"]
    out["cut_share"] = np.mean(cut_differ)
    gd, wd = np.asarray(g["depth"], np.float64), w["depth"]
    both = (gd > 0) & (wd > 0) & ~_dilate(cut_differ, cfg["filter"]["smooth_iterations"])
    out["smooth_rel"] = np.max(np.abs(gd[both] - wd[both]) / wd[both]) if both.any() else 0.0
    out["segment_share"] = partition_differ(np.asarray(g["segments"]), w["segments"], g["mask"] | w["mask"])
    return out


def compare(cfg, got, want) -> dict:
    gaps = dict(silhouette_share=0.0, render_rel=0.0, cut_share=0.0, smooth_rel=0.0, plane_count_differ=0.0,
                plane_angle_rad=0.0, plane_offset_m=0.0, plane_label_share=0.0, segment_share=0.0)
    up = lambda key, v: gaps.__setitem__(key, max(gaps[key], float(v)))  # noqa: E731
    seen = {}  # ring frame -> the judged side's images at a visit, and their numbers
    for g, w in zip(got, want):
        images = [g[k] for k in ("robot", "keep", "depth", "mask", "segments")]
        last = seen.get(g["j"])
        if last is None or not all(np.array_equal(a, b) for a, b in zip(last[0], images)):
            last = seen[g["j"]] = (images, image_numbers(cfg, g, w))  # the reference's side is the ring frame's
        for key, v in last[1].items():
            up(key, v)
        up("plane_count_differ", abs(int(g["count"]) - int(w["count"])))
        for r in range(min(int(g["count"]), int(w["count"]))):
            gp, wp = np.asarray(g["planes"][r], np.float64), np.asarray(w["planes"][r], np.float64)
            up("plane_angle_rad", _angle(gp[:3], wp[:3]))
            up("plane_offset_m", abs(gp[3] - wp[3]))
        live = g["mask"]
        if live.any():
            up("plane_label_share", np.mean(np.asarray(g["labels"])[live] != w["labels"][live]))
    return gaps


def _numbers(cfg, traffic, got, want):
    gaps = compare(cfg, got, want)
    return [{"name": n, "value": gaps[n] if got else INF, "limit": traffic["limits"][n]} for n in gaps]


def check(cfg, traffic, ring, records, warm, device):
    """The program's window frames judged (see the module's docstring)."""
    got = [program_answers(r) for r in records if r["k"] >= warm]
    return _numbers(cfg, traffic, got, reference_answers(cfg, ring, got, device, judged=got))


def control(cfg, traffic, ring, records, warm, device):
    """``check``'s numbers with the control in the program's place: the
    reference in float32 with TF32 matrix products, on the program's
    uniforms."""
    window = [r for r in records if r["k"] >= warm]
    chains = _chains(cfg, ring, [r["j"] for r in window], torch.float32, device, True)
    with plain.precision(True):
        got = [dict(_answers(chains[r["j"]], r["out"].uniforms.cpu().numpy(), cfg["filter"]), j=r["j"])
               for r in window]
    return _numbers(cfg, traffic, got, reference_answers(cfg, ring, got, device, judged=got))
