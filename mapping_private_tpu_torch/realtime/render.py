"""Mesh rasterisation and ray/box casting: the robot self-filter's renderer.

Counterpart of ``mapping_private_tpu/realtime/render.py`` (the reference's
OpenGL FBO pass, realtime_perception src/urdf_renderer.cpp:67-135, and the
attic ``boxlist_ray_intersection.cu``).  A barycentric rasteriser with no
scanlines: the triangles go in blocks of ``chunk``, every pixel is tested
against every triangle of a block in one broadcast of (chunk, H, W) edge
functions, and the running minimum over the blocks is the z-buffer.
Padding triangles of the last block are masked exactly as in the JAX
package.  Each block works only over the pixel window its triangles can
cover (one host read of every block's window a call), which gives the
full broadcast's image.  A depth image is the least depth over all
blocks, whatever their order, so ``render_depth_mesh`` evaluates blocks
of like window size together, a few launches for all of them; the
intensity image keeps the JAX ``lax.scan``'s block order as a Python
loop, since its ties go to the earlier block.

Ties go as in the JAX package: within a block the first least depth wins
(``argmin``), across blocks the earlier block keeps a tie (strict ``<``).
A pixel exactly on an edge shared by two triangles passes ``w >= 0`` for
both; the minimum makes that harmless for depth, not for intensity.
Divisions by a constant divide by an f32 tensor of it (see
``realtime/depth.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_BATCH_ELEMS = 1 << 25  # (blocks, triangles, rows, columns) elements of one batched pass of the depth raster


def _chunk_windows(px, py, ok, h, w):
    """Each block's pixel window (r0, r1, c0, c1) on the host: the rows
    and columns within 1 px of its live triangles' projected vertices,
    clipped to the image; None for a block with none in view."""
    big = torch.finfo(torch.float32).max
    okv = ok[:, :, None]
    lo_x = torch.where(okv, px, big).amin(dim=(1, 2))
    hi_x = torch.where(okv, px, -big).amax(dim=(1, 2))
    lo_y = torch.where(okv, py, big).amin(dim=(1, 2))
    hi_y = torch.where(okv, py, -big).amax(dim=(1, 2))
    out = []
    for x0, x1, y0, y1 in torch.stack([lo_x, hi_x, lo_y, hi_y], 1).double().cpu().tolist():
        c0, c1 = max(math.floor(x0) - 1, 0), min(math.ceil(x1) + 2, w)
        r0, r1 = max(math.floor(y0) - 1, 0), min(math.ceil(y1) + 2, h)
        out.append((r0, r1, c0, c1) if r0 < r1 and c0 < c1 else None)
    return out


def _edge(ax, ay, bx, by, uu, vv):
    """(..., C, h, w) edge functions of the C edges a → b over the pixel grid."""
    return ((bx - ax)[..., None, None] * (vv - ay[..., None, None])
            - (by - ay)[..., None, None] * (uu - ax[..., None, None]))


def _prepare(vertices, triangles, image_shape, fx, fy, cx, cy, pose, chunk, z_near):
    """The raster's inputs: blocked triangles (B, C, 3), their live mask
    (B, C), each vertex's projection (px, py) and clamped depth, and each
    block's pixel window (``_chunk_windows``)."""
    h, w = image_shape
    cx = (w - 1) / 2.0 if cx is None else cx
    cy = (h - 1) / 2.0 if cy is None else cy
    v = torch.as_tensor(vertices, dtype=torch.float32)
    dev = v.device
    if pose is not None:
        pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        v = v @ pose[:3, :3].T + pose[:3, 3]
    tri = torch.as_tensor(triangles, device=dev).long()
    t_total = tri.shape[0]
    pad = (-t_total) % chunk
    if pad:
        tri = torch.cat([tri, torch.zeros((pad, 3), dtype=tri.dtype, device=dev)])
    tri_valid = (torch.arange(tri.shape[0], device=dev) < t_total).reshape(-1, chunk)
    tri = tri.reshape(-1, chunk, 3)
    # project every vertex once: the same elementwise operations the JAX
    # package applies to each block's gathered vertices
    zc_v = torch.clamp_min(v[:, 2], 1e-6)
    px_v = v[:, 0] / zc_v * fx + cx
    py_v = v[:, 1] / zc_v * fy + cy
    z_all = v[:, 2][tri]  # (B, C, 3)
    live = torch.all(z_all > z_near, dim=-1) & tri_valid
    return tri, live, px_v, py_v, zc_v, _chunk_windows(px_v[tri], py_v[tri], live, h, w)


def _block_depth(px, py, zc, in_front, uu, vv, z_far):
    """(..., C, h, w) depth of each of a block's C triangles over a pixel
    grid (``uu``, ``vv`` broadcast against (..., C, h, w)), ``z_far`` where a
    triangle does not cover the pixel; and the barycentrics.  px, py, zc:
    (..., C, 3) projected vertices and their clamped depths."""
    x0, x1, x2 = px.unbind(-1)
    y0, y1, y2 = py.unbind(-1)
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    nz_area = torch.abs(area) > 1e-9
    area_s = torch.where(nz_area, area, 1.0)[..., None, None]
    w0 = _edge(x1, y1, x2, y2, uu, vv) / area_s
    w1 = _edge(x2, y2, x0, y0, uu, vv) / area_s
    w2 = _edge(x0, y0, x1, y1, uu, vv) / area_s
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (nz_area & in_front)[..., None, None]
    # perspective-correct depth: 1/z interpolated with the barycentrics
    inv_z = w0 / zc[..., 0, None, None] + w1 / zc[..., 1, None, None] + w2 / zc[..., 2, None, None]
    return torch.where(inside, torch.reciprocal(torch.clamp_min(inv_z, 1e-9)), z_far), (w0, w1, w2)


def _raster_depth(vertices, triangles, image_shape, fx, fy, cx, cy, pose, chunk, z_near, z_far):
    """The z-buffer of ``_raster_mesh``, bit for bit, with the blocks
    batched: each block's window is widened to a power of two a side (kept
    inside the image: a pixel outside a block's window is outside its
    triangles, so a wider one changes nothing), blocks of one padded size
    are evaluated together, ``_BATCH_ELEMS`` elements at a time, and their
    least depths are folded into the z-buffer by a scatter-min."""
    h, w = image_shape
    tri, live, px_v, py_v, zc_v, windows = _prepare(vertices, triangles, image_shape, fx, fy, cx, cy, pose,
                                                    chunk, z_near)
    dev = px_v.device
    groups = {}
    for b, win in enumerate(windows):
        if win is None:
            continue
        r0, r1, c0, c1 = win
        wh, ww = min(1 << (r1 - r0 - 1).bit_length(), h), min(1 << (c1 - c0 - 1).bit_length(), w)
        groups.setdefault((wh, ww), []).append((b, min(r0, h - wh), min(c0, w - ww)))
    zbuf = torch.full((h * w,), z_far, dtype=torch.float32, device=dev)
    for (wh, ww), items in groups.items():
        step = max(1, _BATCH_ELEMS // (chunk * wh * ww))
        for s in range(0, len(items), step):
            b, r0, c0 = torch.tensor(items[s : s + step], device=dev).unbind(1)
            rows = r0[:, None] + torch.arange(wh, device=dev)  # (n, wh) image rows of each window
            cols = c0[:, None] + torch.arange(ww, device=dev)
            ids = tri[b]  # (n, C, 3)
            depth, _ = _block_depth(px_v[ids], py_v[ids], zc_v[ids], live[b],
                                    cols.float()[:, None, None, :], rows.float()[:, None, :, None], z_far)
            pix = (rows[:, :, None] * w + cols[:, None, :]).reshape(-1)
            zbuf.scatter_reduce_(0, pix, torch.min(depth, dim=1).values.reshape(-1), "amin")
    return zbuf.reshape(h, w)


def _raster_mesh(vertices, triangles, image_shape, fx, fy, cx, cy, pose, chunk, z_near, z_far,
                 intensities=None):
    """Shared chunked raster core, block by block in the JAX package's
    order: (zbuf, ibuf), ibuf None without ``intensities``.  Runs on
    ``vertices``' device.

    A block's edge functions are evaluated only over its pixel window
    (``_chunk_windows``): a pixel a pixel or more outside a triangle's
    bounding box has a clearly negative edge function, so it is outside
    the triangle in the JAX package's full-image broadcast too, and a
    pixel inside the window sees the same arithmetic as there."""
    h, w = image_shape
    tri, live, px_v, py_v, zc_v, windows = _prepare(vertices, triangles, image_shape, fx, fy, cx, cy, pose,
                                                    chunk, z_near)
    dev = px_v.device
    inten = None if intensities is None else torch.as_tensor(intensities, dtype=torch.float32, device=dev)
    vv_full, uu_full = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                      torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    zbuf = torch.full((h, w), z_far, dtype=torch.float32, device=dev)
    ibuf = None if inten is None else torch.zeros((h, w), dtype=torch.float32, device=dev)
    for b, win in enumerate(windows):
        if win is None:
            continue
        r0, r1, c0, c1 = win
        ids = tri[b]
        depth, (w0, w1, w2) = _block_depth(px_v[ids], py_v[ids], zc_v[ids], live[b], uu_full[r0:r1, c0:c1],
                                           vv_full[r0:r1, c0:c1], z_far)
        zwin = zbuf[r0:r1, c0:c1]
        if ibuf is None:
            zbuf[r0:r1, c0:c1] = torch.minimum(zwin, torch.min(depth, dim=0).values)
            continue
        # screen-space Gouraud of the nearest triangle's vertex values
        iv = inten[ids]  # (C, 3)
        gouraud = w0 * iv[:, 0, None, None] + w1 * iv[:, 1, None, None] + w2 * iv[:, 2, None, None]
        kmin = torch.argmin(depth, dim=0, keepdim=True)  # the first least depth
        dmin = torch.gather(depth, 0, kmin)[0]
        imin = torch.gather(gouraud, 0, kmin)[0]
        closer = dmin < zwin
        ibuf[r0:r1, c0:c1] = torch.where(closer, imin, ibuf[r0:r1, c0:c1])
        zbuf[r0:r1, c0:c1] = torch.where(closer, dmin, zwin)
    return zbuf, ibuf


def render_depth_mesh(
    vertices: torch.Tensor,
    triangles: torch.Tensor,
    image_shape: Tuple[int, int],
    fx: float = 580.0,
    fy: float = 580.0,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    pose: Optional[torch.Tensor] = None,
    chunk: int = 64,
    z_near: float = 0.1,
    z_far: float = 100.0,
) -> torch.Tensor:
    """Rasterise a triangle mesh into an (H, W) metric depth image on
    ``vertices``' device.

    vertices: (V, 3) model frame; triangles: (T, 3) vertex indices; pose:
    optional (4, 4) model → camera transform; chunk: triangles a block.
    Returns (H, W) depth in metres, 0 where nothing was hit."""
    zbuf = _raster_depth(vertices, triangles, image_shape, fx, fy, cx, cy, pose, chunk, z_near, z_far)
    return torch.where(zbuf < z_far, zbuf, 0.0)


def render_intensity_mesh(
    vertices: torch.Tensor,
    triangles: torch.Tensor,
    intensities: torch.Tensor,
    image_shape: Tuple[int, int],
    fx: float = 580.0,
    fy: float = 580.0,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    pose: Optional[torch.Tensor] = None,
    chunk: int = 64,
    z_near: float = 0.1,
    z_far: float = 100.0,
    background: float = 0.0,
) -> torch.Tensor:
    """Rasterise per-vertex intensities into an (H, W) image (the render
    half of the cloud_tools mesh viewer's image dump, me.cpp:227-259):
    the same z-buffer, carrying the screen-space (Gouraud) interpolation
    of the nearest triangle's vertex values."""
    zbuf, ibuf = _raster_mesh(vertices, triangles, image_shape, fx, fy, cx, cy, pose, chunk, z_near, z_far,
                              intensities=intensities)
    return torch.where(zbuf < z_far, ibuf, background)


def ray_box_tmin(
    origin: torch.Tensor,
    dirs: torch.Tensor,
    box_min: torch.Tensor,
    box_max: torch.Tensor,
) -> torch.Tensor:
    """(R, B) slab-method entry distances of R rays against B AABBs
    (boxlist_ray_intersection.cu:52-101 hitbox), on ``dirs``' device.
    Misses (no slab overlap, or the box wholly behind the origin) are
    +inf.  A zero direction component is replaced by 1e-30, not left to
    divide to ±inf: 0·inf would be NaN for an origin on a slab plane."""
    d = torch.as_tensor(dirs, dtype=torch.float32)
    dev = d.device
    o = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    d = d[:, None, :]  # (R, 1, 3)
    lo = torch.as_tensor(box_min, dtype=torch.float32, device=dev)[None]  # (1, B, 3)
    hi = torch.as_tensor(box_max, dtype=torch.float32, device=dev)[None]
    inv = torch.reciprocal(torch.where(torch.abs(d) > 0, d, 1e-30))
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)  # (R, B)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    entry = torch.clamp_min(tmin, 0.0)
    return torch.where(tmax >= entry, entry, torch.inf)


def boxlist_ray_intersection(
    box_min: torch.Tensor,
    box_max: torch.Tensor,
    origin,
    focallength: float,
    width: int,
    height: int,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel nearest box over a pinhole ray grid, on ``box_min``'s
    device: ((H, W) int32 ids, 0 for a miss and box + 1 for a hit, and
    the (H, W) f32 entry depth along the ray, inf on a miss).

    With no boxes every pixel misses.  The JAX package raises there
    (``argmin`` over an (R, 0) matrix); the port returns the misses."""
    box_min = torch.as_tensor(box_min, dtype=torch.float32)
    dev = box_min.device
    if box_min.shape[0] == 0:
        return (torch.zeros((height, width), dtype=torch.int32, device=dev),
                torch.full((height, width), torch.inf, dtype=torch.float32, device=dev))
    cx = (width - 1) / 2.0 if cx is None else cx
    cy = (height - 1) / 2.0 if cy is None else cy
    vv, uu = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    f = torch.tensor(focallength, dtype=torch.float32, device=dev)
    dirs = torch.stack([(uu - cx) / f, (vv - cy) / f, torch.ones_like(uu)], dim=-1).reshape(-1, 3)
    t = ray_box_tmin(origin, dirs, box_min, box_max)  # (R, B)
    tbest, best = torch.min(t, dim=1)
    ids = torch.where(torch.isfinite(tbest), best.to(torch.int32) + 1, 0)
    return ids.reshape(height, width), tbest.reshape(height, width)
