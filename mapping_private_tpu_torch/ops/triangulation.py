"""Depth-image triangulation — the ``DepthImageTriangulation`` op.

Counterpart of ``mapping_private_tpu/ops/triangulation.py`` (the op the
table memory's reconstruction chain includes,
dyn_obj_store/src/table_memory.cpp:20-25): each 2×2 pixel block of an
organized cloud yields up to two triangles, gated on all corners being
valid and on every edge being at most ``max_edge`` long (so depth
discontinuities are not bridged).  The whole mesh is array work over the
image lattice: corner gathers, edge tests and a mask.  It returns a
fixed-size triangle list with a validity mask; ``compact_mesh`` (host
numpy) drops the invalid triangles and unused vertices.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def triangulate_depth_image(
    points: torch.Tensor,  # (H, W, 3) organized cloud
    valid: torch.Tensor,  # (H, W)
    max_edge: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (triangles (2·(H−1)·(W−1), 3) int32 flat-pixel ids,
    tri_valid (...,) bool): first every block's (tl, bl, tr), then every
    block's (tr, bl, br), blocks in row-major order."""
    h, w = valid.shape
    dev = points.device
    ii, jj = torch.meshgrid(torch.arange(h - 1, device=dev), torch.arange(w - 1, device=dev), indexing="ij")
    tl = ii * w + jj  # top-left flat index
    tr = tl + 1
    bl = tl + w
    br = bl + 1

    p = points.reshape(-1, 3)
    v = valid.reshape(-1)

    def edge_ok(a, b):
        e = p[a] - p[b]
        d = torch.sqrt(e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2])
        return v[a] & v[b] & (d <= max_edge)

    # triangle 1: (tl, bl, tr); triangle 2: (tr, bl, br)
    t1_ok = edge_ok(tl, bl) & edge_ok(bl, tr) & edge_ok(tr, tl)
    t2_ok = edge_ok(tr, bl) & edge_ok(bl, br) & edge_ok(br, tr)
    t1 = torch.stack([tl, bl, tr], dim=-1).reshape(-1, 3)
    t2 = torch.stack([tr, bl, br], dim=-1).reshape(-1, 3)
    tris = torch.cat([t1, t2], dim=0).to(torch.int32)
    return tris, torch.cat([t1_ok.reshape(-1), t2_ok.reshape(-1)])


def compact_mesh(
    points: np.ndarray, triangles: np.ndarray, tri_valid: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Host side: drop invalid triangles and unused vertices.

    points: (H·W, 3) or (H, W, 3); returns (verts (V,3), tris (T,3))."""
    p = np.asarray(points, np.float32).reshape(-1, 3)
    t = np.asarray(triangles)[np.asarray(tri_valid)]
    used = np.unique(t)
    remap = np.full(len(p), -1, np.int64)
    remap[used] = np.arange(len(used))
    return p[used], remap[t]
