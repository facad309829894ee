"""Layered 3-D reconstruction — the deprecated monolith.

Counterpart of ``mapping_private_tpu/models/layered_reconstruction.py``
(cloud_algos/deprecated/layered-3d-reconstruction.cpp): slice a room scan
into horizontal z-layers, fit a 2-D line and a 2-D circle per layer
(fitOnlyLines :1054), then merge consistent fits of adjacent layers into
boxes (``Line2Box`` :1560) and cylinders (``Circle2Cylinder`` :1719).

Each layer's fits are batched-hypothesis RANSAC on the device
(fit/ransac.py); the layer loop and the merge pass are host code.
Randomness: one ``torch.Generator`` is threaded through the layers, or
``u`` gives, for each layer that is fitted (in order), the uniforms of
its line fit (num_hypotheses, 2) and of its circle fit
(num_hypotheses, 3).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.fit.ransac import fit_circle2d_ransac, fit_line2d_ransac


@dataclasses.dataclass(frozen=True)
class LayeredConfig:
    layer_height: float = 0.10
    min_layer_points: int = 60
    line_threshold: float = 0.015
    circle_threshold: float = 0.015
    min_radius: float = 0.02
    max_radius: float = 0.6
    num_hypotheses: int = 256
    min_inliers: int = 40
    # cross-layer merge tolerances
    line_angle_tol: float = 0.15
    line_dist_tol: float = 0.05
    circle_center_tol: float = 0.05
    circle_radius_tol: float = 0.03
    min_layers_per_solid: int = 2


@dataclasses.dataclass
class LayerFit:
    layer: int
    z_lo: float
    z_hi: float
    kind: str  # 'line' | 'circle'
    params: np.ndarray  # line [nx,ny,c] | circle [cx,cy,r]
    num_inliers: int
    span: Optional[np.ndarray] = None  # line endpoints (2,2)


@dataclasses.dataclass
class Solid:
    kind: str  # 'box' | 'cylinder'
    z_lo: float
    z_hi: float
    params: dict
    layers: List[int] = dataclasses.field(default_factory=list)


def _fit_layer(xy, xy_np, mask, generator, cfg, u) -> List[tuple]:
    ul, uc = (None, None) if u is None else u
    line, l_inl = fit_line2d_ransac(
        xy, mask, generator, num_hypotheses=cfg.num_hypotheses, threshold=cfg.line_threshold, u=ul)
    circle, c_inl = fit_circle2d_ransac(
        xy, mask, generator, num_hypotheses=cfg.num_hypotheses, threshold=cfg.circle_threshold,
        min_radius=cfg.min_radius, max_radius=cfg.max_radius, u=uc)
    # one host read for both fits
    vals = torch.cat([line, circle, torch.stack([l_inl.sum(), c_inl.sum()]).to(line.dtype)]).cpu().numpy()
    line_np, circle_np, n_l, n_c = vals[:3], vals[3:6], int(vals[6]), int(vals[7])
    out = []
    if n_l >= cfg.min_inliers:
        pts = xy_np[l_inl.cpu().numpy()]
        proj = pts @ np.array([-float(line_np[1]), float(line_np[0])])
        out.append(("line", line_np, n_l, np.stack([pts[proj.argmin()], pts[proj.argmax()]])))
    if n_c >= cfg.min_inliers:
        out.append(("circle", circle_np, n_c, None))
    return out


def layered_reconstruction(
    cloud: PointCloud,
    generator: Optional[torch.Generator] = None,
    cfg: LayeredConfig = LayeredConfig(),
    u: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> List[Solid]:
    """Slice → per-layer 2-D fits → merge adjacent consistent fits."""
    xyz = cloud.xyz.cpu().numpy()
    live = cloud.mask.cpu().numpy()
    z = xyz[:, 2]
    z_min = float(z[live].min()) if live.any() else 0.0
    z_max = float(z[live].max()) if live.any() else 0.0
    n_layers = max(1, int(np.ceil((z_max - z_min) / cfg.layer_height)))

    layer_fits: List[LayerFit] = []
    xy_dev = cloud.xyz[:, :2].contiguous()
    fitted = 0
    for li in range(n_layers):
        lo = z_min + li * cfg.layer_height
        hi = lo + cfg.layer_height
        m = live & (z >= lo) & (z < hi)
        if m.sum() < cfg.min_layer_points:
            continue
        mask = torch.from_numpy(m).to(xy_dev.device)
        fits = _fit_layer(xy_dev, xyz[:, :2], mask, generator, cfg, None if u is None else u[fitted])
        fitted += 1
        for kind, params, n_in, span in fits:
            layer_fits.append(LayerFit(li, lo, hi, kind, params, n_in, span))

    # merge pass (Line2Box / Circle2Cylinder): stack compatible fits of the
    # same kind across consecutive layers
    solids: List[Solid] = []
    used = set()
    for i, f in enumerate(layer_fits):
        if i in used:
            continue
        stack = [f]
        used.add(i)
        for j in range(i + 1, len(layer_fits)):
            if j in used:
                continue
            g = layer_fits[j]
            if g.kind != f.kind or g.layer != stack[-1].layer + 1:
                continue
            if f.kind == "line":
                cos = abs(float(np.dot(f.params[:2], g.params[:2])))
                d = abs(float(f.params[2]) - float(g.params[2]) * np.sign(
                    np.dot(f.params[:2], g.params[:2]) or 1.0))
                if cos >= np.cos(cfg.line_angle_tol) and d <= cfg.line_dist_tol:
                    stack.append(g)
                    used.add(j)
            else:
                dc = float(np.linalg.norm(f.params[:2] - g.params[:2]))
                dr = abs(float(f.params[2]) - float(g.params[2]))
                if dc <= cfg.circle_center_tol and dr <= cfg.circle_radius_tol:
                    stack.append(g)
                    used.add(j)
        if len(stack) < cfg.min_layers_per_solid:
            continue
        z_lo, z_hi = stack[0].z_lo, stack[-1].z_hi
        if f.kind == "circle":
            cs = np.stack([s.params for s in stack])
            solids.append(Solid(
                kind="cylinder", z_lo=z_lo, z_hi=z_hi,
                params=dict(center=cs[:, :2].mean(0).tolist(), radius=float(cs[:, 2].mean())),
                layers=[s.layer for s in stack],
            ))
        else:
            spans = np.concatenate([s.span for s in stack if s.span is not None])
            n2 = stack[0].params[:2]
            proj = spans @ np.array([-n2[1], n2[0]])
            solids.append(Solid(
                kind="box", z_lo=z_lo, z_hi=z_hi,
                params=dict(
                    normal=n2.tolist(), offset=float(stack[0].params[2]),
                    endpoints=[spans[proj.argmin()].tolist(), spans[proj.argmax()].tolist()],
                ),
                layers=[s.layer for s in stack],
            ))
    return solids
