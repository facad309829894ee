"""Plain reference of a scan pair's registration, and the comparison.

From the two scans alone (host arrays of the ring, never anything the
program made): the target's k-NN normals (``plain.normals``), then
point-to-plane Gauss-Newton with the configuration's sweeps, distance
gate, Huber weight and damping, each sweep matching every source point to
its nearest target point.  It runs in float64; the control runs it in
float32 with TF32 matrix products.

The number compared: ``transform_gap``, the largest Frobenius norm of
the difference of the top 3 x 4 block of the program's transform and
the reference's, over every frame of the window.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.references import plain


def icp(src, tgt, tgt_n, iters, max_corr_dist, huber_delta, damping):
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    eye6 = torch.eye(6, dtype=src.dtype, device=src.device)
    for _ in range(iters):
        p = plain.mm(src, T[:3, :3].T) + T[:3, 3]
        idx, d2 = plain.nn1(p, tgt)
        q, n = tgt[idx], tgt_n[idx]
        r = ((p - q) * n).sum(1)
        a = r.abs()
        w = torch.where(a <= huber_delta, 1.0, huber_delta / a.clamp_min(1e-12))
        w = torch.where(d2 <= max_corr_dist * max_corr_dist, w, 0.0)
        J = torch.cat([n, torch.linalg.cross(p, n)], 1)
        Jw = J * w[:, None]
        xi = -torch.linalg.solve(plain.mm(J.T, Jw) + damping * eye6, plain.mm(Jw.T, r[:, None])[:, 0])
        T = plain.mm(plain.se3_exp(xi), T)
    return T


def transform(cfg, ring, i: int, j: int, device, dtype=torch.float64, tf32=False) -> np.ndarray:
    """The reference's transform of scan j onto scan i (float64 host)."""
    with plain.precision(tf32):
        tgt = torch.as_tensor(ring["frames"][i], device=device).to(dtype)
        src = torch.as_tensor(ring["frames"][j], device=device).to(dtype)
        c = cfg["icp"]
        T = icp(src, tgt, plain.normals(tgt, cfg["normals_k"]), c["iters"], c["max_corr_dist"],
                c["huber_delta"], c["damping"])
    return T.cpu().numpy().astype(np.float64)


def check(cfg, traffic, ring, records, warm, device):
    refs, gap = {}, -np.inf
    for k, i, j, T in records:
        if k < warm:
            continue
        if (i, j) not in refs:
            refs[(i, j)] = transform(cfg, ring, i, j, device)
        gap = max(gap, float(np.linalg.norm(np.asarray(T, np.float64)[:3] - refs[(i, j)][:3])))
    value = gap if np.isfinite(gap) else float("inf")  # nothing to compare reads as a failure
    return [{"name": "transform_gap", "value": value, "limit": traffic["limits"]["transform_gap"]}]


def control(cfg, traffic, ring, records, warm, device):
    """``check``'s numbers with the control in the program's place: the
    reference in float32 with TF32 matrix products."""
    done = {}
    for _, i, j, _ in records:
        if (i, j) not in done:
            done[(i, j)] = transform(cfg, ring, i, j, device, torch.float32, tf32=True)
    return check(cfg, traffic, ring, [(k, i, j, done[(i, j)]) for k, i, j, _ in records], warm, device)
