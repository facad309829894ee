"""Pose-graph optimization — damped Gauss-Newton over SE(3) keyframes.

Counterpart of ``mapping_private_tpu/registration/pose_graph.py``: edge
residuals r_e = log(Z_e⁻¹ T_i⁻¹ T_j) and their Jacobians (forward mode,
``torch.func.jacfwd`` under ``torch.func.vmap``) for all edges at once;
the 6K×6K normal equations assemble by scatter-adding 6×6 blocks, with
repeated indices accumulating (self-edges, shared nodes); gauge freedom
is fixed by a strong prior on node 0.

The sharded variant splits EDGES over the ranks of a mesh
(``parallel.mesh``): each rank builds partial (H, g) from its edge
shard, one all_reduce over every mesh axis assembles the full system,
and every rank solves it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from mapping_private_tpu_torch.core.se3 import se3_exp, se3_inverse, se3_log
from mapping_private_tpu_torch.parallel.mesh import all_reduce_sum, block, shard_index, to_mesh_device


def edge_residual(Ti: torch.Tensor, Tj: torch.Tensor, Zij: torch.Tensor) -> torch.Tensor:
    """r = log(Z⁻¹ · Ti⁻¹ · Tj) ∈ R⁶ (zero when Tj = Ti·Z)."""
    return se3_log(se3_inverse(Zij) @ se3_inverse(Ti) @ Tj)


def _edge_system(Ti, Tj, Zij, weight):
    """Residual + Jacobians wrt right-perturbations of (Ti, Tj)."""

    def r_of(xi_i, xi_j):
        return edge_residual(Ti @ se3_exp(xi_i), Tj @ se3_exp(xi_j), Zij)

    z6 = torch.zeros(6, dtype=Ti.dtype, device=Ti.device)
    r = r_of(z6, z6)
    Ji = jacfwd(r_of, argnums=0)(z6, z6)  # (6,6)
    Jj = jacfwd(r_of, argnums=1)(z6, z6)
    return r * weight, Ji * weight, Jj * weight


def build_normal_equations(
    poses: torch.Tensor,  # (K, 4, 4)
    edges: torch.Tensor,  # (E, 2) integer
    measurements: torch.Tensor,  # (E, 4, 4)
    weights: Optional[torch.Tensor] = None,  # (E,)
    edge_mask: Optional[torch.Tensor] = None,  # (E,) bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H (K,K,6,6) block matrix, g (K,6), total squared error)."""
    E, K = edges.shape[0], poses.shape[0]
    opts = dict(dtype=poses.dtype, device=poses.device)
    w = torch.ones(E, **opts) if weights is None else weights.to(**opts)
    if edge_mask is not None:
        w = w * edge_mask.to(w.dtype)
    i, j = edges[:, 0].long(), edges[:, 1].long()
    r, Ji, Jj = vmap(_edge_system)(poses[i], poses[j], measurements, w)

    def JtJ(A, B):
        return torch.einsum("eab,eac->ebc", A, B)

    # index_put_ with accumulate=True: duplicate (i, j) pairs add up, as
    # the JAX package's .at[].add does (plain H[i, j] += x would not).
    H = torch.zeros(K, K, 6, 6, **opts)
    H.index_put_((i, i), JtJ(Ji, Ji), accumulate=True)
    H.index_put_((j, j), JtJ(Jj, Jj), accumulate=True)
    H.index_put_((i, j), JtJ(Ji, Jj), accumulate=True)
    H.index_put_((j, i), JtJ(Jj, Ji), accumulate=True)
    g = torch.zeros(K, 6, **opts)
    g.index_add_(0, i, torch.einsum("eab,ea->eb", Ji, r))
    g.index_add_(0, j, torch.einsum("eab,ea->eb", Jj, r))
    return H, g, torch.sum(r * r)


def _solve_and_update(poses, H, g, damping, anchor_weight):
    K = poses.shape[0]
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    H = H.clone()
    H[0, 0] += anchor_weight * eye6  # gauge fix: strong prior on node 0
    Hd = H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    Hd = Hd + damping * torch.eye(6 * K, dtype=H.dtype, device=H.device)
    dx = -torch.linalg.solve(Hd, g.reshape(-1)).reshape(K, 6)
    return vmap(lambda T, xi: T @ se3_exp(xi))(poses, dx)


def optimize_pose_graph(
    poses: torch.Tensor,
    edges: torch.Tensor,
    measurements: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    iters: int = 10,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damped GN relaxation on the device of ``poses``.
    Returns (poses (K,4,4), per-iter error (iters,))."""
    errs = []
    for _ in range(iters):
        H, g, err = build_normal_equations(poses, edges, measurements, weights)
        poses = _solve_and_update(poses, H, g, damping, anchor_weight)
        errs.append(err)
    return poses, torch.stack(errs)


def make_sharded_pose_graph_step(
    mesh,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
):
    """One GN iteration with EDGES sharded over every mesh axis.

    Returns (step_fn, shard_fn).  shard_fn(poses, edges, measurements,
    weights) cuts this rank's edge block (the first mesh axis major) and
    replicates the poses; step_fn(...) → (poses, error), both the same on
    every rank.  Pad the edge list to a multiple of the mesh size with
    weight-0 self-edges (0, 0, identity)."""
    axes = tuple(mesh.mesh_dim_names)

    def step(poses, edges, measurements, weights):
        # this rank's edge shard -> partial normal equations, summed over the mesh
        H, g, err = build_normal_equations(poses, edges, measurements, weights)
        for a in axes:
            group = mesh.get_group(a)
            H, g, err = (all_reduce_sum(t, group) for t in (H, g, err))
        return _solve_and_update(poses, H, g, damping, anchor_weight), err

    def shard(poses, edges, measurements, weights):
        k, n = shard_index(mesh, axes)
        return (to_mesh_device(mesh, poses),
                *(to_mesh_device(mesh, block(a, k, n)) for a in (edges, measurements, weights)))

    return step, shard
