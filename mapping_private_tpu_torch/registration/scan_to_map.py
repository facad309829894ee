"""Scan-to-map registration — the incremental mapping loop.

Counterpart of ``mapping_private_tpu/registration/scan_to_map.py``: scans
register against an accumulated voxel-deduplicated MAP (drift stops
compounding through intermediate scans), keyframes enter a pose graph,
and loop closures relax the whole trajectory
(registration/pose_graph.py).

The map is a fixed-capacity masked point set: insertion is concat →
voxel-key sort → unique-first compaction, all dense tensor ops, so a
track step costs the same whatever the map's fill.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.core.cloud import PAD_COORD
from mapping_private_tpu_torch.core.se3 import se3_apply, se3_compose, se3_inverse, se3_log
from mapping_private_tpu_torch.ops.neighbors import _KEY_SENTINEL, _cell_key
from mapping_private_tpu_torch.registration.icp import icp_point_to_plane


@dataclasses.dataclass(frozen=True)
class VoxelMap:
    """Fixed-capacity world-frame map: one representative point per voxel."""

    xyz: torch.Tensor  # (M, 3)
    normals: torch.Tensor  # (M, 3)
    mask: torch.Tensor  # (M,)
    voxel_size: torch.Tensor  # scalar

    @staticmethod
    def empty(capacity: int, voxel_size: float, *, device: torch.device | str) -> "VoxelMap":
        return VoxelMap(
            xyz=torch.full((capacity, 3), PAD_COORD, dtype=torch.float32, device=device),
            normals=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
            voxel_size=torch.tensor(voxel_size, dtype=torch.float32, device=device),
        )

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask, dtype=torch.int32)

    def to(self, device: torch.device | str) -> "VoxelMap":
        return VoxelMap(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def integrate_scan(
    vmap_: VoxelMap,
    scan_xyz: torch.Tensor,
    scan_normals: torch.Tensor,
    scan_mask: torch.Tensor,
) -> VoxelMap:
    """Insert world-frame scan points; one point per voxel, existing map
    points win ties (stable first-occurrence after a composite-key sort).
    Overflow beyond capacity drops the newest points."""
    M = vmap_.xyz.shape[0]
    xyz = torch.cat([vmap_.xyz, scan_xyz])
    nrm = torch.cat([vmap_.normals, scan_normals])
    mask = torch.cat([vmap_.mask, scan_mask])
    cell = torch.floor(xyz / vmap_.voxel_size).to(torch.int32)
    keys = torch.where(mask, _cell_key(cell), _KEY_SENTINEL)
    # stable sort keeps map entries (lower original index) ahead of scan
    order = torch.argsort(keys, stable=True)
    ks = keys[order]
    first = torch.ones_like(mask)
    first[1:] = ks[1:] != ks[:-1]
    keep = first & (ks != _KEY_SENTINEL)
    # compact: winners first (stable), then truncate to capacity
    comp = torch.argsort((~keep).to(torch.uint8), stable=True)
    sel = order[comp][:M]
    keep_m = keep[comp][:M]
    return VoxelMap(
        xyz=torch.where(keep_m[:, None], xyz[sel], PAD_COORD),
        normals=torch.where(keep_m[:, None], nrm[sel], 0.0),
        mask=keep_m,
        voxel_size=vmap_.voxel_size,
    )


@dataclasses.dataclass
class TrackerConfig:
    map_capacity: int = 65536
    map_voxel: float = 0.02
    icp_iters: int = 15
    max_corr_dist: float = 0.3
    keyframe_trans: float = 0.10  # insert keyframe beyond this motion
    keyframe_rot: float = 0.17  # ~10°
    nn_backend: str = "auto"


class ScanToMapTracker:
    """Host-side orchestration; each track step is device work on
    ``device`` with one host read (the keyframe decision)."""

    def __init__(self, cfg: Optional[TrackerConfig] = None, *, device: torch.device | str):
        self.cfg = cfg if cfg is not None else TrackerConfig()
        self.device = torch.device(device)
        self.map: Optional[VoxelMap] = None
        self.pose = torch.eye(4, device=self.device)
        self.keyframe_poses: List[torch.Tensor] = [torch.eye(4, device=self.device)]
        self.edges: List[Tuple[int, int, torch.Tensor]] = []  # (i, j, Z_ij)

    def track(
        self,
        scan_xyz: torch.Tensor,
        scan_normals: torch.Tensor,
        scan_mask: torch.Tensor,
    ) -> Tuple[torch.Tensor, bool]:
        """Register one scan.  Returns (world pose (4,4), made_keyframe)."""
        cfg = self.cfg
        if self.map is None:
            self.map = VoxelMap.empty(cfg.map_capacity, cfg.map_voxel, device=self.device)
            world = se3_apply(self.pose, scan_xyz)
            self.map = integrate_scan(
                self.map, torch.where(scan_mask[:, None], world, PAD_COORD),
                scan_normals, scan_mask,
            )
            return self.pose, True

        res = icp_point_to_plane(
            scan_xyz, scan_mask,
            self.map.xyz, self.map.mask, self.map.normals,
            init_T=self.pose,
            iters=cfg.icp_iters, max_corr_dist=cfg.max_corr_dist,
            nn_backend=cfg.nn_backend,
        )
        self.pose = res.transform
        # keyframe decision: motion since the last keyframe, read by the
        # host in one transfer
        Z = se3_compose(se3_inverse(self.keyframe_poses[-1]), self.pose)
        delta = se3_log(Z)
        trans, rot = torch.stack(
            [torch.linalg.norm(delta[:3]), torch.linalg.norm(delta[3:])]).tolist()
        made_kf = trans > cfg.keyframe_trans or rot > cfg.keyframe_rot
        if made_kf:
            self.edges.append((len(self.keyframe_poses) - 1, len(self.keyframe_poses), Z))
            self.keyframe_poses.append(self.pose)
            world = se3_apply(self.pose, scan_xyz)
            nrm_w = scan_normals @ self.pose[:3, :3].T
            self.map = integrate_scan(
                self.map, torch.where(scan_mask[:, None], world, PAD_COORD),
                nrm_w, scan_mask,
            )
        return self.pose, made_kf

    # -- checkpoint / resume: the tracker persists map + trajectory, in
    # the JAX package's .npz layout, so either package resumes the other's
    def checkpoint(self, path: str) -> None:
        def host(t):
            return t.cpu().numpy()

        arrays = dict(
            pose=host(self.pose),
            keyframes=np.stack([host(p) for p in self.keyframe_poses]),
        )
        if self.map is not None:
            arrays.update(
                map_xyz=host(self.map.xyz),
                map_normals=host(self.map.normals),
                map_mask=host(self.map.mask),
                map_voxel=host(self.map.voxel_size),
            )
        if self.edges:
            arrays["edge_ij"] = np.asarray([[i, j] for i, j, _ in self.edges])
            arrays["edge_Z"] = np.stack([host(Z) for _, _, Z in self.edges])
        np.savez_compressed(path, **arrays)

    @staticmethod
    def restore(path: str, cfg: Optional[TrackerConfig] = None, *,
                device: torch.device | str) -> "ScanToMapTracker":
        t = ScanToMapTracker(cfg, device=device)

        def dev(a):
            return torch.tensor(np.asarray(a), device=t.device)

        with np.load(path) as data:
            t.pose = dev(data["pose"])
            t.keyframe_poses = [dev(p) for p in data["keyframes"]]
            if "map_xyz" in data:
                t.map = VoxelMap(
                    xyz=dev(data["map_xyz"]),
                    normals=dev(data["map_normals"]),
                    mask=dev(data["map_mask"]),
                    voxel_size=dev(data["map_voxel"]),
                )
            if "edge_ij" in data:
                t.edges = [
                    (int(i), int(j), dev(Z))
                    for (i, j), Z in zip(data["edge_ij"], data["edge_Z"])
                ]
        return t

    def add_loop_closure(self, i: int, j: int, Z_ij: torch.Tensor) -> None:
        self.edges.append((i, j, Z_ij.to(self.device)))

    def relax(self, iters: int = 8) -> torch.Tensor:
        """Pose-graph relaxation over the keyframes; returns (K,4,4)."""
        from mapping_private_tpu_torch.registration.pose_graph import optimize_pose_graph

        K = len(self.keyframe_poses)
        if K < 2 or not self.edges:
            return torch.stack(self.keyframe_poses)
        poses = torch.stack(self.keyframe_poses)
        edges = torch.tensor([[i, j] for i, j, _ in self.edges], dtype=torch.int64,
                             device=self.device)
        meas = torch.stack([Z for _, _, Z in self.edges])
        relaxed, _ = optimize_pose_graph(poses, edges, meas, iters=iters)
        self.keyframe_poses = [relaxed[k] for k in range(K)]
        self.pose = self.keyframe_poses[-1]
        return relaxed
