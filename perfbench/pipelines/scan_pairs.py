"""Per-frame runner: each new scan registered onto the previous one.

The body of the port's ``icp_register`` CLI for one pair: the target's
k-NN normals (``ops/normals.py``), point-to-plane ICP
(``registration/icp.py``), the transform read to the host.  A frame is
the scan handed in as a host array (``PointCloud.from_numpy`` copies it
to the device) and ends when the transform is a host array.
"""
from __future__ import annotations

import numpy as np


class Stream:
    def __init__(self, cfg, traffic, ring, device, spans, seed):
        from mapping_private_tpu_torch.core.cloud import PointCloud
        from mapping_private_tpu_torch.ops.normals import estimate_normals
        from mapping_private_tpu_torch.registration.icp import icp_point_to_plane

        self._cloud, self._normals = PointCloud.from_numpy, estimate_normals
        self._icp = icp_point_to_plane
        self.frames, self.device, self.spans = ring["frames"], device, spans
        self.k, self.icp = cfg["normals_k"], cfg["icp"]
        self.prev = None  # (ring index, PointCloud) of the last scan
        # (frame, target ring index, source ring index, 4x4 transform source -> target)
        self.records = []

    def frame(self, k: int) -> bool:
        j = k % len(self.frames)
        src = self._cloud(self.frames[j], device=self.device)
        if self.prev is None:
            self.prev = (j, src)
            return True
        i, tgt = self.prev
        with self.spans.span("normals"):
            tgt_n = self._normals(tgt, k=self.k)
        with self.spans.span("icp"):
            res = self._icp(src.padded_xyz(), src.mask, tgt.padded_xyz(), tgt.mask,
                            tgt_n.channel("normal"), iters=self.icp["iters"],
                            max_corr_dist=self.icp["max_corr_dist"],
                            huber_delta=self.icp["huber_delta"], damping=self.icp["damping"])
        T = res.transform.cpu().numpy()
        self.records.append((k, i, j, T))
        self.prev = (j, src)
        return bool(np.isfinite(T).all())

    def release(self) -> None:
        self.prev = None
