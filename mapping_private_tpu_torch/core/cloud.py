"""PointCloud — the dense struct-of-arrays cloud type.

Counterpart of ``mapping_private_tpu/core/cloud.py``: a fixed-capacity
cloud whose ``mask`` marks the live rows.  Dead rows carry ``PAD_COORD``
so they lose every nearest-neighbour comparison without special cases.
Capacity rounds up to a multiple of 128, as in the JAX package, so the
two packages hold the same rows and parity holds row by row.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Sentinel coordinate for padded points: far away from any real scene.
PAD_COORD = 1.0e8


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Fixed-capacity point cloud.

    Attributes:
      xyz:   (N, 3) float32 positions; padded rows hold PAD_COORD.
      mask:  (N,)  bool, True for live points.
      channels: dict of named per-point tensors, each (N,) or (N, C).
    """

    xyz: torch.Tensor
    mask: torch.Tensor
    channels: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self) -> torch.Tensor:
        """Number of live points (a 0-d int32 tensor on the cloud's device)."""
        return torch.sum(self.mask, dtype=torch.int32)

    def has_channel(self, name: str) -> bool:
        return name in self.channels

    def channel(self, name: str) -> torch.Tensor:
        return self.channels[name]

    def with_channel(self, name: str, value: torch.Tensor) -> "PointCloud":
        ch = dict(self.channels)
        ch[name] = value
        return dataclasses.replace(self, channels=ch)

    def with_xyz(self, xyz: torch.Tensor) -> "PointCloud":
        return dataclasses.replace(self, xyz=xyz)

    def _stacked(self, whole: str, parts: Tuple[str, str, str]) -> Optional[torch.Tensor]:
        if whole in self.channels:
            return self.channels[whole]
        if all(k in self.channels for k in parts):
            return torch.stack([self.channels[k] for k in parts], dim=-1)
        return None

    def normals(self) -> Optional[torch.Tensor]:
        """(N,3) normals from a 'normal' channel or from nx/ny/nz channels
        (the reference keeps normals as three scalar channels)."""
        return self._stacked("normal", ("nx", "ny", "nz"))

    def rgb(self) -> Optional[torch.Tensor]:
        """(N,3) float colours in [0,255] from 'rgb' or r/g/b channels."""
        return self._stacked("rgb", ("r", "g", "b"))

    def select(self, keep: torch.Tensor) -> "PointCloud":
        """Mask-and: restrict the live set to ``keep`` (N,) bool; no
        compaction, the capacity stays."""
        return dataclasses.replace(self, mask=self.mask & keep)

    def padded_xyz(self) -> torch.Tensor:
        """xyz with dead rows pushed to the sentinel (idempotent)."""
        return torch.where(self.mask[:, None], self.xyz, PAD_COORD)

    @staticmethod
    def from_numpy(
        xyz: np.ndarray,
        channels: Optional[Dict[str, np.ndarray]] = None,
        capacity: Optional[int] = None,
        *,
        device: torch.device | str,
    ) -> "PointCloud":
        """Build a PointCloud on ``device`` from host arrays, padding up to
        ``capacity`` (default: the next multiple of 128 of len(xyz))."""
        n = xyz.shape[0]
        if capacity is None:
            capacity = max(128, -(-n // 128) * 128)
        if capacity < n:
            raise ValueError(f"capacity {capacity} < point count {n}")
        pad = capacity - n
        xyz_p = np.concatenate(
            [np.asarray(xyz, np.float32), np.full((pad, 3), PAD_COORD, np.float32)]
        )
        mask = np.zeros((capacity,), dtype=bool)
        mask[:n] = True
        chans = {}
        for k, v in (channels or {}).items():
            v = np.asarray(v, dtype=np.float32)
            chans[k] = np.concatenate([v, np.zeros((pad,) + v.shape[1:], np.float32)])
        return PointCloud.from_arrays(xyz_p, mask, chans, device=device)

    @staticmethod
    def from_arrays(
        xyz: np.ndarray,
        mask: np.ndarray,
        channels: Optional[Dict[str, np.ndarray]] = None,
        *,
        device: torch.device | str,
    ) -> "PointCloud":
        """Carry a cloud's fields across bit for bit, dead rows included:
        ``xyz`` (N,3), ``mask`` (N,) and ``channels`` as host arrays, e.g.
        ``np.asarray`` of each field of the JAX package's PointCloud."""
        xyz = np.asarray(xyz)
        mask = np.asarray(mask)
        if xyz.ndim != 2 or xyz.shape[1] != 3 or mask.shape != xyz.shape[:1]:
            raise ValueError(f"xyz {xyz.shape} / mask {mask.shape}: want (N,3) / (N,)")

        def dev(a, dtype):  # always a copy: the source may be read-only
            return torch.tensor(np.asarray(a, dtype), device=device)

        chans = {k: dev(v, np.float32) for k, v in (channels or {}).items()}
        return PointCloud(xyz=dev(xyz, np.float32), mask=dev(mask, bool), channels=chans)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Return host copies of live rows only (for I/O and tests)."""
        mask = self.mask.cpu().numpy()
        out = {"xyz": self.xyz.cpu().numpy()[mask]}
        for k, v in self.channels.items():
            out[k] = v.cpu().numpy()[mask]
        return out
