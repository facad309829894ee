"""Per-frame runner: one Kinect frame through the port's robot self-filter.

Set-up writes the robot's mesh files, parses its URDF with the port and
makes one ``KinectSelfFilter`` (which loads the meshes once).  A frame is
the ring frame's depth image, handed in as a host array, and its joint
state; the filter draws its plane uniforms from the run's generator.  The
frame ends when the keep mask, the planes, their labels and count and the
segments are on the host; the rest of the filter's results stay on the
device for the check.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import tempfile

import numpy as np
import torch

from mapping_private_tpu_torch.realtime.self_filter import KinectSelfFilter, SelfFilterSettings
from mapping_private_tpu_torch.realtime.urdf import parse_urdf


def write_stl(path: str, tris: np.ndarray) -> None:
    """A binary STL of (T, 3, 3) float32 triangles (zero normals)."""
    rec = np.zeros(len(tris), dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")])
    rec["v"] = tris
    with open(path, "wb") as fp:
        fp.write(b"\0" * 80 + struct.pack("<I", len(tris)) + rec.tobytes())


class Stream:
    def __init__(self, cfg, traffic, ring, device, spans, seed):
        self._dir = tempfile.TemporaryDirectory()
        for path, tris in ring["meshes"].items():
            os.makedirs(os.path.dirname(os.path.join(self._dir.name, path)), exist_ok=True)
            write_stl(os.path.join(self._dir.name, path), tris)
        robot = parse_urdf("\n".join(cfg["robot"]["urdf"]), mesh_root=self._dir.name)
        f = cfg["focal_px"]
        self.filter = KinectSelfFilter(robot, ring["camera_from_root"], tuple(cfg["image_shape"]), f, f,
                                       SelfFilterSettings(**cfg["filter"]), device=device)
        self.frames, self.joints, self.spans = ring["frames"], ring["joints"], spans
        self.gen = torch.Generator(device=device).manual_seed(seed)
        # per frame: frame, ring index, the host results, and those of the filter's results on the
        # device that the check reads after the window
        self.records = []

    def frame(self, k: int) -> bool:
        j = k % len(self.frames)
        out = self.filter.process(self.frames[j], self.joints[j], self.gen)
        self.records.append({"k": k, "j": j, "keep": out.keep.cpu().numpy(), "planes": out.planes.cpu().numpy(),
                             "labels": out.plane_labels.cpu().numpy(), "count": int(out.plane_count),
                             "segments": out.segments.cpu().numpy(),
                             "out": dataclasses.replace(out, normals=None, keep=None, plane_labels=None,
                                                        segments=None)})
        return True

    def release(self) -> None:
        self.filter = None
        self._dir.cleanup()
