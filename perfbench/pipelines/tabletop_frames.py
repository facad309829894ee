"""Per-frame runner: one Kinect frame through the table pipeline.

The body of the port's ``table_pipeline`` CLI (``run_pipeline``) for one
frame, in its order: ``box_filter``, ``remove_statistical_outliers``,
``detect_table``, the host reads of the clusters and the hull, and
``TableMemory.update``.  The detector's RANSAC uniforms are drawn from the
run's generator as ``detect_table`` draws them, and handed to it, so the
reference reads the same draws; the memory draws from the same generator
after it.  A frame is the points handed in as a host array
(``PointCloud.from_numpy`` copies them to the device) and ends when the
memory has taken the observation.
"""
from __future__ import annotations

import torch


class Stream:
    def __init__(self, cfg, traffic, ring, device, spans, seed):
        from mapping_private_tpu_torch.core.cloud import PointCloud
        from mapping_private_tpu_torch.models.table_detector import (
            TableDetectorConfig, detect_table, table_uniforms_shape)
        from mapping_private_tpu_torch.models.table_memory import TableMemory
        from mapping_private_tpu_torch.ops.filters import box_filter, remove_statistical_outliers

        self._cloud, self._box, self._denoise = PointCloud.from_numpy, box_filter, remove_statistical_outliers
        self._detect = detect_table
        self.frames, self.device, self.spans = ring["frames"], device, spans
        self.box, self.dn = cfg["box"], cfg["denoise"]
        self.det_cfg = TableDetectorConfig(**cfg["detector"])
        self.u_shape = table_uniforms_shape(self.det_cfg)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.memory = TableMemory(cfg["memory"]["sac_threshold"], device=device)
        # per frame: frame, ring index, keep mask, uniforms, detection, its voxels, the generator's
        # state before the memory's update, table id, object names and reconstructions
        self.records = []

    def frame(self, k: int) -> bool:
        j = k % len(self.frames)
        cloud = self._cloud(self.frames[j], device=self.device)
        with self.spans.span("box_filter"):
            cloud = self._box(cloud, self.box[:3], self.box[3:])
        with self.spans.span("denoise"):
            cloud, valid = self._denoise(cloud, k=self.dn["k"], alpha=self.dn["alpha"],
                                         min_nr_pts=self.dn["min_nr_pts"])
        rec = {"k": k, "j": j, "keep": cloud.mask, "u": None, "det": None, "tid": None, "names": None}
        self.records.append(rec)
        if not bool(valid):
            return False
        rec["u"] = u = torch.rand(self.u_shape, generator=self.gen, device=self.device)
        with self.spans.span("detect_table"):
            det, down = self._detect(cloud, None, self.det_cfg, u=u)
        if not bool(det.found):
            return False
        with self.spans.span("host_reads"):
            xyz = down.xyz.cpu().numpy()
            masks, sizes = det.object_masks.cpu().numpy(), det.object_sizes.cpu().numpy()
            clusters = [xyz[m] for m, s in zip(masks, sizes) if s > 0]
            hull_xy = xyz[det.table_inliers.cpu().numpy()][:, :2]
            height = float(det.table_min[2])
        rec["gen_state"] = self.gen.get_state()
        with self.spans.span("table_memory"):
            tid = self.memory.update(hull_xy, height, clusters, stamp=float(k), generator=self.gen)
        objects = self.memory.tables[tid].instances[-1].objects
        rec.update(det=det, down=down, tid=tid, names=[o.name for o in objects],
                   fits=[{"type": o.object_type, "cylinder": o.cylinder, "box": o.box} for o in objects])
        return True

    def release(self) -> None:
        self.memory = None
