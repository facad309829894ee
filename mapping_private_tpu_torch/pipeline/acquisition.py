"""Scan acquisition: timestamp matching, pan-tilt sweeps, triggered
captures and Hokuyo scan lines (host-side).

Counterpart of ``mapping_private_tpu/pipeline/acquisition.py`` (the
reference's ias_data_acquisition_ptu ptu_acquire_data.cpp: ApproximateTime
matching of clouds with pan-tilt angles, :101, the sweep driver,
:135-136, and one PCD a view, :190).  The message filter is an in-process
``ApproximateTimeSync``, the PTU service client a caller's actuator
callback, and the dumps ``io.pcd.save_pcd`` calls.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Stamped:
    stamp: float
    value: Any


class ApproximateTimeSync:
    """Match messages across N streams by nearest timestamps within a slop
    (the message_filters::sync_policies::ApproximateTime core)."""

    def __init__(self, num_streams: int, slop: float = 0.05,
                 callback: Optional[Callable[..., None]] = None,
                 queue_size: int = 100):
        self.slop = slop
        self.callback = callback
        self.queues: List[List[Stamped]] = [[] for _ in range(num_streams)]
        self.queue_size = queue_size
        self.matched: List[Tuple[Any, ...]] = []

    def push(self, stream: int, stamp: float, value: Any) -> None:
        q = self.queues[stream]
        q.append(Stamped(stamp, value))
        if len(q) > self.queue_size:
            q.pop(0)
        self._try_match()

    def _try_match(self) -> None:
        if any(not q for q in self.queues):
            return
        # candidate: head-most recent common window around the earliest
        # latest-head timestamp
        pivot = self.queues[0][-1].stamp
        picks = []
        for q in self.queues:
            best = min(q, key=lambda m: abs(m.stamp - pivot))
            if abs(best.stamp - pivot) > self.slop:
                return
            picks.append(best)
        for q, m in zip(self.queues, picks):
            q.remove(m)
        tup = tuple(m.value for m in picks)
        self.matched.append(tup)
        if self.callback:
            self.callback(*tup)


@dataclasses.dataclass
class SweepConfig:
    pan_start: float = -60.0
    pan_end: float = 60.0
    pan_step: float = 15.0
    tilt: float = 0.0
    settle_time: float = 0.5


class ScanSession:
    """Drive a pan-tilt sweep and capture one cloud per view.

    actuator(pan_deg, tilt_deg) → None moves the unit (the /dp_ptu47
    service client's role); capture() → (stamp, PointCloud-like) grabs a
    cloud.  Views are recorded and optionally dumped as PCDs.
    """

    def __init__(self, actuator: Callable[[float, float], None],
                 capture: Callable[[], Tuple[float, Any]],
                 out_dir: Optional[str] = None):
        self.actuator = actuator
        self.capture = capture
        self.out_dir = out_dir
        self.views: List[Dict[str, Any]] = []

    def run_sweep(self, cfg: SweepConfig = SweepConfig()) -> List[Dict[str, Any]]:
        pan = cfg.pan_start
        idx = 0
        while pan <= cfg.pan_end + 1e-9:
            self.actuator(pan, cfg.tilt)
            stamp, cloud = self.capture()
            rec = dict(index=idx, pan=pan, tilt=cfg.tilt, stamp=stamp,
                       cloud=cloud)
            if self.out_dir is not None:
                from mapping_private_tpu_torch.io.pcd import save_pcd

                os.makedirs(self.out_dir, exist_ok=True)
                path = os.path.join(self.out_dir, f"view_{idx:03d}.pcd")
                save_pcd(path, cloud)
                rec["path"] = path
            self.views.append(rec)
            pan += cfg.pan_step
            idx += 1
        return self.views


def hokuyo_line_ids(beam_index: "np.ndarray") -> "np.ndarray":
    """Scan-line ids from per-point beam indices — `get_line_id_hokuyo`
    (cloud_tools/src/get_line_id_hokuyo.cpp:130-149): the Hokuyo driver
    only provides the beam index within one sweep; a new line starts
    whenever the index wraps (next index < current)."""
    import numpy as np

    idx = np.asarray(beam_index)
    if len(idx) == 0:
        return np.zeros((0,), np.int32)
    wraps = np.concatenate([[False], idx[1:] < idx[:-1]])
    return np.cumsum(wraps).astype(np.int32)


def add_hokuyo_line_channel(pcd_path: str, index_channel: str = "index",
                            out_path: "str | None" = None) -> str:
    """Add a 'line' channel to a PCD (the reference rewrites files in
    place, get_line_id_hokuyo.cpp:156-177).  Skips files that already
    carry one."""
    import numpy as np

    from mapping_private_tpu_torch.io.pcd import load_pcd_arrays, save_pcd

    arrays = dict(load_pcd_arrays(pcd_path))
    if "line" in arrays:
        return pcd_path
    if index_channel not in arrays:
        raise KeyError(f"{pcd_path} has no '{index_channel}' channel")
    arrays["line"] = hokuyo_line_ids(arrays[index_channel]).astype(np.float32)
    xyz = np.stack([arrays.pop("x"), arrays.pop("y"), arrays.pop("z")], 1)
    save_pcd(out_path or pcd_path, {"xyz": xyz, **arrays})
    return out_path or pcd_path


class TriggeredCapture:
    """`msg_to_pcd_joy` analog (cloud_tools/src/msg_to_pcd_joy.cpp): hold
    the latest cloud; `trigger()` (the reference's Wii button B callback)
    dumps it to a numbered PCD.

    ``distance_th``/``relative`` add the training-capture depth limit of
    color_voxel_recognition/test/save_data.cpp:67-83,150-158 (relative
    mode keeps z < min_z + th — the reference's object-segmentation
    capture); ``last_bbox`` then carries the (min, max) corners the tool
    publishes as its range marker (setMarker, save_data.cpp:87-115)."""

    def __init__(self, out_dir: str, prefix: str = "capture",
                 distance_th: "float | None" = None,
                 relative: bool = False):
        import os

        self.out_dir = out_dir
        self.prefix = prefix
        self.counter = 0
        self._latest = None
        self.distance_th = distance_th
        self.relative = relative
        self.last_bbox = None
        os.makedirs(out_dir, exist_ok=True)

    def push(self, arrays: Dict[str, Any]) -> None:
        self._latest = arrays

    def trigger(self) -> "str | None":
        import os

        import numpy as np

        from mapping_private_tpu_torch.io.pcd import save_pcd

        if self._latest is None:
            return None
        arrays = {k: np.asarray(v) for k, v in self._latest.items()}
        z = (arrays["xyz"][:, 2] if "xyz" in arrays
             else arrays.get("z"))
        if self.distance_th is not None and z is not None:
            th = float(self.distance_th)
            if self.relative:
                # raw Kinect clouds carry NaN rows — the reference's
                # dis_min scan skips them implicitly (NaN comparisons)
                th += float(np.nanmin(z))
            keep = np.isfinite(z) & (z < th)
            arrays = {k: v[keep] if v.shape[:1] == keep.shape else v
                      for k, v in arrays.items()}
        if "xyz" in arrays and len(arrays["xyz"]):
            self.last_bbox = (arrays["xyz"].min(0), arrays["xyz"].max(0))
        path = os.path.join(self.out_dir,
                            f"{self.prefix}_{self.counter:04d}.pcd")
        save_pcd(path, arrays)
        self.counter += 1
        return path
