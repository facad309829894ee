"""Metrics and profiling: stage timers, counters, a profiler trace and
verbosity-gated logging.

Counterpart of ``mapping_private_tpu/utils/metrics.py`` (in place of the
reference's ad-hoc timing, SURVEY §5.1, and its ``verbosity_level_``
logging, cloud_algos.h:24,27):

- stages: named wall-clock timers that wait for the device work of the
  stage's result (``torch.cuda.synchronize`` on each of its CUDA devices)
  so device time lands in the stage that launched it;
- counters with a one-line report;
- ``trace()``: a torch.profiler Chrome trace of a block when
  ``trace_dir`` is set;
- ``log()``: verbosity-gated printing; every op can share one Metrics.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional

import torch


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    """The tensors in ``x``: a tensor, or lists, tuples, dicts and
    dataclasses (a PointCloud) holding them."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def _sync(x: Any) -> None:
    """Wait for the device work behind ``x``: one synchronize for each
    CUDA device its tensors lie on (CPU tensors are ready)."""
    for device in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class Metrics:
    def __init__(self, verbosity: int = 0, trace_dir: Optional[str] = None):
        self.verbosity = verbosity
        self.trace_dir = trace_dir
        self.stages: Dict[str, StageStats] = defaultdict(StageStats)
        self.counters: Dict[str, float] = defaultdict(float)

    # -- timing --------------------------------------------------------------
    @contextlib.contextmanager
    def stage(self, name: str, sync_result: Any = None) -> Iterator[None]:
        """Time a named stage; pass the stage's output arrays as
        sync_result to attribute async device work correctly."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_result is not None:
                _sync(sync_result)
            dt = time.perf_counter() - t0
            self.stages[name].add(dt)
            self.log(1, f"[{name}] {dt * 1e3:.2f} ms")

    def time_fn(self, name: str, fn, *args, **kwargs):
        """Run fn, sync its output, record under name, return the output."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        self.stages[name].add(time.perf_counter() - t0)
        return out

    # -- counters ------------------------------------------------------------
    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    # -- profiler ------------------------------------------------------------
    @contextlib.contextmanager
    def trace(self, label: str = "trace") -> Iterator[None]:
        """torch.profiler trace of the block (set trace_dir to enable):
        a Chrome trace ``<trace_dir>/<label>.json``, with the card's
        activity where CUDA is available."""
        if not self.trace_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        os.makedirs(self.trace_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            with record_function(label):
                yield
        prof.export_chrome_trace(os.path.join(self.trace_dir, f"{label}.json"))

    # -- logging -------------------------------------------------------------
    def log(self, level: int, msg: str) -> None:
        if self.verbosity >= level:
            print(msg, flush=True)

    # -- reporting -----------------------------------------------------------
    def report(self) -> str:
        lines = ["stage                          count    mean_ms     total_s"]
        for name in sorted(self.stages):
            s = self.stages[name]
            lines.append(
                f"{name:<30} {s.count:>6} {s.mean_s * 1e3:>10.2f} {s.total_s:>11.3f}"
            )
        for name in sorted(self.counters):
            lines.append(f"{name:<30} {self.counters[name]:>6g}")
        return "\n".join(lines)


# a default process-wide instance (ops accept their own when needed)
metrics = Metrics()
