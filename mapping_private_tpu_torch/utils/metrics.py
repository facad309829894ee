"""The port's spans and counters, stage timers and profiler traces.

Counterpart of ``mapping_private_tpu/utils/metrics.py`` (in place of the
reference's ad-hoc timing, SURVEY §5.1), and the program's one system of
spans and counters:

- ``span(name)``: a range around a layer's work.  Tracing is on while a
  torch profiler records (the benchmark's profiled frames, ``trace()``,
  or an operator's own ``torch.profiler.profile(...)``).  Off, a span
  tests one flag and returns a shared no-op context: the hot path
  constructs nothing and reads nothing back.  On, it opens a
  ``torch.profiler.record_function("span:<name>")`` range (an NVTX range
  under ``emit_nvtx``) and keeps a ``SpanRecord`` in a bounded ring:
  name, parent span, root id (one per outermost span), and host start and
  end in ns on the profiler's own clock (the Unix epoch, as
  ``time.time_ns``), so records line up with the trace's device events.
  A span never synchronizes.
- ``count(name, value)``: adds to a counter.  A host number is always
  counted; a device tensor only where the caller tests ``on()`` first, and
  it stays on the device until ``report()`` or a reader reads it.  While
  tracing is on each count is also kept in a ring with its stamp, so a
  reader can sum one profiled window's (``window()``).
- ``stage(name, sync_result)``: a span that waits for the device work of
  its result (``torch.cuda.synchronize`` on each of its CUDA devices) and
  keeps its wall time in ``stages``;
- ``trace(label)``: a torch.profiler Chrome trace of a block when
  ``trace_dir`` is set; ``report()``: stages and counters, one line each.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

# Records kept in each ring: ~45 spans a scan frame, a few dozen a tabletop frame.
RING = 1 << 16
_NOOP = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]  # the enclosing span's name; None for an outermost span
    root: int  # one id per outermost span, shared by the spans inside it
    start_ns: int  # host clock of the profiler (Unix epoch ns)
    end_ns: int


class CountRecord(NamedTuple):
    name: str
    value: Any  # a host number or a device scalar tensor
    at_ns: int


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
    def __init__(self, trace_dir: Optional[str] = None):
        self.trace_dir = trace_dir
        self.stages: Dict[str, StageStats] = collections.defaultdict(StageStats)
        self.counters: Dict[str, Any] = collections.defaultdict(int)
        self.span_records: collections.deque = collections.deque(maxlen=RING)
        self.count_records: collections.deque = collections.deque(maxlen=RING)
        self._open = threading.local()  # each thread's stack of open spans
        self._roots = itertools.count()

    # -- spans ---------------------------------------------------------------
    @staticmethod
    def on() -> bool:
        """Whether tracing is on: a torch profiler is recording."""
        return _profiler._is_profiler_enabled

    def span(self, name: str):
        """A span around a layer's work (see the module's docstring)."""
        return self._span(name) if _profiler._is_profiler_enabled else _NOOP

    @contextlib.contextmanager
    def _span(self, name: str) -> Iterator[None]:
        stack = self._open.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        root = parent[1] if parent else next(self._roots)
        stack.append((name, root))
        start = time.time_ns()
        try:
            with torch.profiler.record_function(f"span:{name}"):
                yield
        finally:
            stack.pop()
            self.span_records.append(
                SpanRecord(name, parent[0] if parent else None, root, start, time.time_ns()))

    @contextlib.contextmanager
    def stage(self, name: str, sync_result: Any = None) -> Iterator[None]:
        """Time a named stage; pass the stage's output arrays as
        sync_result to attribute async device work correctly."""
        t0 = time.perf_counter()
        with self.span(name):
            try:
                yield
            finally:
                if sync_result is not None:
                    _sync(sync_result)
                self.stages[name].add(time.perf_counter() - t0)

    # -- counters ------------------------------------------------------------
    def count(self, name: str, value: Any = 1) -> None:
        self.counters[name] += value
        if _profiler._is_profiler_enabled:
            self.count_records.append(CountRecord(name, value, time.time_ns()))

    def window(self, lo_ns: int, hi_ns: int) -> Tuple[List[SpanRecord], List[CountRecord]]:
        """The span records that start, and the count records taken, in
        [lo_ns, hi_ns] on the profiler's clock: one profiled window's."""
        spans = [r for r in self.span_records if lo_ns <= r.start_ns <= hi_ns]
        counts = [r for r in self.count_records if lo_ns <= r.at_ns <= hi_ns]
        return spans, counts

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

    # -- reporting -----------------------------------------------------------
    def report(self) -> str:
        """Stages and counters, one line each (a device counter is read here)."""
        lines = ["stage                          count    mean_ms     total_s"]
        for name in sorted(self.stages):
            s = self.stages[name]
            lines.append(
                f"{name:<30} {s.count:>6} {s.mean_s * 1e3:>10.2f} {s.total_s:>11.3f}"
            )
        for name in sorted(self.counters):
            lines.append(f"{name:<30} {float(self.counters[name]):>6g}")
        return "\n".join(lines)


# the process-wide instance: the hot path's spans and counters go here
metrics = Metrics()
