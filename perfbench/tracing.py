"""Spans and the device trace of a traced run (``--trace 1``).

Spans are taken from the benchmark's own files, around the calls into
each layer of the port: a span ends in ``torch.cuda.synchronize()`` and
its host-clock length is kept in memory until the run ends.  With tracing
off a span is a shared no-op context, so the untraced run pays nothing.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

_NOOP = contextlib.nullcontext()


class Spans:
    """Per-layer spans: ``spans.span(name)`` around a call into a layer."""

    def __init__(self, on: bool):
        self.on = on
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    def span(self, name: str):
        return self._span(name) if self.on else _NOOP

    @contextlib.contextmanager
    def _span(self, name: str):
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(f"span:{name}"):
            yield
            torch.cuda.synchronize()
        self.seconds[name].append(time.perf_counter() - t0)


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(ev, f"{what}_us")() * 1000)


def _merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def warm_profiler(device) -> None:
    """Start and stop the profiler once, in set-up: its first start takes
    seconds, which would otherwise fall into the traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()


def reduce_profile(prof, window_s: float) -> dict:
    """Busy seconds, the top device operations and the idle gaps by the
    span the host was in, from a torch.profiler run over ``window_s``
    seconds of frames.

    Returns {"busy_s", "window_s", "device_ops": [[name, s]...],
    "idle_gaps": [[span, s]...], "kernels": [(start ns, s, name)...] in
    start order}."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        annotation = ev.name().startswith("span:") or ev.name() == "frame"
        if ev.device_type() != cuda:
            if annotation:
                host.append((start, end, ev.name()))
        elif not annotation:  # the spans' ranges appear on the device's timeline too
            kernels.append((start, end, ev.name()))
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name in kernels:
        by_name[name] += (e - s) / 1e9
    busy = _merge([(s, e) for s, e, _ in kernels])
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        inner: Optional[tuple] = None
        for hs, he, name in host:  # the innermost span around the gap's middle
            if hs <= mid <= he and (inner is None or he - hs < inner[1] - inner[0]):
                inner = (hs, he, name)
        gaps[inner[2].removeprefix("span:") if inner else "between frames"] += (s1 - e0) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": busy_s, "window_s": window_s, "device_ops": top(by_name),
            "idle_gaps": top(gaps), "kernels": sorted((s, (e - s) / 1e9, n) for s, e, n in kernels)}

