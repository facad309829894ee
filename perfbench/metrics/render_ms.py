"""Mean host length (ms), a profiled frame, of the port's own
``selffilter.render`` span (``realtime/self_filter.py``, recorded by
``utils/metrics.py`` while the profiler runs): the stage's enqueue and
the host reads inside it, with no synchronize of its own.  The port's
records are picked by the trace's clock: those that end between the
profiled window's first and last device event (the stage's host work
starts before its first device event).  None where the port keeps no such
span."""


def read(trace):
    from mapping_private_tpu_torch.utils.metrics import metrics

    p = trace.profile
    if not hasattr(metrics, "span_records") or not p or not p["kernels"] or not p.get("frames"):
        return None
    lo = p["kernels"][0][0]
    hi = max(s + int(d * 1e9) for s, d, _ in p["kernels"])
    spans = [r for r in metrics.span_records if r.name == "selffilter.render" and lo <= r.end_ns <= hi]
    return sum(r.end_ns - r.start_ns for r in spans) / 1e6 / p["frames"] if spans else None
