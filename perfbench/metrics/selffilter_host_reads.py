"""Reads from the device to the host, a profiled frame, inside the port's
own ``selffilter`` span (``realtime/self_filter.py::KinectSelfFilter.process``):
the trace's ``Memcpy DtoH`` entries whose start lies in one of the span's
host intervals, which the port stamps on the trace's clock; the spans are
those that end between the profiled window's first and last device event
(a frame's host work starts before its first device event).  The frame's
own reads of its results come after the span and are not counted.  None
where the port keeps no such span."""


def read(trace):
    from mapping_private_tpu_torch.utils.metrics import metrics

    p = trace.profile
    if not hasattr(metrics, "span_records") or not p or not p["kernels"] or not p.get("frames"):
        return None
    lo = p["kernels"][0][0]
    hi = max(s + int(d * 1e9) for s, d, _ in p["kernels"])
    spans = [(r.start_ns, r.end_ns) for r in metrics.span_records if r.name == "selffilter" and lo <= r.end_ns <= hi]
    if not spans:
        return None
    reads = [s for s, _, name in p["kernels"] if name.startswith("Memcpy DtoH")]
    return sum(any(a <= s <= b for a, b in spans) for s in reads) / p["frames"]
