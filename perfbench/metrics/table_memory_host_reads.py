"""Reads from the device to the host, a profiled frame, inside the port's
own ``table_memory`` span (``models/table_memory.py::TableMemory.update``):
the trace's ``Memcpy DtoH`` entries whose start lies in one of the span's
host intervals, which the port stamps on the trace's clock.  None where the
port keeps no such span."""


def read(trace):
    from mapping_private_tpu_torch.utils.metrics import metrics

    p = trace.profile
    window = getattr(metrics, "window", None)
    if window is None or not p or not p["kernels"] or not p.get("frames"):
        return None
    lo = p["kernels"][0][0]
    hi = max(s + int(d * 1e9) for s, d, _ in p["kernels"])
    spans = [(r.start_ns, r.end_ns) for r in window(lo, hi)[0] if r.name == "table_memory"]
    if not spans:
        return None
    reads = [s for s, _, name in p["kernels"] if name.startswith("Memcpy DtoH")]
    return sum(any(a <= s <= b for a, b in spans) for s in reads) / p["frames"]
