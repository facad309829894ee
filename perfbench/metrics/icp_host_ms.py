"""Mean host length (ms), a profiled frame, of the port's own ``icp`` span
(``registration/icp.py``, recorded by ``utils/metrics.py`` while the
profiler runs): the enqueue of the ICP's sweeps, with no synchronize.
The port's records are picked by the trace's clock, as the port stamps
them: those that start between the profiled window's first and last
device event.  None where the port keeps no such span."""


def read(trace):
    from mapping_private_tpu_torch.utils.metrics import metrics

    p = trace.profile
    window = getattr(metrics, "window", None)
    if window is None or not p or not p["kernels"] or not p.get("frames"):
        return None
    lo = p["kernels"][0][0]
    hi = max(s + int(d * 1e9) for s, d, _ in p["kernels"])
    icp = [r for r in window(lo, hi)[0] if r.name == "icp"]
    return sum(r.end_ns - r.start_ns for r in icp) / 1e6 / p["frames"] if icp else None
