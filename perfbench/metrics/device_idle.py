"""Share (%) of the profiled frames' wall time in which no operation ran on
the device: 1 - busy / window, busy the union of the kernels' intervals in
torch.profiler's trace (plus the CUDA-event time of a tapped kernel that
the trace does not hold).  Read under ``device_idle.<cells>``, one name for
each end-to-end rate that it moves."""


def read(trace):
    p = trace.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
