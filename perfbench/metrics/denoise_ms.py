"""Mean host-clock span around the port's remove_statistical_outliers call,
per frame of the window (ms; each span ends in a device synchronize)."""


def read(trace):
    s = trace.spans.get("denoise")
    return 1e3 * sum(s) / len(s) if s else None
