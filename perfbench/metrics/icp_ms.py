"""Mean host-clock span around the port's icp_point_to_plane call, per
frame of the window (ms; each span ends in a device synchronize)."""


def read(trace):
    s = trace.spans.get("icp")
    return 1e3 * sum(s) / len(s) if s else None
