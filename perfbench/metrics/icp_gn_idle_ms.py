"""Device idle (ms), a profiled frame, that the trace's reduction
(``perfbench/tracing.py::reduce_profile``) credits to the innermost span
``icp.gn``: the gaps while the host enqueues the ICP's Gauss-Newton chain
(``registration/icp.py``).  None where the port has no such span."""


def read(trace):
    p = trace.profile
    if not p or not p.get("frames"):
        return None
    idle_s = dict(p["idle_gaps"]).get("icp.gn")
    return None if idle_s is None else 1e3 * idle_s / p["frames"]
