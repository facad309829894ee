"""Rounds of the segmentation's connected components, a profiled frame: the
port's counter ``segment.component_rounds``
(``realtime/segmentation.py::_segment``, one host read a round), summed
over the counts taken in the profiled window.  None where the port keeps
no such counter."""


def read(trace):
    from mapping_private_tpu_torch.utils.metrics import metrics

    p = trace.profile
    window = getattr(metrics, "window", None)
    if window is None or not p or not p["kernels"] or not p.get("frames"):
        return None
    lo = p["kernels"][0][0]
    hi = max(s + int(d * 1e9) for s, d, _ in p["kernels"])
    rounds = [r.value for r in window(lo, hi)[1] if r.name == "segment.component_rounds"]
    return sum(rounds) / p["frames"] if rounds else None
