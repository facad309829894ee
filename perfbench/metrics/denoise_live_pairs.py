"""Share (%) of the brute denoise's distance pairs that join two live
points: the port's counters ``denoise.live_pairs`` (live rows squared)
over ``denoise.pairs`` (rows x refs), summed over the counts that
``ops/filters.py::statistical_outlier_mask`` took in the profiled window
(picked by the trace's clock, as the port stamps them).  None where the
port counts no such pairs."""


def read(trace):
    from mapping_private_tpu_torch.utils.metrics import metrics

    p = trace.profile
    window = getattr(metrics, "window", None)
    if window is None or not p or not p["kernels"]:
        return None
    lo = p["kernels"][0][0]
    hi = max(s + int(d * 1e9) for s, d, _ in p["kernels"])
    counts = window(lo, hi)[1]
    pairs = sum(int(c.value) for c in counts if c.name == "denoise.pairs")
    live = [int(c.value) for c in counts if c.name == "denoise.live_pairs"]
    return 100.0 * sum(live) / pairs if pairs and live else None
