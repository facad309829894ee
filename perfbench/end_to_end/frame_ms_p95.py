"""95th percentile of the latency of every frame of the window, from hand-in
to result on the host (ms; linear between order statistics)."""
from perfbench.yardstick import percentile


def read(win):
    return 1e3 * percentile(win.latencies_s, 95) if win.latencies_s else None
