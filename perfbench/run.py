"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name from
BENCHMARK.json at the root of the checkout; see perfbench/harness.py.
"""
import os
import sys
import time

_T0 = time.perf_counter()


def _process_age_s() -> float:
    """Seconds the process had run before this module's first line (0.0
    where /proc is not there)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    _START = _T0 - _process_age_s()
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], started=_START))
