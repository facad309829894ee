"""The readers of the port's own spans and counters on a synthetic trace:
``icp_host_ms``, ``icp_gn_idle_ms`` and ``table_memory_host_reads``.  Each
picks the profiled window's records by the trace's clock and returns None
where there is nothing to read."""
import collections

import pytest

from perfbench import harness
from mapping_private_tpu_torch.utils.metrics import RING, SpanRecord, metrics

MS = 1_000_000  # ns
T0 = 1_800_000_000 * 10**9  # a Unix-epoch stamp, as the profiler's clock gives


def reader(name):
    return harness.load_module("metrics", name).read


def profile(kernels, frames=2, idle_gaps=()):
    """reduce_profile's output for kernels [(start ns, seconds, name)]."""
    return {"busy_s": 0.0, "window_s": 1.0, "device_ops": [], "idle_gaps": [list(g) for g in idle_gaps],
            "kernels": sorted(kernels), "frames": frames, "tap_times": {}}


@pytest.fixture
def records(monkeypatch):
    """Empty rings in the port's tracer, filled by the test."""
    spans = collections.deque(maxlen=RING)
    counts = collections.deque(maxlen=RING)
    monkeypatch.setattr(metrics, "span_records", spans)
    monkeypatch.setattr(metrics, "count_records", counts)
    return spans, counts


def test_icp_host_ms_averages_the_windows_icp_spans(records):
    spans, _ = records
    kernels = [(T0 + 1 * MS, 1e-4, "k"), (T0 + 300 * MS, 2e-4, "k")]
    spans.extend([
        SpanRecord("icp", None, 0, T0 - 500 * MS, T0 - 400 * MS),  # an earlier window's
        SpanRecord("icp", None, 1, T0 + 2 * MS, T0 + 102 * MS),
        SpanRecord("icp.gn", "icp", 1, T0 + 3 * MS, T0 + 4 * MS),
        SpanRecord("icp", None, 2, T0 + 150 * MS, T0 + 230 * MS),
    ])
    tr = harness.Trace({}, {}, profile(kernels))
    assert reader("icp_host_ms")(tr) == pytest.approx(90.0)
    spans.clear()
    assert reader("icp_host_ms")(tr) is None
    assert reader("icp_host_ms")(harness.Trace({}, {}, None)) is None


def test_icp_gn_idle_ms_reads_the_innermost_spans_idle():
    p = profile([(T0, 1e-3, "k")], frames=10, idle_gaps=[("icp.gn", 1.5), ("icp", 0.2), ("icp.nn", 0.1)])
    assert reader("icp_gn_idle_ms")(harness.Trace({}, {}, p)) == pytest.approx(150.0)
    p["idle_gaps"] = [["icp", 1.7]]  # a program with no such span
    assert reader("icp_gn_idle_ms")(harness.Trace({}, {}, p)) is None
    assert reader("icp_gn_idle_ms")(harness.Trace({}, {}, None)) is None


def test_table_memory_host_reads_counts_copies_inside_the_span(records):
    spans, _ = records
    a, b = T0 + 100 * MS, T0 + 200 * MS
    spans.extend([SpanRecord("table_memory", None, 0, a, b),
                  SpanRecord("table_memory.object", "table_memory", 0, a + 10 * MS, a + 50 * MS)])
    kernels = [(T0, 1e-3, "k"),
               (a - 1, 1e-6, "Memcpy DtoH (Device -> Pageable)"),  # just before the span
               (a + 20 * MS, 1e-6, "Memcpy DtoH (Device -> Pageable)"),
               (a + 60 * MS, 1e-6, "Memcpy DtoH (Device -> Pinned)"),
               (a + 70 * MS, 1e-6, "Memcpy HtoD (Pageable -> Device)"),
               (a + 80 * MS, 1e-6, "void some_kernel"),
               (b + 1, 1e-6, "Memcpy DtoH (Device -> Pageable)"),  # just after it
               (b + 50 * MS, 1e-3, "k")]
    tr = harness.Trace({}, {}, profile(kernels, frames=1))
    assert reader("table_memory_host_reads")(tr) == 2
    spans.clear()
    assert reader("table_memory_host_reads")(tr) is None
    assert reader("table_memory_host_reads")(harness.Trace({}, {}, None)) is None


def test_the_new_metrics_are_declared_for_their_cells():
    bench = harness.load_bench()
    want = {"icp_host_ms": "scan20k.pairs", "icp_gn_idle_ms": "scan20k.pairs",
            "table_memory_host_reads": "tabletop.frames"}
    got = {m["name"]: m["workloads"] for m in bench["per_layer"] if m["name"] in want}
    assert got == {k: [v] for k, v in want.items()}
