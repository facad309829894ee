"""The port's spans and counters (``utils/metrics.py``) on its hot paths.

Tracing is on only while a torch profiler records.  Off, a span builds no
profiler range and keeps no record, and the traced paths dispatch the
same operations as with the tracer stubbed out: no added device work, no
read back to the host.  On, the ranges carry the ``span:`` prefix the
benchmark's trace reduction looks for, nest as the layers do, and the
in-memory records lie on the trace's own clock.
"""
import contextlib

import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import mapping_private_tpu_torch.registration.icp as icp
from mapping_private_tpu_torch import _build
from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.ops import filters, icp_gn, knn_kbest, nn_argmin, nn_gather, nn_matmul, nn_search
from mapping_private_tpu_torch.ops.normals import estimate_normals
from mapping_private_tpu_torch.utils.metrics import RING, CountRecord, SpanRecord, metrics

ITERS = 3


class _Ops(TorchDispatchMode):
    """The aten operations dispatched inside the block, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _pair(n=300, live=260, seed=0):
    """(src xyz, src mask, tgt xyz, tgt mask, tgt normals): a surface and a
    small motion of it, with the last rows of each cloud dead."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    tgt = np.c_[xy, 0.1 * np.sin(3 * xy[:, 0]) + 0.05 * xy[:, 1]].astype(np.float32)
    c, s_ = np.cos(0.02), np.sin(0.02)
    src = (tgt @ np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32).T + [0.01, -0.02, 0.005]).astype(np.float32)
    keep = torch.arange(n) < live
    t = PointCloud.from_numpy(tgt, device="cpu")
    t = t.select(t.mask & torch.nn.functional.pad(keep, (0, t.mask.shape[0] - n)))
    s = PointCloud.from_numpy(src, device="cpu")
    s = s.select(s.mask & torch.nn.functional.pad(keep, (0, s.mask.shape[0] - n)))
    return s.padded_xyz(), s.mask, t.padded_xyz(), t.mask, estimate_normals(t, k=8).channel("normal")


def _icp(pair):
    src, sm, tgt, tm, nrm = pair
    return icp.icp_point_to_plane(src, sm, tgt, tm, nrm, iters=ITERS)


def _denoise(pair):
    src, sm, _, _, _ = pair
    return filters.statistical_outlier_mask(src, sm, k=6, alpha=1.0)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def fresh(monkeypatch):
    """The process-wide tracer with empty rings and counters."""
    for attr in ("span_records", "count_records"):
        monkeypatch.setattr(metrics, attr, type(getattr(metrics, attr))(maxlen=RING))
    monkeypatch.setattr(metrics, "counters", type(metrics.counters)(int))
    return metrics


@pytest.mark.parametrize("path", [_icp, _denoise], ids=["icp", "denoise"])
def test_off_builds_no_range_and_adds_no_work(monkeypatch, fresh, path):
    pair = _pair()
    assert not metrics.on()

    def refuse(*a, **k):
        raise AssertionError("a profiler range was built with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with _Ops() as traced:
        out_traced = path(pair)
    assert not fresh.span_records and not fresh.count_records
    assert all(not isinstance(v, torch.Tensor) for v in fresh.counters.values())
    # the same path with the tracer stubbed out: the same operations, none a host read
    monkeypatch.setattr(metrics, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(metrics, "count", lambda name, value=1: None)
    with _Ops() as stubbed:
        out_stubbed = path(pair)
    assert traced.ops == stubbed.ops
    assert not any("_local_scalar_dense" in op for op in traced.ops)
    if path is _icp:
        torch.testing.assert_close(out_traced.transform, out_stubbed.transform, rtol=0, atol=0)
    else:
        assert torch.equal(out_traced, out_stubbed)


def test_spans_nest_under_a_profiler_and_icp_looks_up_the_kernel_entry(monkeypatch, fresh):
    pair = _pair()
    calls = []
    orig = icp.nn_argmin_prepared

    def counted(q, prepared):
        calls.append(q.shape)
        return orig(q, prepared)

    monkeypatch.setattr(icp, "nn_argmin_prepared", counted)
    with _cpu_profile() as prof:
        assert metrics.on()
        _icp(pair)
    assert not metrics.on()
    assert len(calls) == ITERS  # looked up through registration.icp on every sweep
    recs = list(fresh.span_records)
    (outer,) = [r for r in recs if r.name == "icp"]
    assert outer.parent is None
    sweeps = [r for r in recs if r.root == outer.root and r.parent == "icp"]
    assert [r.name for r in sweeps] == ["icp.nn", "icp.gn"] * ITERS
    assert all(outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns for r in sweeps)
    names = [ev.name() for ev in prof.profiler.kineto_results.events()]
    assert names.count("span:icp") == 1
    assert names.count("span:icp.nn") == names.count("span:icp.gn") == ITERS
    # every span's range carries the prefix: no other name is counted as device work
    assert not {"icp", "icp.nn", "icp.gn"} & set(names)


def test_nested_layers_share_a_root(fresh):
    pair = _pair()
    cloud = PointCloud.from_numpy(pair[0].numpy(), device="cpu").select(pair[1])
    with _cpu_profile():
        filters.remove_statistical_outliers(filters.box_filter(cloud, [-2] * 3, [2] * 3), k=6)
        estimate_normals(cloud, k=6)
    by = {}
    for r in fresh.span_records:
        by.setdefault(r.name, []).append(r)
    assert [r.parent for r in by["knn"]] == ["denoise", "normals"]
    assert by["knn"][0].root == by["denoise"][0].root != by["normals"][0].root
    assert by["box_filter"][0].parent is None


def test_records_lie_on_the_traces_clock(fresh):
    with _cpu_profile() as prof:
        with metrics.span("warm"):
            torch.ones(10).sum()
        with metrics.span("timed"):
            torch.ones(1000).sum()
    (rec,) = [r for r in fresh.span_records if r.name == "timed"]
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "span:timed"]
    start = ev.start_ns()
    end = start + ev.duration_ns()
    assert abs(rec.start_ns - start) < 100_000 and abs(rec.end_ns - end) < 100_000
    assert [r.name for r in fresh.window(rec.start_ns, end)[0]] == ["timed"]


@pytest.mark.parametrize("kernel", ["nn_argmin", "nn_matmul", "nn_gather", "knn_kbest", "icp_gn"])
def test_launch_counters_still_count(monkeypatch, fresh, kernel):
    q, r = torch.zeros(4, 3), torch.zeros(3, 5)
    monkeypatch.setattr(nn_search, "search_index", lambda *a, **k: (torch.zeros(4, dtype=torch.int32), torch.zeros(4)))
    monkeypatch.setattr(nn_search, "search", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 0}))
    for _ in range(2):
        if kernel == "nn_argmin":
            nn_argmin._launch(q, r)
        elif kernel == "nn_matmul":
            nn_matmul._launch(q, r.T.contiguous())
        elif kernel == "nn_gather":
            nn_gather._launch(q, r, r, "vpu")
        elif kernel == "knn_kbest":
            knn_kbest._launch(r, 3)
        else:  # one count a sweep that took the kernel
            gn = icp_gn.CardGN(q, torch.ones(4, dtype=torch.bool), q, q, torch.eye(4), 1, 0.25, 0.05, 1e-6, True)
            gn.step(torch.zeros(4, dtype=torch.int32), torch.zeros(4), 0)
    assert fresh.counters[f"{kernel}.launches"] == 2
    assert not fresh.count_records  # counted with tracing off too, with no record kept


def test_the_rings_are_bounded(monkeypatch, fresh):
    monkeypatch.setattr(metrics, "span_records", type(metrics.span_records)(maxlen=4))
    with _cpu_profile():
        for k in range(10):
            with metrics.span(f"s{k}"):
                pass
            metrics.count("c")
    assert [r.name for r in metrics.span_records] == ["s6", "s7", "s8", "s9"]
    assert isinstance(metrics.span_records[0], SpanRecord) and isinstance(fresh.count_records[0], CountRecord)
    assert fresh.counters["c"] == 10 and len(fresh.count_records) == 10
