"""Port parity: native/build.py, native/loader.py and utils/metrics.py
against the JAX package, and the port's ASCII PCD parse through its own
native library.

The native library is the same C++ source built by each package on its
own: parses, grid keys and RGB unpacking compare bit for bit, and so do
ASCII PCD loads.  ``strtof`` rounds a token once; numpy (the fallback of
both packages when there is no compiler) parses it to float64 and rounds
again, which differs on a token just above a float32 rounding midpoint:
the test pins which value each path yields.  Metrics: the same stages,
counts and report layout (times differ), the device sync walks the same
containers, a stage is a span under a profiler, and ``trace()`` writes a
torch.profiler Chrome trace."""
import importlib
import json
import os
import time

import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.io import pcd as jpcd
from mapping_private_tpu.native import loader as jload
from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.io import pcd as tpcd
from mapping_private_tpu_torch.native import build as tbuild, loader as tload

# the modules, not the ``metrics`` instances that each ``utils`` package exports under the same name
jmet = importlib.import_module("mapping_private_tpu.utils.metrics")
tmet = importlib.import_module("mapping_private_tpu_torch.utils.metrics")
MIDPOINT_PLUS = b"1.0000000596046447753906251"  # just above 1 + 2^-24, the midpoint of 1 and 1 + 2^-23


def test_native_library_builds_into_build_dir():
    assert tload.native_available() and jload.native_available()
    path = tbuild.build_library()
    assert path is not None and os.path.exists(path)
    assert os.path.dirname(path) == str(tbuild.BUILD_DIR) and tbuild.BUILD_DIR.parts[-2:] == ("build", "torch_native")
    assert tbuild.SRC.read_bytes() != b"" and tbuild.library_path().name.startswith("mapping_native-")


def float_text(n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 10, n) * 10.0 ** rng.integers(-8, 8, n)
    parts = [f"{v:.{int(p)}g}" for v, p in zip(vals, rng.integers(1, 12, n))]
    seps = rng.choice([" ", "  ", "\n", "\t", " \r\n"], n)
    return "".join(p + s for p, s in zip(parts, seps)).encode()


@pytest.mark.parametrize("n,threads", [(1000, 1), (300_000, 4), (300_000, 0)])
def test_parse_floats_bit_for_bit(n, threads):
    text = float_text(n, n)
    got = tload.parse_floats(text, threads=threads)
    want = jload.parse_floats(text, threads=threads)
    assert got.dtype == np.float32 and len(got) == n
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), tload.parse_floats(text, threads=1).view(np.uint32))
    with pytest.raises(ValueError, match="capacity"):
        tload.parse_floats(b"1 2 3", capacity=2)


def test_parse_rounding_pinned():
    """strtof (native, both packages) rounds the token up; numpy's double
    parse lands on the midpoint and rounds to even (down)."""
    text = MIDPOINT_PLUS + b" nan -0 junk 2.5"
    nat = tload.parse_floats(text)
    np.testing.assert_array_equal(nat.view(np.uint32), jload.parse_floats(text).view(np.uint32))
    assert nat[0] == np.nextafter(np.float32(1), np.float32(2)) and np.isnan(nat[1]) and len(nat) == 4
    assert np.array(MIDPOINT_PLUS.split(), dtype=np.float32)[0] == np.float32(1.0)


def test_numpy_fallback_without_a_library(monkeypatch):
    monkeypatch.setattr(tload, "_lib", None)
    monkeypatch.setattr(tload, "_tried", False)
    monkeypatch.setattr(tload, "build_library", lambda: None)
    assert not tload.native_available()
    assert tload.parse_floats(MIDPOINT_PLUS + b" 2")[0] == np.float32(1.0)  # numpy's rounding
    xyz = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(tload.grid_keys(xyz, 0.1), jload.grid_keys(xyz, 0.1))
    rgb = tpcd.pack_rgb(np.arange(50) * 5, np.arange(50), 255 - np.arange(50))
    for a, b in zip(tload.unpack_rgb(rgb), jload.unpack_rgb(rgb)):
        np.testing.assert_array_equal(a, b)


def test_grid_keys_and_unpack_rgb_match():
    xyz = (np.random.default_rng(1).normal(size=(5000, 3)) * 30).astype(np.float32)
    for cell in (0.05, 0.3):
        np.testing.assert_array_equal(tload.grid_keys(xyz, cell), jload.grid_keys(xyz, cell))
    rng = np.random.default_rng(2)
    rgb = tpcd.pack_rgb(*(rng.integers(0, 256, 1000) for _ in range(3)))
    got, want = tload.unpack_rgb(rgb), jload.unpack_rgb(rgb)
    for a, b, c in zip(got, want, tpcd._unpack_rgb(rgb)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_ascii_pcd_load_goes_through_the_native_parse(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(2000, 3)).astype(np.float32)
    path = str(tmp_path / "frame.pcd")
    tpcd.save_pcd(path, {"xyz": xyz, "intensity": rng.uniform(0, 1, 2000).astype(np.float32)}, ascii_fmt="%.9g")
    with open(path, "rb") as fp:
        text = fp.read()
    body_start = text.index(b"DATA ascii\n") + len(b"DATA ascii\n")
    first = text.index(b" ", body_start)  # the first x becomes a token just above a rounding midpoint
    text = text[:body_start] + MIDPOINT_PLUS + text[first:]
    with open(path, "wb") as fp:
        fp.write(text)
    got, want = tpcd.load_pcd_arrays(path), jpcd.load_pcd_arrays(path)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].view(np.uint32), want[k].view(np.uint32))
    assert got["x"][0] == np.nextafter(np.float32(1), np.float32(2))  # strtof's rounding
    calls = []
    monkeypatch.setattr(tpcd, "parse_floats", lambda b: calls.append(len(b)) or tload.parse_floats(b))
    cloud = tpcd.load_pcd(path, device="cpu")
    assert len(calls) == 1 and int(cloud.count()) == 2000
    (tmp_path / "short.pcd").write_bytes(text[: body_start + 40])
    with pytest.raises(ValueError, match="truncated"):
        tpcd.load_pcd_arrays(str(tmp_path / "short.pcd"))


def test_metrics_match():
    mt, mj = tmet.Metrics(), jmet.Metrics()
    for m in (mt, mj):
        with m.stage("load"):
            time.sleep(0.002)
        with m.stage("load", sync_result=[{"a": torch.ones(3)}]):
            pass
        m.count("frames")
        m.count("points", 2.5e5)
    for m in (mt, mj):
        assert m.stages["load"].count == 2 and m.stages["load"].min_s <= m.stages["load"].max_s
        assert m.stages["load"].total_s >= 0.002 and m.counters == {"frames": 1.0, "points": 2.5e5}
    lt, lj = mt.report().splitlines(), mj.report().splitlines()
    assert len(lt) == len(lj) and lt[0] == lj[0]
    assert [line.split()[:2] for line in lt[1:]] == [line.split()[:2] for line in lj[1:]]
    assert tmet.StageStats().mean_s == jmet.StageStats().mean_s == 0.0
    assert isinstance(tmet.metrics, tmet.Metrics)


def test_metrics_log_and_sync(capsys):
    # a stage prints nothing; under a profiler it is a span as well
    m = tmet.Metrics()
    with m.stage("s"):
        pass
    assert capsys.readouterr().out == "" and not m.span_records
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with m.stage("s", sync_result=torch.zeros(1)):
            pass
    assert [r.name for r in m.span_records] == ["s"] and m.stages["s"].count == 2
    assert any(ev.name() == "span:s" for ev in prof.profiler.kineto_results.events())
    cloud = PointCloud.from_numpy(np.zeros((5, 3), np.float32), {"normal": np.ones((5, 3), np.float32)},
                                  device="cpu")
    found = list(tmet._tensors(({"c": cloud}, [torch.zeros(2), 3, "x"], None)))
    assert len(found) == 4  # xyz, mask, the normal channel, the list's tensor
    tmet._sync([cloud, torch.zeros(1)])  # CPU tensors are ready: nothing to wait for


def test_metrics_trace_writes_a_chrome_trace(tmp_path):
    m = tmet.Metrics(trace_dir=str(tmp_path / "traces"))
    with m.trace("frame"):
        torch.ones(100).sum()
    trace = json.loads((tmp_path / "traces" / "frame.json").read_text())
    assert any(ev.get("name") == "frame" for ev in trace["traceEvents"])
    with tmet.Metrics().trace("off"):  # no trace_dir: nothing written
        pass
    assert not (tmp_path / "off.json").exists()
