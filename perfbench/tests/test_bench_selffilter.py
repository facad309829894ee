"""``selffilter.vga`` driven end to end on the CPU at a small size, its
planted faults, its control, its ring and the readers of its per-layer
metrics.

The runs go through ``harness.run`` with ``device="cpu"`` at 80 x 60 (a
finger of 10 x 4 segments, 392 triangles in the arm; 128 hypotheses), so
everything of a run but the look for a chip and the traced run's profile.
The components' fault is shown at 240 x 320, where 256 one-pixel sweeps
leave the table and the floor split, as they do at 640 x 480."""
import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tracing import Spans
from mapping_private_tpu_torch.utils.metrics import RING, CountRecord, SpanRecord, metrics

BENCH = harness.load_bench()
CELL = "selffilter.vga"
SEED = 2**31 + 99
MS = 1_000_000  # ns
T0 = 1_800_000_000 * 10**9  # a Unix-epoch stamp, as the profiler's clock gives


def small(h=60, w=80, ring_frames=3):
    _, cfg, _ = harness.load_cell(BENCH, CELL)
    return dict(cfg, image_shape=[h, w], focal_px=525.0 * w / 640, ring_frames=ring_frames,
                robot=dict(cfg["robot"], meshes={"meshes/finger.stl": {"finger": [10, 4]}}),
                filter=dict(cfg["filter"], num_hypotheses=128))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run_small(seconds=0.3, **size):
    return harness.run(CELL, SEED, seconds, False, "cpu", cfg=small(**size), bench=BENCH)


def test_reference_agrees_with_the_port():
    res = run_small()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0 and list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"setup_s", "frames_per_s"}
    assert set(res["checks"]) == set(harness.load_cell(BENCH, CELL)[2]["limits"])


def test_a_run_loads_nothing_of_jax():
    code = f"""
import json, sys, torch
torch.set_num_threads(2)
sys.path.insert(0, {str(harness.ROOT)!r})
from perfbench import harness
from perfbench.tests.test_bench_selffilter import small
res = harness.run({CELL!r}, 5, 0.2, False, "cpu", cfg=small(), bench=harness.load_bench())
print(json.dumps({{"correct": res["correct"], "loaded": harness.banned_modules(),
                  "port": "mapping_private_tpu_torch" in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=harness.ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"correct": True, "loaded": [], "port": True}


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_control_fails_and_program_passes(seed):
    _, _, traffic = harness.load_cell(BENCH, CELL)
    cfg = small(ring_frames=2)
    ring = harness.load_module("scenes", cfg["scene"]).make_ring(cfg, seed)
    stream = harness.load_module("pipelines", traffic["pipeline"]).Stream(cfg, traffic, ring, "cpu", Spans(False),
                                                                          seed)
    for k in range(1 + len(ring["frames"])):
        stream.frame(k)
    ref = harness.load_module("references", traffic["reference"])
    failed = lambda checks: [c["name"] for c in checks if not c["value"] <= c["limit"]]  # noqa: E731
    assert not failed(ref.check(cfg, traffic, ring, stream.records, 1, "cpu"))
    assert failed(ref.control(cfg, traffic, ring, stream.records, 1, "cpu"))


def test_ring_repeats_for_a_seed_and_shows_the_robot():
    cfg = small(ring_frames=4)
    scene = harness.load_module("scenes", cfg["scene"])
    a, b, c = scene.make_ring(cfg, SEED), scene.make_ring(cfg, SEED), scene.make_ring(cfg, SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a["frames"], b["frames"]))
    assert a["joints"] == b["joints"] != c["joints"]
    assert len(a["frames"]) == 4 and all(d.dtype == np.float32 and d.shape == (60, 80) for d in a["frames"])
    # out and back: frames k and R - k are one pose apart by the jitter only
    assert abs(a["joints"][1]["shoulder_pan"] - a["joints"][3]["shoulder_pan"]) <= 0.04
    for d, r in zip(a["frames"], a["robot_depth"]):
        assert ((r > 0) & (np.abs(d - r) < 0.01)).mean() >= cfg["min_robot_share"]
    with pytest.raises(ValueError, match="the robot shows on"):
        scene.make_ring(dict(cfg, min_robot_share=0.5), SEED)


def test_the_reference_meshes_the_robot_as_the_port():
    """The reference's own URDF reading, kinematics and primitive meshes
    give the port's vertices (float32 rounding apart)."""
    import tempfile

    from mapping_private_tpu_torch.realtime import urdf
    from perfbench.pipelines.selffilter_frames import write_stl
    from perfbench.references import selffilter_frames as ref

    cfg = small()
    files = ref.mesh_files(cfg)
    mine = ref.Robot("\n".join(cfg["robot"]["urdf"]), files)
    q = {"shoulder_pan": 0.3, "shoulder_lift": 0.5, "elbow_flex": -0.4, "wrist_roll": 0.6, "torso_lift": 0.05}
    cam = ref.camera_from_root(cfg)
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(f"{d}/meshes")
        write_stl(f"{d}/meshes/finger.stl", files["meshes/finger.stl"])
        robot = urdf.parse_urdf("\n".join(cfg["robot"]["urdf"]), mesh_root=d)
        poses = robot.forward_kinematics(q)
        meshes = urdf._link_meshes(robot, poses)
        theirs = urdf._posed_vertices(meshes, poses, cam)[urdf._mesh_triangles(meshes)]
    v, t, _ = mine.mesh(q, cam, torch.float64, "cpu")
    ours = v.numpy()[t]
    key = lambda tris: np.sort(np.round(tris.reshape(len(tris), -1), 4), axis=0)  # noqa: E731
    assert ours.shape == theirs.shape == (392, 3, 3)
    np.testing.assert_allclose(key(ours), key(theirs), atol=2e-4)
    np.testing.assert_allclose(np.sort(ours.reshape(-1)), np.sort(theirs.reshape(-1)), atol=1e-6)


# -- faults: each breaks the path underneath and must read as not correct --------------------
def _not_cut(orig):
    return lambda meas, robot, threshold=0.05: torch.ones_like(meas, dtype=torch.bool)


def _cut_grown(orig):
    def fn(meas, robot, threshold=0.05):
        cut = (~orig(meas, robot, threshold)).float()[None, None]
        return torch.nn.functional.max_pool2d(cut, 3, 1, 1)[0, 0] == 0
    return fn


def _plane_off(orig):
    def fn(*a):
        planes, labels, count, seeds, rounds = orig(*a)
        planes = planes.clone()
        planes[:, 3] += 0.005
        return planes, labels, count, seeds, rounds
    return fn


def _plane_dropped(orig):
    def fn(*a):
        planes, labels, count, seeds, rounds = orig(*a)
        return planes, torch.where(labels == 0, -1, labels), count, seeds, rounds
    return fn


def _components_capped(orig):
    """The JAX package's loop in place of the exact labelling: 256 sweeps."""
    from mapping_private_tpu_torch.realtime import segmentation

    def fn(right, down, valid):
        h, w = valid.shape
        adj = torch.zeros((h, w, 4), dtype=torch.bool)
        adj[1:, :, 0], adj[:-1, :, 1], adj[:, 1:, 2], adj[:, :-1, 3] = down, down, right, right
        return segmentation._components(adj, valid, 256)
    return fn


FAULTS = [("self_filter", "background_subtract", _not_cut, {}),
          ("self_filter", "background_subtract", _cut_grown, {}),
          ("self_filter", "_multi_plane_ransac", _plane_off, {}),
          ("self_filter", "_multi_plane_ransac", _plane_dropped, {}),
          ("segmentation", "_exact_components", _components_capped, {"h": 240, "w": 320, "ring_frames": 1})]


@pytest.mark.parametrize("module, attr, fault, size", FAULTS, ids=[f[2].__name__ for f in FAULTS])
def test_a_fault_reads_as_not_correct(monkeypatch, module, attr, fault, size):
    import importlib

    owner = importlib.import_module(f"mapping_private_tpu_torch.realtime.{module}")
    monkeypatch.setattr(owner, attr, fault(getattr(owner, attr)))
    res = run_small(seconds=0.05, **size)
    assert not res["correct"], res["checks"]


def test_the_cap_splits_a_plane_where_the_exact_labels_do_not():
    """At 240 x 320 the sound run joins what 256 sweeps leave split."""
    res = run_small(seconds=0.05, h=240, w=320, ring_frames=1)
    assert res["correct"], res["checks"]


# -- the readers ---------------------------------------------------------------------------------
def reader(name):
    return harness.load_module("metrics", harness.reader_name("metrics", name)).read


def profile(kernels, frames=1):
    return {"busy_s": 0.0, "window_s": 1.0, "device_ops": [], "idle_gaps": [], "kernels": sorted(kernels),
            "frames": frames, "tap_times": {}}


@pytest.fixture
def records(monkeypatch):
    spans, counts = collections.deque(maxlen=RING), collections.deque(maxlen=RING)
    monkeypatch.setattr(metrics, "span_records", spans)
    monkeypatch.setattr(metrics, "count_records", counts)
    return spans, counts


def test_stage_spans_and_rounds_of_the_window(records):
    spans, counts = records
    a = T0 + 10 * MS
    spans.extend([SpanRecord("selffilter.render", "selffilter", 0, T0 - 900 * MS, T0 - 800 * MS),  # earlier
                  # a frame's host work starts before its first device event
                  SpanRecord("selffilter", None, 1, T0 - 20 * MS, a + 200 * MS),
                  SpanRecord("selffilter.render", "selffilter", 1, T0 - 20 * MS, a + 90 * MS),
                  SpanRecord("selffilter.ransac", "selffilter", 1, a + 100 * MS, a + 120 * MS),
                  SpanRecord("selffilter.segment", "selffilter", 1, a + 130 * MS, a + 190 * MS)])
    counts.extend([CountRecord("segment.component_rounds", 17, a + 180 * MS),
                   CountRecord("segment.component_rounds", 99, T0 - 900 * MS),
                   CountRecord("selffilter.ransac_rounds", 6, a + 120 * MS)])
    tr = harness.Trace({}, {}, profile([(T0, 1e-3, "k"), (a + 250 * MS, 1e-3, "k")], frames=2))
    assert reader("render_ms")(tr) == pytest.approx(60.0)
    assert reader("ransac_ms")(tr) == pytest.approx(10.0)
    assert reader("segment_ms")(tr) == pytest.approx(30.0)
    assert reader("component_rounds")(tr) == pytest.approx(8.5)
    spans.clear()
    counts.clear()
    for name in ("render_ms", "ransac_ms", "segment_ms", "component_rounds", "selffilter_host_reads"):
        assert reader(name)(tr) is None
        assert reader(name)(harness.Trace({}, {}, None)) is None


def test_selffilter_host_reads_counts_copies_inside_the_span(records):
    spans, _ = records
    a, b = T0 + 100 * MS, T0 + 300 * MS
    spans.extend([SpanRecord("selffilter", None, 0, a, b),
                  SpanRecord("selffilter.render", "selffilter", 0, a, a + 50 * MS)])
    kernels = [(a + 1, 1e-3, "k"), (a - 1, 1e-6, "Memcpy DtoH (Device -> Pageable)"),
               (a + 20 * MS, 1e-6, "Memcpy DtoH (Device -> Pageable)"),
               (a + 150 * MS, 1e-6, "Memcpy DtoH (Device -> Pinned)"),
               (a + 160 * MS, 1e-6, "Memcpy HtoD (Pageable -> Device)"),
               (b + 1, 1e-6, "Memcpy DtoH (Device -> Pageable)"),  # the result's own read, after the span
               (b + 50 * MS, 1e-3, "k")]
    assert reader("selffilter_host_reads")(harness.Trace({}, {}, profile(kernels))) == 2


def test_the_cells_metrics():
    e2e, layer = harness.cell_metrics(BENCH, CELL)
    assert {m["name"] for m in e2e} == {"setup_s", "frames_per_s"}
    assert {m["name"] for m in layer} == {"render_ms", "ransac_ms", "segment_ms", "component_rounds",
                                          "selffilter_host_reads", "device_idle.selffilter"}
    assert all(m["moves"] == "frames_per_s" and m["workloads"] == [CELL] for m in layer)
    for cell in ("scan20k.pairs", "tabletop.frames"):  # the cells before it report none of them
        assert not {m["name"] for m in harness.cell_metrics(BENCH, cell)[1]} & {m["name"] for m in layer}


@pytest.mark.parametrize("z_extra, followed", [(0.01002, True), (0.0105, False)])
def test_a_plane_pick_is_followed_only_where_rounding_explains_it(z_extra, followed):
    """Hypothesis 1 (the plane z = 0.001) beats the judged side's pick,
    hypothesis 0 (z = 0), by one pixel: one 2e-5 m past plane 0's band
    edge (within PLANE_TIE_M: followed) or 5e-4 m past it (not)."""
    from perfbench.references import selffilter_frames as ref

    xy = np.stack(np.meshgrid(np.arange(6.0), np.arange(6.0)), -1).reshape(-1, 2) * 0.01
    xyz = np.c_[xy, np.zeros(len(xy))]
    xyz[1, 2], xyz[2, 2] = 0.001, z_extra
    n = len(xyz)
    c = {"xyz": torch.tensor(xyz), "normals": torch.tensor([[0.0, 0.0, 1.0]] * n, dtype=torch.float64)}
    judged = {"mask": np.ones(n, bool), "labels": np.full(n, -1), "count": 1, "seeds": np.array([0])}
    u = np.array([[0.5 / n, 1.5 / n]], np.float32)
    got = ref.planes_follow(c, judged, u, {"max_planes": 1, "plane_threshold_m": 0.01, "min_coverage": 0.9})
    assert got["count"] == 1 and got["planes"][0][3] == pytest.approx(0.0 if followed else -0.001)
    assert 2e-5 < ref.PLANE_TIE_M < 5e-4
