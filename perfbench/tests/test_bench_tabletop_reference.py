"""The tabletop reference's denoise: taken once for each ring frame, it
gives the numbers of the chain that takes it for every record; and its box
test keeps a point on a face as the port's box filter does."""
import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tracing import Spans

BENCH = harness.load_bench()
SEED = 2**31 + 41


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_the_denoise_once_a_ring_frame_gives_the_chain_of_every_frame(monkeypatch):
    _, cfg, traffic = harness.load_cell(BENCH, "tabletop.frames")
    cfg = dict(cfg, points_per_frame=20000, ring_frames=4)
    ring = harness.load_module("scenes", cfg["scene"]).make_ring(cfg, SEED)
    stream = harness.load_module("pipelines", traffic["pipeline"]).Stream(
        cfg, traffic, ring, "cpu", Spans(False), SEED)
    warm = traffic["warmup_frames"]
    frames = warm + 2 * len(ring["frames"]) + 1  # the window runs round the ring twice and more
    for k in range(frames):
        stream.frame(k)
    records = stream.records
    ref = harness.load_module("references", traffic["reference"])
    calls, denoise_keep = [], ref.denoise_keep

    def counted(xyz, *a):
        calls.append(len(xyz))
        return denoise_keep(xyz, *a)

    monkeypatch.setattr(ref, "denoise_keep", counted)
    cached = ref.check(cfg, traffic, ring, records, warm, "cpu")
    assert len(calls) == len(ring["frames"])
    # every record its own ring frame: the denoise is taken again for each
    calls.clear()
    own = {"frames": [ring["frames"][r["j"]] for r in records]}
    per_frame = ref.check(cfg, traffic, own, [dict(r, j=i) for i, r in enumerate(records)], warm, "cpu")
    assert len(calls) == frames
    assert [(c["name"], c["value"]) for c in cached] == [(c["name"], c["value"]) for c in per_frame]
    assert all(c["value"] <= c["limit"] for c in cached), cached


def test_a_point_on_the_box_face_is_kept_as_the_port_keeps_it():
    from mapping_private_tpu_torch.ops.filters import box_filter_mask

    ref = harness.load_module("references", "tabletop_frames")
    _, cfg, _ = harness.load_cell(BENCH, "tabletop.frames")
    box = cfg["box"]
    face = np.float32(box[5])
    assert float(face) > box[5]  # in float64 the face point lies above the face
    g = np.random.default_rng(SEED)
    pts = np.column_stack([g.uniform(-0.1, 0.1, (300, 2)), g.uniform(1.5, 1.6, 300)]).astype(np.float32)
    pts[:3, 2] = face  # on the top face, in float32
    pts[3:6, 2] = np.nextafter(face, np.float32(2.0))  # just above it
    xyz = torch.as_tensor(pts)
    port = box_filter_mask(xyz, torch.ones(len(xyz), dtype=torch.bool), box[:3], box[3:]).numpy()
    _, live, margin = ref.denoise_keep(xyz.double(), box, 5, 2.0)
    inside = np.isfinite(margin.numpy())
    assert port[:3].all() and not port[3:6].any()
    assert np.array_equal(inside, port) and live == int(port.sum())
