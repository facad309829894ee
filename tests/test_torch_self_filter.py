"""The robot self-filter's per-frame entry (``realtime/self_filter.py``) and
the exact connected components of ``segment_normal_image``.

At 80 x 60 with a two-link robot (a box and a 600-triangle STL finger) over
a three-plane scene (wall, floor, table top), frames made by the
benchmark's plain float64 reference (``perfbench/references/
selffilter_frames.py``):

- ``KinectSelfFilter.process`` against that reference, each number within
  a tolerance stated where it is checked;
- the entry's results equal, bit for bit, to the port's functions called
  one at a time (``render_robot_depth``, ``background_subtract``, the
  smoothing, unprojection and normals, ``multi_plane_ransac`` on the same
  uniforms, ``segment_normal_image``);
- its spans and counters.

The components: exact against scipy's on serpentines that the capped
256-sweep loop leaves split, and ``segment_normal_image`` equal to the JAX
package's wherever the JAX loop converges."""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.csgraph
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.realtime import segmentation as js
from mapping_private_tpu_torch.realtime import depth as td, segmentation as ts, urdf as tu
from mapping_private_tpu_torch.realtime.self_filter import KinectSelfFilter, SelfFilterSettings
from mapping_private_tpu_torch.utils.metrics import metrics
from perfbench.pipelines.selffilter_frames import write_stl
from perfbench.references import selffilter_frames as ref
from perfbench.scenes import selffilter as scene

REPO = pathlib.Path(__file__).resolve().parent.parent
H, W = 60, 80
URDF = """<robot name="two_links">
  <link name="base">
    <collision><origin xyz="0 0 0.4"/><geometry><box size="0.12 0.12 0.8"/></geometry></collision>
  </link>
  <link name="finger">
    <collision><geometry><mesh filename="package://meshes/finger.stl" scale="4 4 4"/></geometry></collision>
  </link>
  <joint name="lift" type="revolute">
    <parent link="base"/><child link="finger"/><origin xyz="0 0 0.8"/><axis xyz="0 1 0"/>
  </joint>
</robot>"""


def small_cfg():
    """The cell's configuration at 80 x 60 with a two-link robot of 612
    triangles and a three-plane scene; the robot at (-0.5, 0.2) in front of
    the table, its finger reaching over it (2.3-3% of the pixels)."""
    cfg = json.loads((REPO / "perfbench/configs/selffilter_vga.json").read_text())
    geo = cfg["scene_geometry"]
    return dict(cfg, image_shape=[H, W], focal_px=525.0 * W / 640, ring_frames=4,
                robot=dict(cfg["robot"], urdf=URDF.split("\n"), root_xyz_yaw=[-0.5, 0.2, 0.0, -0.3],
                           meshes={"meshes/finger.stl": {"finger": [20, 14]}}),
                trajectory={"lift": [0.3, 0.9]}, jitter_rad={"lift": 0.02},
                scene_geometry=dict(geo, boxes=geo["boxes"][:3], cylinders=[]),
                filter=dict(cfg["filter"], num_hypotheses=128, max_planes=4))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = small_cfg()
    ring = scene.make_ring(cfg, 2**31 + 7)
    d = tmp_path_factory.mktemp("robot")
    (d / "meshes").mkdir()
    write_stl(str(d / "meshes/finger.stl"), ring["meshes"]["meshes/finger.stl"])
    robot = tu.parse_urdf("\n".join(cfg["robot"]["urdf"]), mesh_root=str(d))
    f = cfg["focal_px"]
    sf = KinectSelfFilter(robot, ring["camera_from_root"], (H, W), f, f, SelfFilterSettings(**cfg["filter"]),
                          device="cpu")
    return cfg, ring, robot, sf


def test_the_small_robot_and_scene(setup):
    cfg, ring, robot, sf = setup
    assert len(robot.links) == 2 and sum(len(t) for _, _, t in sf._meshes) == 612
    for d, r in zip(ring["frames"], ring["robot_depth"]):
        assert d.shape == (H, W) and d.dtype == np.float32 and (d > 0).mean() > 0.95
        assert ((r > 0) & (np.abs(d - r) < 0.01)).mean() > 0.02  # the robot seen on the frame


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_process_matches_the_plain_reference(setup, seed):
    """Tolerances: the silhouette and the cut on at most one pixel (an edge
    through a pixel centre within float32 rounding), the robot's depth and
    the smoothed depth within 1e-5 relative (float32 edge functions, 1/z
    interpolation and blur sums: ~1e-6), the same plane count, planes within
    1e-4 rad and 1e-4 m (image normals from float32 neighbour differences),
    plane labels on 1% of the live pixels (a pixel within float32 rounding
    of the 1 cm band's edge; one pixel is 0.05% here) and segments on 1%
    (a pixel whose mean-shifted normal sits on the bandwidth)."""
    cfg, ring, _, sf = setup
    gen = torch.Generator().manual_seed(seed)
    got = []
    for j in range(len(ring["frames"])):
        out = sf.process(ring["frames"][j], ring["joints"][j], gen)
        got.append(ref.program_answers({"j": j, "keep": out.keep.numpy(), "planes": out.planes.numpy(),
                                        "labels": out.plane_labels.numpy(), "count": int(out.plane_count),
                                        "segments": out.segments.numpy(), "out": out}))
    want = ref.reference_answers(cfg, ring, got, "cpu", judged=got)
    gaps = ref.compare(cfg, got, want)
    px = 1.0 / (H * W)
    assert gaps["silhouette_share"] <= px and gaps["cut_share"] <= px
    assert gaps["render_rel"] <= 1e-5 and gaps["smooth_rel"] <= 1e-5
    assert gaps["plane_count_differ"] == 0 and min(g["count"] for g in got) >= 2
    assert gaps["plane_angle_rad"] <= 1e-4 and gaps["plane_offset_m"] <= 1e-4
    assert gaps["plane_label_share"] <= 0.01 and gaps["segment_share"] <= 0.01


def test_process_equals_the_functions_one_at_a_time(setup):
    cfg, ring, robot, sf = setup
    s, f, j = sf.settings, cfg["focal_px"], 2
    out = sf.process(ring["frames"][j], ring["joints"][j], torch.Generator().manual_seed(5))
    robot_d = tu.render_robot_depth(robot, ring["camera_from_root"], (H, W), f, f, ring["joints"][j], device="cpu")
    meas = torch.from_numpy(ring["frames"][j])
    keep = td.background_subtract(meas, torch.from_numpy(robot_d), s.margin_m)
    depth = td.smooth_depth_image(torch.where(keep, meas, 0.0), s.smooth_iterations)
    pts, valid = td.depth_to_cloud(depth, fx=f, fy=f)
    nimg = ts.fast_normals_image(pts, valid)
    mask = valid & (torch.linalg.vector_norm(nimg, dim=-1) > 0.5)
    u = torch.rand((s.max_planes, s.num_hypotheses), generator=torch.Generator().manual_seed(5))
    planes, labels, count = ts.multi_plane_ransac(pts.reshape(-1, 3), nimg.reshape(-1, 3), mask.reshape(-1), None,
                                                  s.num_hypotheses, s.max_planes, s.plane_threshold_m,
                                                  s.min_coverage, u=u)
    seg = ts.segment_normal_image(nimg, mask, s.range_bandwidth, s.min_segment_px)
    for a, b in [(out.robot_depth, torch.from_numpy(robot_d)), (out.keep, keep), (out.depth, depth),
                 (out.normals, nimg), (out.mask, mask), (out.uniforms, u), (out.planes, planes),
                 (out.plane_labels, labels), (out.plane_count, count), (out.segments, seg)]:
        assert torch.equal(a, b)
    seeds = out.plane_seeds[: int(count)]
    assert torch.equal(out.planes[: int(count), :3], nimg.reshape(-1, 3)[seeds])


def test_spans_only_while_tracing_and_counters_always(setup):
    _, ring, _, sf = setup
    names = {"selffilter", "selffilter.render", "selffilter.cut", "selffilter.ransac", "selffilter.segment"}
    before = len(metrics.span_records), dict(metrics.counters)
    sf.process(ring["frames"][0], ring["joints"][0], torch.Generator().manual_seed(1))
    assert len(metrics.span_records) == before[0]
    for name in ("selffilter.ransac_rounds", "segment.component_rounds"):
        assert metrics.counters[name] > before[1].get(name, 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        sf.process(ring["frames"][0], ring["joints"][0], torch.Generator().manual_seed(1))
    recs = list(metrics.span_records)[before[0]:]
    assert {r.name for r in recs} == names
    assert all(r.parent == "selffilter" for r in recs if r.name != "selffilter")


def test_an_empty_robot_cuts_nothing():
    sf = KinectSelfFilter(tu.RobotModel("none", {}, [], "base"), np.eye(4), (12, 16), 20.0, 20.0,
                          SelfFilterSettings(num_hypotheses=16, max_planes=2), device="cpu")
    depth = np.full((12, 16), 1.5, np.float32)
    out = sf.process(depth, None, torch.Generator().manual_seed(0))
    assert bool(out.keep.all()) and bool((out.robot_depth == 0).all()) and int(out.plane_count) >= 1


# -- exact components ------------------------------------------------------------------------
def scipy_labels(right, down, valid):
    h, w = valid.shape
    idx = np.arange(h * w).reshape(h, w)
    a = np.concatenate([idx[:, :-1][right], idx[:-1][down]])
    b = np.concatenate([idx[:, 1:][right], idx[1:][down]])
    g = scipy.sparse.coo_matrix((np.ones(len(a)), (a, b)), shape=(h * w, h * w))
    _, comp = scipy.sparse.csgraph.connected_components(g, directed=False)
    least = np.full(comp.max() + 1, h * w)
    np.minimum.at(least, comp, np.arange(h * w))
    return np.where(valid.reshape(-1), least[comp], h * w).reshape(h, w)


def serpentine(h, w, width):
    """A path ``width`` pixels wide winding through every other band of
    rows: about h·w / (2 width) pixels long."""
    valid = np.zeros((h, w), bool)
    for k, r in enumerate(range(0, h, 2 * width)):
        valid[r : r + width] = True
        c = slice(w - width, w) if k % 2 == 0 else slice(0, width)
        valid[r + width : r + 2 * width, c] = True
    return valid


@pytest.mark.parametrize("h,w,width", [(48, 64, 1), (60, 80, 2), (37, 90, 3)])
def test_exact_components_join_what_the_capped_loop_splits(h, w, width):
    valid = serpentine(h, w, width)
    right, down = valid[:, :-1] & valid[:, 1:], valid[:-1] & valid[1:]
    got, rounds = ts._exact_components(torch.from_numpy(right), torch.from_numpy(down), torch.from_numpy(valid))
    want = scipy_labels(right, down, valid)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and len(np.unique(want[valid])) == 1 and (got.numpy()[~valid] == h * w).all()
    assert rounds < 30
    adj = np.zeros((h, w, 4), bool)  # the same graph for the capped loop: up, down, left, right
    adj[1:, :, 0], adj[:-1, :, 1], adj[:, 1:, 2], adj[:, :-1, 3] = down, down, right, right
    capped = ts.connected_components_image(torch.from_numpy(adj), torch.from_numpy(valid), 256).numpy()
    assert len(np.unique(capped[valid])) > 1  # 256 sweeps leave it split


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_components_random_graphs(seed):
    rng = np.random.default_rng(seed)
    valid = rng.random((40, 56)) < 0.9
    right = (rng.random((40, 55)) < 0.6) & valid[:, :-1] & valid[:, 1:]
    down = (rng.random((39, 56)) < 0.6) & valid[:-1] & valid[1:]
    got, _ = ts._exact_components(torch.from_numpy(right), torch.from_numpy(down), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), scipy_labels(right, down, valid))


def snake_normals(h, w):
    """A normal image whose one segment of agreeing normals is a 1-pixel
    serpentine, on a background of normals that agree with nothing near."""
    valid = serpentine(h, w, 1)
    n = np.zeros((h, w, 3), np.float32)
    n[..., 2] = -1.0
    n[~valid] = [1.0, 0.0, 0.0]
    n[~valid & (np.add.outer(np.arange(h), np.arange(w)) % 2 == 1)] = [0.0, 1.0, 0.0]
    return n, np.ones((h, w), bool), valid


def test_segment_normal_image_converges_on_a_serpentine():
    n, valid, path = snake_normals(48, 64)
    seg, rounds = ts._segment(torch.from_numpy(n), torch.from_numpy(valid), 0.3, 30)
    seg = seg.numpy()
    assert len(np.unique(seg[path])) == 1 and seg[path][0] == np.flatnonzero(path)[0]
    assert (seg[~path] == 48 * 64).all() and rounds < 30
    capped = np.asarray(js.segment_normal_image(jnp.asarray(n), jnp.asarray(valid)))
    assert len(np.unique(capped[path])) > 1  # the JAX package's 256 sweeps leave it split


@pytest.mark.parametrize("seed,bw", [(4, 0.3), (5, 0.2), (6, 0.4)])
def test_segment_normal_image_matches_jax_where_it_converges(seed, bw):
    rng = np.random.default_rng(seed)
    n = np.zeros((48, 64, 3), np.float32)  # four quadrant planes with noisy normals
    for k, c in enumerate(([0, 0, -1], [0.6, 0, -0.8], [0, 0.6, -0.8], [-0.6, 0, -0.8])):
        n[(k // 2) * 24 : (k // 2 + 1) * 24, (k % 2) * 32 : (k % 2 + 1) * 32] = c
    n += rng.normal(0, 0.05, n.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    valid = rng.random((48, 64)) < 0.95
    nt, vt = torch.from_numpy(n), torch.from_numpy(valid)
    got, _ = ts._segment(nt, vt, bw, 30)
    m = ts.mean_shift_normals(nt, vt, bw)  # the capped loop's adjacency, as the JAX package builds it
    adj = [(((torch.roll(m, (-dy, -dx), (0, 1)) - m) ** 2).sum(-1) < bw * bw) & torch.roll(vt, (-dy, -dx), (0, 1))
           for dy, dx in ts._SHIFTS]
    _, sweeps = ts._components(torch.stack(adj, -1), vt, 256)
    assert sweeps < 256  # the capped loop converges here
    want = np.asarray(js.segment_normal_image(jnp.asarray(n), jnp.asarray(valid), range_bandwidth=bw))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[want < 48 * 64])) >= 3
