"""Port parity: models/hough_eval.py against the JAX package.

The same segments and ground truth go through both packages' matching,
statistics, aggregation, repeatability and markdown report; everything is
host numpy, so results are equal (floats to the last bit, the report byte
for byte).  The dataclasses carry across by field name
(``port_cls(**dataclasses.asdict(jax_obj))``)."""
import dataclasses

import jax
import numpy as np
import torch
from jax_ref import hough_uniforms, one_torch_thread  # noqa: F401 (fixture)
from test_hough import _tabletop_scene

from mapping_private_tpu.core import PointCloud as JCloud
from mapping_private_tpu.fit.box import OrientedBox as JBox
from mapping_private_tpu.models import hough_eval as je
from mapping_private_tpu.models import hough_segmentation as jh
from mapping_private_tpu_torch.core.cloud import PointCloud as TCloud
from mapping_private_tpu_torch.fit.box import OrientedBox as TBox
from mapping_private_tpu_torch.models import hough_eval as te
from mapping_private_tpu_torch.models import hough_segmentation as th

# (kind, size class, centre, radius or extents, inliers); a cylinder's
# centre is (x, y, z_min, z_max)
SEGMENTS = [
    ("cylinder", "medium", (0.8, 0.5, 0.0, 0.3), 0.04, 100),
    ("cuboid", "short", (0.3, 0.2, 0.09), (0.2, 0.12, 0.18), 120),
    ("box", "short", (0.62, 0.1, 0.07), (0.1, 0.08, 0.14), 60),
    ("cylinder", "short", (0.86, 0.5, 0.0, 0.3), 0.05, 90),  # near "a" and "b"
    ("cylinder", "medium", (5.0, 5.0, 0.0, 0.3), 0.04, 70),  # a false positive
    ("plane", "flat", (0.4, 0.4, 0.0), (0.8, 0.6, 0.01), 400),
]


def _segments(pkg):
    hs, box = (jh, JBox) if pkg == "jax" else (th, TBox)
    as_arr = np.asarray if pkg == "jax" else (lambda a: torch.tensor(np.asarray(a, np.float32)))
    out = []
    for kind, size, c, dim, n in SEGMENTS:
        if kind == "cylinder":
            out.append(hs.HoughSegment(kind=kind, size_class=size, inliers=np.zeros(8, bool), num_inliers=n,
                                       cylinder=(np.array(c[:2], np.float32), dim, c[2], c[3])))
        else:
            out.append(hs.HoughSegment(kind=kind, size_class=size, inliers=np.zeros(8, bool), num_inliers=n,
                                       box=box(center=as_arr(np.array(c, np.float32)), axes=as_arr(np.eye(3, dtype=np.float32)),
                                               extents=as_arr(np.array(dim, np.float32)))))
    return out


def _ground_truth(pkg):
    ev = je if pkg == "jax" else te
    return [
        ev.GroundTruthObject("cyl", "cylinder", np.array([0.8, 0.5, 0.15]), "medium", radius=0.04),
        ev.GroundTruthObject("a", "cylinder", np.array([0.80, 0.52, 0.15]), "short", radius=0.05),
        ev.GroundTruthObject("b", "cylinder", np.array([0.88, 0.5, 0.15]), "short", radius=0.05),
        ev.GroundTruthObject("box", "cuboid", np.array([0.3, 0.2, 0.09]), "short", extents=np.array([0.2, 0.12, 0.18])),
        ev.GroundTruthObject("small", "cuboid", np.array([0.6, 0.1, 0.07]), "medium",
                             extents=np.array([0.1, 0.08, 0.14])),
        ev.GroundTruthObject("missed", "cylinder", np.array([9.0, 9.0, 0.15]), "medium", radius=0.04),
    ]


def _index(segs, seg):
    return None if seg is None else next(i for i, s in enumerate(segs) if s is seg)


def _match_key(results, segs):
    nan_free = lambda x: "nan" if np.isnan(x) else x  # noqa: E731
    return [(r.gt.name, _index(segs, r.segment), r.centroid_error, r.kind_correct, r.size_class_correct,
             nan_free(r.dimension_error)) for r in results]


def test_segment_centroid_matches():
    for sj, st in zip(_segments("jax"), _segments("torch")):
        np.testing.assert_array_equal(te.segment_centroid(st), je.segment_centroid(sj))


def test_match_scene_matches():
    sj, st = _segments("jax"), _segments("torch")
    rj, fj = je.match_scene(sj, _ground_truth("jax"))
    rt, ft = te.match_scene(st, _ground_truth("torch"))
    assert _match_key(rt, st) == _match_key(rj, sj)
    assert any(r.segment is None for r in rt) and any(not np.isnan(r.dimension_error) for r in rt)
    assert [_index(st, s) for s in ft] == [_index(sj, s) for s in fj]


def _stats(pkg, scene="s"):
    ev = je if pkg == "jax" else te
    return ev.evaluate_scene(scene, _segments(pkg), _ground_truth(pkg))


def test_scene_stats_aggregate_and_markdown_match():
    sj, st = [_stats("jax", n) for n in ("s1", "s2")], [_stats("torch", n) for n in ("s1", "s2")]
    for a, b in zip(sj, st):
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
    agg_j, agg_t = je.aggregate(sj), te.aggregate(st)
    assert agg_t == agg_j
    repeat = {"s1": {"cyl": 1.0, "box": 2 / 3}}
    assert te.to_markdown(agg_t, st, repeat) == je.to_markdown(agg_j, sj, repeat)
    assert te.to_markdown(agg_t, st) == je.to_markdown(agg_j, sj)


def test_repeatability_matches():
    def run_fn(pkg):
        segs = _segments(pkg)
        return lambda r: segs[: 6 - 2 * r]

    assert te.repeatability(run_fn("torch"), _ground_truth("torch"), 3) == je.repeatability(
        run_fn("jax"), _ground_truth("jax"), 3)


def test_dataclasses_carry_across():
    for gt in _ground_truth("jax"):
        port = te.GroundTruthObject(**dataclasses.asdict(gt))
        assert repr(port).replace("mapping_private_tpu_torch", "") == repr(gt).replace("mapping_private_tpu", "")
    stats = _stats("jax")
    port_stats = te.SceneStats(**dataclasses.asdict(stats))
    agg = je.aggregate([stats])
    assert te.to_markdown(te.aggregate([port_stats]), [port_stats]) == je.to_markdown(agg, [stats])


def test_live_segmentation_report_matches():
    """Both packages segment the synthetic scene with the same draws; the
    statistics and the report agree."""
    pts, _, _ = _tabletop_scene()
    cfg = dict(max_objects=4, min_inliers=80)
    key = jax.random.PRNGKey(0)
    segs_j = jh.hough_segment(JCloud.from_numpy(pts), key, jh.HoughConfig(**cfg))
    segs_t = th.hough_segment(TCloud.from_numpy(pts, device="cpu"), None, th.HoughConfig(**cfg),
                              u=hough_uniforms(key, 4, 512))
    gts = lambda ev: [  # noqa: E731
        ev.GroundTruthObject("cyl", "cylinder", np.array([0.8, 0.5, 0.275]), "medium", radius=0.04),
        ev.GroundTruthObject("box", "cuboid", np.array([0.4, 0.26, 0.09]), "short",
                             extents=np.array([0.2, 0.12, 0.18]))]
    sj, st = je.evaluate_scene("synthetic", segs_j, gts(je)), te.evaluate_scene("synthetic", segs_t, gts(te))
    assert st.n_detected == sj.n_detected == 2 and st.n_kind_correct == sj.n_kind_correct == 2
    np.testing.assert_allclose(st.centroid_errors, sj.centroid_errors, rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.dimension_errors, sj.dimension_errors, rtol=0, atol=1e-5)
    assert te.aggregate([st]) == je.aggregate([sj])  # rounded to 4 places
