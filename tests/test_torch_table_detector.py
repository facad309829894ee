"""Port parity: models/table_detector.py (``detect_table``, the whole
tabletop slice) against the JAX package, the RANSAC uniforms carried
across (``tests/jax_ref.py``: the candidates' split keys).

Scenes: tests/test_table_detector.py's ``synthetic_table_scene`` (a table
with two objects, floor and wall) at a 2,048-row downsample (leaf 0.05,
so the wall does not spill the table out of the capacity; objects of 5+
voxels), its two-table scene for the wanted-table gate, and a scene with
no table.  Required: the same ``found`` and object count, the plane
within 1e-4, the downsampled rows identical, and the table inliers and
object masks equal except at points within 1e-5 of a threshold (the SAC
distance, the height gate above the table).  Seed 2's two objects have
the same size, so their order rests on ``top_clusters``' tie rule."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax_ref import detect_table_uniforms
from test_table_detector import synthetic_table_scene

from mapping_private_tpu.core.cloud import PointCloud as JCloud
from mapping_private_tpu.models import table_detector as jtd
from mapping_private_tpu_torch.core.cloud import PointCloud as TCloud
from mapping_private_tpu_torch.models import table_detector as ttd

SMALL = dict(down_capacity=2048, sac_hypotheses=128, leaf_size=0.05, object_cluster_min_pts=5)


def _run_both(xyz, seed, **cfg_kw):
    jc = JCloud.from_numpy(xyz)
    tc = TCloud.from_arrays(np.asarray(jc.xyz), np.asarray(jc.mask), device="cpu")
    jcfg, tcfg = jtd.TableDetectorConfig(**cfg_kw), ttd.TableDetectorConfig(**cfg_kw)
    assert dataclasses.asdict(jcfg) == pytest.approx(dataclasses.asdict(tcfg), rel=1e-15)
    key = jax.random.PRNGKey(seed)
    u = torch.tensor(detect_table_uniforms(key, jcfg))
    assert u.shape == ttd.table_uniforms_shape(tcfg)
    jdet, jdown = jtd.detect_table(jc, key, jcfg)
    tdet, tdown = ttd.detect_table(tc, None, tcfg, u=u)
    return jdet, jdown, tdet, tdown, tcfg


def _near_threshold(jdet, jdown, cfg):
    """Rows of the downsampled cloud within 1e-5 of the SAC distance or of
    the height gate above the table."""
    xyz = np.asarray(jdown.padded_xyz()).astype(np.float64)
    plane = np.asarray(jdet.plane).astype(np.float64)
    dist = np.abs(xyz @ plane[:3] + plane[3])
    gate = float(np.asarray(jdet.table_max)[2]) + cfg.delta_z
    return (np.abs(dist - cfg.sac_distance_threshold) < 1e-5) | (np.abs(xyz[:, 2] - gate) < 1e-5)


def _check(jdet, jdown, tdet, tdown, cfg):
    np.testing.assert_array_equal(tdown.mask.numpy(), np.asarray(jdown.mask))
    np.testing.assert_allclose(tdown.xyz.numpy(), np.asarray(jdown.xyz), rtol=0, atol=1e-6)
    assert bool(tdet.found) == bool(jdet.found)
    assert int(tdet.num_objects()) == int(jdet.num_objects())
    np.testing.assert_allclose(tdet.plane.numpy(), np.asarray(jdet.plane), rtol=0, atol=1e-4)
    ok = ~_near_threshold(jdet, jdown, cfg)
    np.testing.assert_array_equal(tdet.table_inliers.numpy()[ok], np.asarray(jdet.table_inliers)[ok])
    np.testing.assert_array_equal(tdet.object_masks.numpy()[:, ok], np.asarray(jdet.object_masks)[:, ok])
    np.testing.assert_array_equal(tdet.object_sizes.numpy(), np.asarray(jdet.object_sizes))
    live = np.asarray(jdet.object_sizes) > 0
    for f in ("object_centers", "object_min", "object_max"):
        np.testing.assert_allclose(getattr(tdet, f).numpy()[live], np.asarray(getattr(jdet, f))[live],
                                   rtol=0, atol=1e-5)
    for f in ("table_min", "table_max"):
        np.testing.assert_allclose(getattr(tdet, f).numpy(), np.asarray(getattr(jdet, f)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tdet.hull.center.numpy(), np.asarray(jdet.hull.center), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tdet.hull.radii.numpy(), np.asarray(jdet.hull.radii), rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 2])
def test_detect_table_matches_on_synthetic_scene(seed):
    out = _run_both(synthetic_table_scene(seed), seed, **SMALL)
    _check(*out)
    tdet = out[2]
    assert bool(tdet.found) and int(tdet.num_objects()) == 2
    z0 = -float(tdet.plane[3]) / float(tdet.plane[2])
    assert abs(z0 - 0.75) < 0.02
    centres = tdet.object_centers.numpy()[tdet.object_sizes.numpy() > 0]
    centres = centres[np.argsort(centres[:, 0])]
    np.testing.assert_allclose(centres[:, :2], [[-0.25, -0.2], [0.2, 0.1]], atol=0.05)


def _two_tables():
    """tests/test_table_detector.py::test_wanted_table_gate's scene."""
    rng = np.random.default_rng(3)
    ta = rng.uniform([-0.6, -0.5], [0.6, 0.5], (5000, 2))
    A = np.column_stack([ta, np.full(len(ta), 0.75) + rng.normal(0, 0.002, len(ta))])
    tb = rng.uniform([2.2, -0.3], [2.8, 0.3], (2500, 2))
    B = np.column_stack([tb, np.full(len(tb), 0.90) + rng.normal(0, 0.002, len(tb))])
    return np.vstack([A, B]).astype(np.float32)


@pytest.mark.parametrize("gate, z_want", [(None, 0.75), (((2.5, 0.0), 0.5), 0.90), (((9.0, 9.0), 0.25), None)])
def test_detect_table_wanted_table_gate_matches(gate, z_want):
    kw = dict(down_capacity=2048, sac_hypotheses=128)
    if gate is not None:
        kw.update(wanted_table_center=gate[0], max_sqr_dist_to_wanted_table=gate[1])
    out = _run_both(_two_tables(), 0, **kw)
    _check(*out)
    tdet = out[2]
    assert bool(tdet.found) == (z_want is not None)
    if z_want is not None:
        assert abs(-float(tdet.plane[3]) / float(tdet.plane[2]) - z_want) < 0.03


def test_detect_table_no_table_matches():
    rng = np.random.default_rng(5)
    xyz = rng.uniform([-2, -2, 0], [2, 2, 3], (3000, 3)).astype(np.float32)
    out = _run_both(xyz, 1, down_capacity=2048, sac_hypotheses=128)
    _check(*out)
    assert not bool(out[2].found) and int(out[2].num_objects()) == 0


def test_detect_table_draws_from_generator():
    """Without ``u`` the detector draws from the generator: one seed, one
    result; and it finds the table."""
    xyz = synthetic_table_scene(0)
    cfg = ttd.TableDetectorConfig(**SMALL)
    runs = [ttd.detect_table(TCloud.from_numpy(xyz, device="cpu"), torch.Generator().manual_seed(4), cfg)[0]
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0].plane.numpy(), runs[1].plane.numpy())
    assert bool(runs[0].found) and int(runs[0].num_objects()) == 2
