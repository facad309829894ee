"""Port parity: models/room_segmentation.py and the room_segment CLI
against the JAX package.

``segment_room`` and ``wall_filter`` get each wall's uniforms from the
JAX package's key chain (``tests/jax_ref.py::uniforms_from_jax``): labels
and kept rows identical, wall planes within 1e-5.  The CLIs draw from
different generators (JAX keys 0 and 1, torch generators seeded 0 and
1), so their outcomes are compared: floor and ceiling counts equal, the
same number of walls, each wall plane within 2e-3 of the JAX one (up to
sign) and the wall count within 1% of it."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import uniforms_from_jax, one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.apps import room_segment as jcli
from mapping_private_tpu.core import PointCloud as JCloud
from mapping_private_tpu.models import room_segmentation as jrs
from mapping_private_tpu_torch.apps import room_segment as tcli
from mapping_private_tpu_torch.core import PointCloud
from mapping_private_tpu_torch.io.pcd import load_pcd_arrays, save_pcd
from mapping_private_tpu_torch.models import room_segmentation as trs


def _room(seed=0, n=600, noise=0.002):
    """A 4 × 3 m room, 2.9 m high: floor, ceiling, two walls and a table
    top at 0.75 m (horizontal: wall extraction stops at it)."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, m=n: rng.uniform(lo, hi, m)  # noqa: E731
    floor = np.column_stack([u(0, 4), u(0, 3), np.zeros(n)])
    ceil = np.column_stack([u(0, 4), u(0, 3), np.full(n, 2.9)])
    wall_x = np.column_stack([np.zeros(n), u(0, 3), u(0.2, 2.6)])
    wall_y = np.column_stack([u(0, 4), np.full(n, 3.0), u(0.2, 2.6)])
    table = np.column_stack([u(1.5, 2.5, n // 2), u(1.0, 1.8, n // 2), np.full(n // 2, 0.75)])
    pts = np.vstack([floor, ceil, wall_x, wall_y, table])
    return (pts + rng.normal(0, noise, pts.shape)).astype(np.float32)


def _clouds(pts, dead_every=13):
    jc = JCloud.from_numpy(pts)
    jc = jc.select(jnp.arange(jc.capacity) % dead_every != 0)
    return jc, PointCloud.from_arrays(np.asarray(jc.xyz), np.asarray(jc.mask), device="cpu")


@pytest.mark.parametrize("seed,max_walls", [(0, 4), (1, 1)])
def test_segment_room_matches_jax(seed, max_walls):
    cfg = trs.RoomSegmentationConfig(max_walls=max_walls, num_hypotheses=64, min_wall_inliers=200)
    jcfg = jrs.RoomSegmentationConfig(max_walls=max_walls, num_hypotheses=64, min_wall_inliers=200)
    jc, tc = _clouds(_room(seed))
    key = jax.random.PRNGKey(seed)
    sj = jrs.segment_room(jc, key, jcfg)
    u = [torch.tensor(a) for a in uniforms_from_jax(key, [(64, 3)] * max_walls)]
    st = trs.segment_room(tc, cfg=cfg, u=u)
    assert st.labels.dtype == torch.int32
    np.testing.assert_array_equal(st.labels.numpy(), np.asarray(sj.labels))
    assert len(st.wall_planes) == len(sj.wall_planes) == min(max_walls, 2)
    for pt, pj in zip(st.wall_planes, sj.wall_planes):
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    lab = st.labels.numpy()[np.asarray(jc.mask)]
    assert (lab == trs.FLOOR).sum() > 500 and (lab == trs.CEILING).sum() > 500

    kj = jrs.wall_filter(jc, key, jcfg)
    kt = trs.wall_filter(tc, cfg=cfg, u=u)
    np.testing.assert_array_equal(kt.mask.numpy(), np.asarray(kj.mask))


def test_segment_room_with_generator_stops_at_horizontal():
    """Threaded generator: both walls found, then the table top (the
    dominant plane left) is horizontal and stops the extraction."""
    _, tc = _clouds(_room(2))
    st = trs.segment_room(tc, torch.Generator().manual_seed(0))
    assert len(st.wall_planes) == 2
    normals = np.abs(np.stack([p.numpy()[:3] for p in st.wall_planes]))
    assert sorted(normals.argmax(1).tolist()) == [0, 1]
    assert (st.labels.numpy()[-300:] == 0).all()  # the table stays unlabeled


def test_room_segment_cli_matches_jax(tmp_path, capsys):
    pts = _room(3)
    path = str(tmp_path / "room.pcd")
    save_pcd(path, {"xyz": pts})
    outs = {}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        lab, filt = str(tmp_path / f"{name}_lab.pcd"), str(tmp_path / f"{name}_filt.pcd")
        assert cli.main([path, "--out-labeled", lab, "--out-filtered", filt] + extra) == 0
        outs[name] = (json.loads(capsys.readouterr().out), load_pcd_arrays(lab), load_pcd_arrays(filt))
    (want, wlab, wfilt), (got, glab, gfilt) = outs["jax"], outs["torch"]
    assert got.keys() == want.keys() == {"counts", "wall_planes"}
    for k in ("floor", "ceiling"):
        assert got["counts"][k] == want["counts"][k] > 500
    assert abs(got["counts"]["walls"] - want["counts"]["walls"]) <= 0.01 * want["counts"]["walls"]
    assert len(got["wall_planes"]) == len(want["wall_planes"]) == 2
    for pw in want["wall_planes"]:
        d = [min(np.abs(np.subtract(pg, pw)).max(), np.abs(np.add(pg, pw)).max()) for pg in got["wall_planes"]]
        assert min(d) < 2e-3
    np.testing.assert_array_equal(glab["x"], wlab["x"])
    assert abs(len(gfilt["x"]) - len(wfilt["x"])) <= 0.01 * len(wfilt["x"])


def test_room_segment_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = str(tmp_path / "room.pcd")
    save_pcd(path, {"xyz": _room(4, n=100)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([path])
