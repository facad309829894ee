"""Port parity: pipeline/config.py, dag.py and acquisition.py against the
JAX package.

Configs, the registry's names, the stage wiring and its errors, and the
acquisition helpers are the same host code: compared equal.  Stage
outputs are the port's ops against the JAX ops, with the tolerances of
those ops' own parity tests: downsampled points within 1e-6, normals
|n_t · n_j| ≥ 1 − 1e-5 on rows whose neighbourhood is not degenerate,
boxes within 1e-5, MLS points within 1e-5, the denoise's mask equal;
the RANSAC stages with the JAX draws of ``PRNGKey(seed)`` passed as
``u``: the same cylinder within 1e-3 (tests/test_torch_fit.py's bound)
and the same inliers on ≥ 99% of rows.  The JAX pipelines run through
``Pipeline.jitted()`` (one compile, far cheaper than op by op)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.core import PointCloud as JCloud
from mapping_private_tpu.pipeline import acquisition as jacq, config as jcfg, dag as jdag
from mapping_private_tpu.realtime import depth as jdepth
from mapping_private_tpu_torch.core.cloud import PointCloud as TCloud
from mapping_private_tpu_torch.io.pcd import load_pcd_arrays
from mapping_private_tpu_torch.pipeline import acquisition as tacq, config as tcfg, dag as tdag


def cylinder_points(n=600, r=0.04, h=0.15, seed=0):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(0, h, n)
    pts = np.column_stack([0.3 + r * np.cos(ang), 0.2 + r * np.sin(ang), z])
    return (pts + rng.normal(0, 5e-4, pts.shape)).astype(np.float32)


def box_points(n=800, ext=(0.1, 0.06, 0.12), seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, (n, 3)) * ext
    ax = rng.integers(0, 3, n)
    pts[np.arange(n), ax] = rng.choice([-0.5, 0.5], n) * np.asarray(ext)[ax]
    return (pts + [0.6, 0.4, ext[2] / 2]).astype(np.float32)


def clouds(xyz):
    return JCloud.from_numpy(xyz), TCloud.from_numpy(xyz, device="cpu")


def test_registry_matches():
    assert tdag.registered_ops() == jdag.registered_ops()
    for name in tdag.registered_ops():
        t, j = tdag.get_op(name), jdag.get_op(name)
        assert (t.requires, t.provides, t.jittable) == (j.requires, j.provides, j.jittable)
    with pytest.raises(KeyError, match="not registered"):
        tdag.get_op("NoSuchOp")


def test_register_op_adds_to_the_port_registry_only():
    @tdag.register_op("TestScale", requires=("normal",))
    def _scale(cloud, factor: float = 2.0):
        return cloud.with_xyz(cloud.xyz * factor)

    try:
        assert "TestScale" in tdag.registered_ops() and "TestScale" not in jdag.registered_ops()
        assert tdag.get_op("TestScale").requires == ("normal",)
    finally:
        tdag._REGISTRY.pop("TestScale")


def box_chain():
    return [
        ("VoxelDownsample", "in", {"cloud": "down"}, {"leaf_size": 0.01, "capacity": 512}),
        ("NormalEstimation", "down", {"cloud": "normals"}, {"k": 12}),
        ("RobustBoxEstimation", "normals", {"model": "box"}, {}),
    ]


def stages(mod, chain):
    return [mod.Stage(op=op, input=inp, outputs=outs, params=dict(params), name=f"s{k}")
            for k, (op, inp, outs, params) in enumerate(chain)]


def assert_normals_close(nt, nj, live):
    dots = np.abs(np.sum(nt * nj, axis=1))[live]
    assert (dots >= 1 - 1e-5).mean() >= 0.98  # near-degenerate neighbourhoods may pick another vector


def test_box_chain_matches():
    jc, tc = clouds(box_points())
    out_j = jdag.Pipeline(stages(jdag, box_chain())).jitted()({"in": jc})  # one compile: cheaper
    out_t = tdag.Pipeline(stages(tdag, box_chain())).run({"in": tc})
    assert set(out_t) == set(out_j) == {"in", "down", "normals", "box"}
    live = np.asarray(out_j["down"].mask)
    np.testing.assert_array_equal(out_t["down"].mask.numpy(), live)
    np.testing.assert_allclose(out_t["down"].xyz.numpy()[live], np.asarray(out_j["down"].xyz)[live], atol=1e-6)
    assert_normals_close(out_t["normals"].channel("normal").numpy(), np.asarray(out_j["normals"].channel("normal")),
                         live)
    for f in ("center", "extents"):
        np.testing.assert_allclose(getattr(out_t["box"], f).numpy(), np.asarray(getattr(out_j["box"], f)), atol=1e-5)


def test_jitted_is_run_and_refuses_host_stages():
    jc, tc = clouds(box_points())
    pipe = tdag.Pipeline(stages(tdag, box_chain()))
    fn = pipe.jitted()
    assert fn == pipe.run
    np.testing.assert_array_equal(fn({"in": tc})["box"].extents.numpy(), pipe.run({"in": tc})["box"].extents.numpy())
    for mod in (tdag, jdag):
        with pytest.raises(ValueError, match="not jittable"):
            mod.Pipeline([mod.Stage(op="DepthImageTriangulation", input="in", outputs={"mesh": "m"})]).jitted()


def test_denoise_mls_and_cylinder_chain_matches():
    xyz = cylinder_points()
    xyz[:5] += 0.3  # outliers
    jc, tc = clouds(xyz)
    chain = [("StatisticalNoiseRemoval", "in", {"cloud": "denoised", "valid": "ok"}, {"k": 10, "alpha": 2.0}),
             ("MovingLeastSquares", "denoised", {"cluster": "smooth"}, {"search_radius": 0.02, "k": 16}),
             ("CylinderEstimation", "smooth", {"model": "cyl", "inliers": "inl", "outliers": "out"}, {"seed": 3})]
    out_j = jdag.Pipeline(stages(jdag, chain)).jitted()({"in": jc})
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (512, 2)))  # the JAX op's draws
    chain_t = chain[:2] + [(*chain[2][:3], {"seed": 3, "u": torch.tensor(u)})]
    out_t = tdag.Pipeline(stages(tdag, chain_t)).run({"in": tc})
    np.testing.assert_array_equal(out_t["denoised"].mask.numpy(), np.asarray(out_j["denoised"].mask))
    assert bool(out_t["ok"]) == bool(out_j["ok"]) and not out_t["denoised"].mask.numpy()[:5].any()
    live = np.asarray(out_j["smooth"].mask)
    np.testing.assert_allclose(out_t["smooth"].xyz.numpy()[live], np.asarray(out_j["smooth"].xyz)[live], atol=1e-5)
    ct, cj = out_t["cyl"], out_j["cyl"]
    assert np.linalg.norm(np.cross(ct.axis.numpy(), np.asarray(cj.axis))) < 1e-3
    assert abs(float(ct.radius) - float(cj.radius)) < 1e-3 and abs(float(ct.radius) - 0.04) < 0.005
    assert (out_t["inl"].mask.numpy() == np.asarray(out_j["inl"].mask)).mean() >= 0.99
    assert int(out_t["inl"].count()) + int(out_t["out"].count()) == int(out_t["smooth"].count())


def test_ransac_stages_with_the_generator():
    """Without ``u`` the RANSAC stages draw from a generator seeded with
    ``seed`` on the cloud's device: repeatable, and the right surfaces."""
    xyz = cylinder_points(seed=5)
    _, tc = clouds(xyz)
    chain = [("NormalEstimation", "in", {"cloud": "n"}, {"k": 12}),
             ("CylinderEstimation", "n", {"model": "cyl"}, {"seed": 1}),
             ("RotationalEstimation", "n", {"model": "rot", "inliers": "rinl"}, {"seed": 2})]
    pipe = tdag.Pipeline(stages(tdag, chain))
    a, b = pipe.run({"in": tc}), pipe.run({"in": tc})
    assert float(a["cyl"].radius) == float(b["cyl"].radius) and abs(float(a["cyl"].radius) - 0.04) < 0.005
    assert int(a["rinl"].count()) > 0.5 * len(xyz)


def test_stage_errors_match():
    jc, tc = clouds(cylinder_points())
    for mod, cloud in ((tdag, tc), (jdag, jc)):
        with pytest.raises(ValueError, match="required"):
            mod.Pipeline([mod.Stage(op="CylinderEstimation", input="in", outputs={"model": "m"})]).run({"in": cloud})
        with pytest.raises(ValueError, match="never produced"):
            mod.Pipeline([mod.Stage(op="MovingLeastSquares", input="nope", outputs={"cluster": "x"})]).run({"in": cloud})
        with pytest.raises(KeyError, match="returned no 'bogus'"):
            mod.Pipeline([mod.Stage(op="RobustBoxEstimation", input="in", outputs={"bogus": "x"})]).run({"in": cloud})


def test_depth_image_triangulation_stage_matches():
    d = np.full((12, 16), 1.0, np.float32)
    d[:, 8:] = 1.5  # a step the mesh must not bridge
    pj, vj = jdepth.depth_to_cloud(jnp.asarray(d), fx=100.0, fy=100.0)
    pt, vt = torch.from_numpy(np.asarray(pj)), torch.from_numpy(np.asarray(vj))
    stage = [("DepthImageTriangulation", "org", {"mesh": "mesh"}, {"max_edge": 0.05})]
    (vt_, tt_) = tdag.Pipeline(stages(tdag, stage)).run({"org": {"points": pt, "valid": vt}})["mesh"]
    (vj_, tj_) = jdag.Pipeline(stages(jdag, stage)).run({"org": {"points": pj, "valid": vj}})["mesh"]
    np.testing.assert_array_equal(vt_, vj_)
    np.testing.assert_array_equal(tt_, tj_)
    assert len(tt_) == 2 * 11 * 7 * 2


def test_pipeline_from_yaml_matches(tmp_path):
    y = tmp_path / "pipe.yaml"
    y.write_text(
        "smoothing:\n"
        "  class_name: MovingLeastSquares\n"
        "  input_topic_name: {name: table_clusters, subscribe: true}\n"
        "  output_topics:\n"
        "    cluster: {name: smooth, publish: false}\n"
        "  params: {search_radius: 0.02, k: 16}\n"
        "normals:\n"
        "  class_name: NormalEstimation\n"
        "  input_topic_name: smooth\n"
        "  output_topics: {cloud: with_normals}\n"
    )
    pt, pj = tdag.Pipeline.from_yaml(str(y)), jdag.Pipeline.from_yaml(str(y))
    assert [dataclasses.asdict(s) for s in pt.stages] == [dataclasses.asdict(s) for s in pj.stages]
    jc, tc = clouds(cylinder_points())
    out_t, out_j = pt.run({"table_clusters": tc}), pj.jitted()({"table_clusters": jc})
    live = np.asarray(out_j["smooth"].mask)
    assert_normals_close(out_t["with_normals"].channel("normal").numpy(),
                         np.asarray(out_j["with_normals"].channel("normal")), live)


@dataclasses.dataclass(frozen=True)
class Inner:
    radius: float = 0.1


@dataclasses.dataclass(frozen=True)
class Outer:
    a: int = 1
    b: float = 2.0
    c: bool = False
    name: str = "x"
    inner: Inner = Inner()


def test_configs_match(tmp_path):
    data = {"a": "5", "b": "0.5", "c": "yes", "name": "room", "inner": {"radius": "0.25"}}
    got, want = tcfg.config_from_dict(Outer, data), jcfg.config_from_dict(Outer, data)
    assert got == want == Outer(5, 0.5, True, "room", Inner(0.25))
    assert tcfg.config_to_dict(got) == jcfg.config_to_dict(want)
    for mod in (tcfg, jcfg):
        with pytest.raises(KeyError, match="unknown config key"):
            mod.config_from_dict(Outer, {"nope": 1})
        with pytest.raises(TypeError, match="not a dataclass"):
            mod.config_from_dict(dict, {})
    p = tmp_path / "parameters.txt"
    p.write_text("voxel_size: 0.02\ndim: 100\n# comment\nbox_size(scene): 10 # trailing\nno colon here\n")
    assert tcfg.load_param_txt(str(p)) == jcfg.load_param_txt(str(p)) == {
        "voxel_size": "0.02", "dim": "100", "box_size(scene)": "10"}
    y = tmp_path / "c.yaml"
    y.write_text("a: 3\nc: false\ninner: {radius: 0.5}\n")
    assert tcfg.load_yaml_config(Outer, str(y)) == jcfg.load_yaml_config(Outer, str(y)) == Outer(3, c=False,
                                                                                                  inner=Inner(0.5))


def test_approximate_time_sync_matches():
    rng = np.random.default_rng(2)
    events = [(int(rng.integers(0, 3)), float(t), k) for k, t in enumerate(np.sort(rng.uniform(0, 5, 200)))]
    got_cb, want_cb = [], []
    st = tacq.ApproximateTimeSync(3, slop=0.05, callback=lambda *v: got_cb.append(v), queue_size=10)
    sj = jacq.ApproximateTimeSync(3, slop=0.05, callback=lambda *v: want_cb.append(v), queue_size=10)
    for stream, stamp, val in events:
        st.push(stream, stamp, val)
        sj.push(stream, stamp, val)
    assert st.matched == sj.matched and got_cb == want_cb and len(st.matched) > 5


def test_scan_session_and_triggered_capture_match(tmp_path):
    def run(mod, out):
        moves = []
        rng = np.random.default_rng(0)

        def capture():
            return float(len(moves)), {"xyz": rng.normal(size=(50, 3)).astype(np.float32)}

        sess = mod.ScanSession(lambda pan, tilt: moves.append((pan, tilt)), capture, out_dir=str(out / "views"))
        views = sess.run_sweep(mod.SweepConfig(pan_start=-30, pan_end=30, pan_step=15, tilt=5))
        cap = mod.TriggeredCapture(str(out / "caps"), distance_th=0.5, relative=True)
        assert cap.trigger() is None
        xyz = rng.normal(size=(80, 3)).astype(np.float32)
        xyz[:4] = np.nan
        cap.push({"xyz": xyz, "intensity": np.arange(80, dtype=np.float32)})
        return moves, views, cap.trigger(), cap.last_bbox

    mt, vt, pt, bt = run(tacq, tmp_path / "t")
    mj, vj, pj, bj = run(jacq, tmp_path / "j")
    assert mt == mj and len(vt) == 5 and [v["pan"] for v in vt] == [v["pan"] for v in vj]
    for a, b in zip(vt, vj):
        assert open(a["path"], "rb").read() == open(b["path"], "rb").read()
    assert open(pt, "rb").read() == open(pj, "rb").read()
    np.testing.assert_array_equal(bt[0], bj[0])
    np.testing.assert_array_equal(bt[1], bj[1])


def test_hokuyo_lines_match(tmp_path):
    beam = np.array([0, 1, 2, 5, 1, 2, 3, 0, 0, 4], np.float32)
    np.testing.assert_array_equal(tacq.hokuyo_line_ids(beam), jacq.hokuyo_line_ids(beam))
    assert tacq.hokuyo_line_ids(np.zeros(0)).shape == (0,)
    from mapping_private_tpu_torch.io.pcd import save_pcd

    xyz = np.random.default_rng(1).normal(size=(10, 3)).astype(np.float32)
    save_pcd(str(tmp_path / "scan.pcd"), {"xyz": xyz, "index": beam})
    out_t = tacq.add_hokuyo_line_channel(str(tmp_path / "scan.pcd"), out_path=str(tmp_path / "t.pcd"))
    out_j = jacq.add_hokuyo_line_channel(str(tmp_path / "scan.pcd"), out_path=str(tmp_path / "j.pcd"))
    assert open(out_t, "rb").read() == open(out_j, "rb").read()
    np.testing.assert_array_equal(load_pcd_arrays(out_t)["line"], [0, 0, 0, 0, 1, 1, 1, 2, 2, 2])
    assert tacq.add_hokuyo_line_channel(out_t) == out_t  # already has one
    with pytest.raises(KeyError, match="has no 'beam' channel"):
        tacq.add_hokuyo_line_channel(str(tmp_path / "scan.pcd"), index_channel="beam")
