"""Port parity: realtime/urdf.py against the JAX package, and the robot
self-filter slice as a whole (render the robot, cut its pixels from the
frame, smooth, unproject, normals, planes, segments) at 48 × 64.

Parsing, forward kinematics, STL loading and the link meshes are host
numpy in both packages and compare equal (poses within 1e-12).  The
robot's depth image: hit masks equal, depth within 1e-5 relative (the
rasteriser's tolerance, tests/test_torch_realtime.py).  The slice: the
self-filter mask equal, the smoothed depth within 1e-5 relative, planes
within 1e-4 (planes fitted to smoothed, rasterised depths: 1e-5 errors
in the depths move them by ~1e-5) and labels and segments equal on
≥ 99.9% of pixels."""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import multi_plane_uniforms, one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.realtime import depth as jd, render as jr, segmentation as js, urdf as ju
from mapping_private_tpu_torch.realtime import depth as td, render as tr, segmentation as ts, urdf as tu

H, W = 48, 64
F = 60.0


def write_binary_stl(path, tris):
    with open(path, "wb") as fp:
        fp.write(b"\0" * 80)
        fp.write(struct.pack("<I", len(tris)))
        for tri in tris:
            fp.write(struct.pack("<3f", 0, 0, 1))
            for v in tri:
                fp.write(struct.pack("<3f", *v))
            fp.write(struct.pack("<H", 0))


def gripper_triangles(n_seg=10):
    """A closed tessellated finger: a tapered tube, (4·n_seg, 3, 3)."""
    a = 2 * np.pi * np.arange(n_seg + 1) / n_seg
    ring0 = np.stack([0.02 * np.cos(a), 0.02 * np.sin(a), np.zeros_like(a)], 1)
    ring1 = np.stack([0.01 * np.cos(a), 0.01 * np.sin(a), np.full_like(a, 0.08)], 1)
    tris = []
    for i in range(n_seg):
        tris += [[ring0[i], ring0[i + 1], ring1[i]], [ring0[i + 1], ring1[i + 1], ring1[i]],
                 [[0, 0, 0], ring0[i + 1], ring0[i]], [[0, 0, 0.08], ring1[i], ring1[i + 1]]]
    return np.asarray(tris, np.float32)


URDF = """
<robot name="arm">
  <link name="base">
    <collision><origin xyz="0 0 0.1" rpy="0 0 0"/><geometry><box size="0.2 0.2 0.2"/></geometry></collision>
  </link>
  <link name="upper">
    <visual><origin xyz="0 0 0.15" rpy="0 0 0"/><geometry><cylinder radius="0.05" length="0.3"/></geometry></visual>
  </link>
  <link name="fore">
    <collision><origin xyz="0 0 0.1" rpy="0.1 0.2 0.3"/><geometry><box size="0.06 0.06 0.2"/></geometry></collision>
    <visual><geometry><box size="1 1 1"/></geometry></visual>
  </link>
  <link name="slide">
    <collision><geometry><cylinder radius="0.03" length="0.1"/></geometry></collision>
  </link>
  <link name="hand">
    <collision><geometry><mesh filename="package://meshes/finger.stl" scale="1.5 1.5 1"/></geometry></collision>
  </link>
  <link name="sensor"/>
  <joint name="shoulder" type="revolute">
    <parent link="base"/><child link="upper"/><origin xyz="0 0 0.2" rpy="0 0 0"/><axis xyz="0 1 0"/>
  </joint>
  <joint name="elbow" type="continuous">
    <parent link="upper"/><child link="fore"/><origin xyz="0 0 0.3" rpy="0 0.2 0"/><axis xyz="1 1 0"/>
  </joint>
  <joint name="extend" type="prismatic">
    <parent link="fore"/><child link="slide"/><origin xyz="0 0 0.2"/><axis xyz="0 0 1"/>
  </joint>
  <joint name="wrist" type="fixed">
    <parent link="slide"/><child link="hand"/><origin xyz="0 0 0.05" rpy="0.3 0 0"/>
  </joint>
  <joint name="mount" type="fixed">
    <parent link="base"/><child link="sensor"/><origin xyz="0.1 0 0.2"/>
  </joint>
</robot>
"""
JOINTS = {"shoulder": 0.6, "elbow": -0.4, "extend": 0.05}


@pytest.fixture(scope="module")
def robot_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("robot")
    (d / "meshes").mkdir()
    write_binary_stl(d / "meshes" / "finger.stl", gripper_triangles())
    (d / "arm.urdf").write_text(URDF)
    return d


def test_parse_urdf_matches(robot_dir):
    rt, rj = tu.parse_urdf(str(robot_dir / "arm.urdf")), ju.parse_urdf(str(robot_dir / "arm.urdf"))
    assert (rt.name, rt.root, list(rt.links)) == (rj.name, rj.root, list(rj.links)) == ("arm", "base", list(rt.links))
    for name in rj.links:
        gt, gj = rt.links[name].geometries, rj.links[name].geometries
        assert [(g.kind, g.mesh_file, g.scale, g.size) for g in gt] == [(g.kind, g.mesh_file, g.scale, g.size)
                                                                         for g in gj]
        for a, b in zip(gt, gj):
            np.testing.assert_array_equal(a.origin, b.origin)
    assert [g.kind for g in rt.links["upper"].geometries] == ["cylinder"]  # visual when there is no collision
    assert len(rt.links["fore"].geometries) == 1  # collision preferred
    for a, b in zip(rt.joints, rj.joints):
        assert (a.name, a.joint_type, a.parent, a.child) == (b.name, b.joint_type, b.parent, b.child)
        np.testing.assert_array_equal(a.origin, b.origin)
        np.testing.assert_array_equal(a.axis, b.axis)


@pytest.mark.parametrize("joints", [None, JOINTS, {"shoulder": np.pi / 2, "extend": -0.1, "elbow": 2.0}])
def test_forward_kinematics_matches(joints):
    rt, rj = tu.parse_urdf(URDF), ju.parse_urdf(URDF)
    pt, pj = rt.forward_kinematics(joints), rj.forward_kinematics(joints)
    assert set(pt) == set(pj) == set(rt.links)
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], rtol=0, atol=1e-12)
    if joints is None:
        np.testing.assert_allclose(pt["upper"][:3, 3], [0, 0, 0.2])


def test_disconnected_joints_raise_in_both():
    bad = URDF.replace('<parent link="base"/><child link="upper"/>', '<parent link="nowhere"/><child link="upper"/>')
    for mod in (tu, ju):
        with pytest.raises(ValueError, match="disconnected joints"):
            mod.parse_urdf(bad).forward_kinematics()


def test_load_stl_binary_and_ascii_match(tmp_path):
    write_binary_stl(tmp_path / "b.stl", gripper_triangles(6))
    with open(tmp_path / "a.stl", "w") as fp:
        fp.write("solid a\nfacet normal 0 0 1\nouter loop\nvertex 0 0 0\nvertex 1 0 0.5\nvertex 0 1e-3 1\n")
        fp.write("endloop\nendfacet\nendsolid a\n")
    for name, n in (("b.stl", 24), ("a.stl", 1)):
        vt, tt = tu.load_stl(str(tmp_path / name))
        vj, tj = ju.load_stl(str(tmp_path / name))
        assert vt.dtype == np.float32 and tt.shape == (n, 3)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(tt, tj)


def test_link_meshes_match(robot_dir):
    rt, rj = tu.parse_urdf(str(robot_dir / "arm.urdf")), ju.parse_urdf(str(robot_dir / "arm.urdf"))
    for name in rj.links:
        for a, b in zip(rt.links[name].geometries, rj.links[name].geometries):
            (vt, tt), (vj, tj) = tu._geometry_mesh(a), ju._geometry_mesh(b)
            np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-7)
            np.testing.assert_array_equal(tt, tj)
    bad = tu.Geometry(kind="sphere", size=(0.1,))
    with pytest.raises(ValueError, match="unsupported geometry"):
        tu._geometry_mesh(bad)


def camera():
    """Root → camera: the robot ~1.3 m ahead, seen from the side (camera
    z along the root's −y)."""
    cam = np.eye(4)
    cam[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
    cam[:3, 3] = [0.0, 0.3, 1.3]
    return cam


def test_render_robot_depth_matches(robot_dir):
    rt, rj = tu.parse_urdf(str(robot_dir / "arm.urdf")), ju.parse_urdf(str(robot_dir / "arm.urdf"))
    got = tu.render_robot_depth(rt, camera(), (H, W), fx=F, fy=F, joint_values=JOINTS, device="cpu")
    want = np.asarray(ju.render_robot_depth(rj, camera(), (H, W), fx=F, fy=F, joint_values=JOINTS))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert (want > 0).sum() > 150
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    empty = tu.RobotModel("none", {}, [], "base")
    assert (tu.render_robot_depth(empty, camera(), (H, W), device="cpu") == 0).all()


def test_render_robot_depth_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tu.render_robot_depth(tu.parse_urdf(URDF), camera(), (H, W))


def scene_mesh():
    """A wall at z = 2.2 and a floor at y = 0.45 in the camera frame, as
    two quads of two triangles each."""
    v = np.array([[-3, -3, 2.2], [3, -3, 2.2], [3, 3, 2.2], [-3, 3, 2.2],
                  [-3, 0.45, 0.2], [3, 0.45, 0.2], [3, 0.45, 2.2], [-3, 0.45, 2.2]], np.float32)
    t = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    return v, t


def test_self_filter_slice_matches(robot_dir):
    """The self-filter path end to end in both packages."""
    rt, rj = tu.parse_urdf(str(robot_dir / "arm.urdf")), ju.parse_urdf(str(robot_dir / "arm.urdf"))
    robot_t = tu.render_robot_depth(rt, camera(), (H, W), fx=F, fy=F, joint_values=JOINTS, device="cpu")
    robot_j = np.asarray(ju.render_robot_depth(rj, camera(), (H, W), fx=F, fy=F, joint_values=JOINTS))
    sv, st = scene_mesh()
    scene_t = tr.render_depth_mesh(torch.from_numpy(sv), torch.from_numpy(st), (H, W), fx=F, fy=F)
    scene_j = jr.render_depth_mesh(sv, st, (H, W), fx=F, fy=F)
    # The wall quad's diagonal runs through pixel centres (u − v = 8), where
    # both triangles' edge functions are exactly 0 and each package's
    # rounding decides the sign: hits may differ there and nowhere else.
    v, u = np.mgrid[0:H, 0:W]
    differ = (scene_t.numpy() > 0) != (np.asarray(scene_j) > 0)
    assert (u - v == 8)[differ].all() and (np.asarray(scene_j) > 0).mean() > 0.99

    def measured(robot, scene):
        near = np.where((robot > 0) & ((robot < scene) | (scene == 0)), robot, scene).astype(np.float64)
        disp = np.round(43.5 / np.maximum(near, 1e-6) * 8) / 8  # Kinect disparity in 1/8 px
        return np.where(near > 0, 43.5 / np.maximum(disp, 1e-6), 0.0).astype(np.float32)

    meas = measured(robot_j, np.asarray(scene_j))  # one frame for both packages
    keep_t = td.background_subtract(torch.from_numpy(meas), torch.from_numpy(robot_t), threshold=0.05)
    keep_j = np.asarray(jd.background_subtract(jnp.asarray(meas), jnp.asarray(robot_j), threshold=0.05))
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    robot_seen = (robot_j > 0) & (meas > 0) & (robot_j <= np.where(np.asarray(scene_j) > 0, np.asarray(scene_j), np.inf))
    assert robot_seen.sum() > 100 and not keep_j[robot_seen].any() and (keep_j | (robot_j > 0)).all()

    filt = np.where(keep_j, meas, 0.0).astype(np.float32)
    sm_t = td.smooth_depth_image(torch.from_numpy(filt))
    sm_j = jd.smooth_depth_image(jnp.asarray(filt))
    np.testing.assert_allclose(sm_t.numpy(), np.asarray(sm_j), rtol=1e-5)
    pt, vt = td.depth_to_cloud(sm_t, fx=F, fy=F)
    pj, vj = jd.depth_to_cloud(sm_j, fx=F, fy=F)
    nt, nj = ts.fast_normals_image(pt, vt), js.fast_normals_image(pj, vj)
    okj = np.asarray(vj) & (np.linalg.norm(np.asarray(nj), axis=-1) > 0.5)
    key = jax.random.PRNGKey(4)
    plj, lj, cj = js.multi_plane_ransac(pj.reshape(-1, 3), nj.reshape(-1, 3), jnp.asarray(okj.reshape(-1)), key,
                                        num_hypotheses=128, max_planes=3, threshold=0.03)
    plt, lt, ct = ts.multi_plane_ransac(pt.reshape(-1, 3), nt.reshape(-1, 3), torch.from_numpy(okj.reshape(-1)),
                                        None, num_hypotheses=128, max_planes=3, threshold=0.03,
                                        u=torch.from_numpy(multi_plane_uniforms(key, 3, 128)))
    assert int(ct) == int(cj) >= 2
    np.testing.assert_allclose(plt.numpy(), np.asarray(plj), rtol=0, atol=1e-4)
    assert (lt.numpy() == np.asarray(lj)).mean() >= 0.999
    seg_t = ts.segment_normal_image(nt, torch.from_numpy(okj)).numpy()
    seg_j = np.asarray(js.segment_normal_image(nj, jnp.asarray(okj)))
    assert (seg_t == seg_j).mean() >= 0.999
