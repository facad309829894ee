"""Port parity: io/mesh.py, io/dxf.py and io/semantic_map.py against the
JAX package.

The host paths are the same numpy code: files are compared byte for
byte, read-backs and samples exactly.  The virtual views go through the
rasteriser on the CPU (``device="cpu"``): depth hit masks equal, depth
within 1e-5 relative (tests/test_torch_realtime.py); the uint8 intensity
image within 1 grey level (a Gouraud sum within 1e-5 of the 255 range can
round to the other side of an integer).  The semantic-map XML is written
here (the reference's cad_based_map.xml is not in the repository).

One divergence is shown: ``read_vtk_mesh`` on a truncated SCALARS header
(JAX: IndexError) and on a SCALARS block shorter than the vertex count
(JAX: fewer scalars than vertices, silently); the port raises ValueError
naming the file in both cases."""
import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.io import dxf as jdxf, mesh as jmesh, semantic_map as jsm
from mapping_private_tpu_torch.io import dxf as tdxf, mesh as tmesh, semantic_map as tsm


def mesh(seed=0):
    """A closed, slightly irregular box (8 vertices, 12 triangles) and a
    far quad, with per-vertex values."""
    rng = np.random.default_rng(seed)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float64) * 0.3
    v = np.concatenate([corners + rng.normal(0, 0.01, corners.shape),
                        [[-3, -3, 3.0], [3, -3, 3.0], [3, 3, 3.0], [-3, 3, 3.0]]]).astype(np.float32)
    t = np.array([[0, 1, 3], [0, 3, 2], [4, 7, 5], [4, 6, 7], [0, 5, 1], [0, 4, 5], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3], [8, 9, 10], [8, 10, 11]], np.int32)
    s = rng.uniform(0, 300, len(v)).astype(np.float32)
    return v, t, s


def camera_pose():
    pose = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.4), np.sin(0.4)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [0.05, -0.02, 1.5]
    return pose


@pytest.mark.parametrize("with_scalars", [False, True])
def test_vtk_files_match_byte_for_byte(tmp_path, with_scalars):
    v, t, s = mesh()
    sc = s if with_scalars else None
    tmesh.write_vtk_mesh(str(tmp_path / "t.vtk"), v, t, scalars=sc)
    jmesh.write_vtk_mesh(str(tmp_path / "j.vtk"), v, t, scalars=sc)
    assert (tmp_path / "t.vtk").read_bytes() == (tmp_path / "j.vtk").read_bytes()
    got = tmesh.read_vtk_mesh(str(tmp_path / "j.vtk"), with_scalars=True)
    want = jmesh.read_vtk_mesh(str(tmp_path / "j.vtk"), with_scalars=True)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], v, atol=1e-6)
    np.testing.assert_array_equal(got[1], t)
    vt, tt = tmesh.read_vtk_mesh(str(tmp_path / "j.vtk"))
    np.testing.assert_array_equal(tt, t)


def test_vtk_scalars_bounds_divergence(tmp_path):
    """Truncated SCALARS blocks: what each package does on the same files."""
    v, t, s = mesh()
    full = tmp_path / "full.vtk"
    jmesh.write_vtk_mesh(str(full), v, t, scalars=s)
    text = full.read_text()
    head = text[: text.index("SCALARS")] + "SCALARS scalars"  # the header cut after its name
    (tmp_path / "head.vtk").write_text(head)
    short = text.rsplit("\n", 4)[0] + "\n"  # the last 3 values gone
    (tmp_path / "short.vtk").write_text(short)
    with pytest.raises(IndexError):
        jmesh.read_vtk_mesh(str(tmp_path / "head.vtk"), with_scalars=True)
    _, _, js = jmesh.read_vtk_mesh(str(tmp_path / "short.vtk"), with_scalars=True)
    assert len(js) == len(v) - 3  # silently short
    for name in ("head.vtk", "short.vtk"):
        with pytest.raises(ValueError, match=name):
            tmesh.read_vtk_mesh(str(tmp_path / name), with_scalars=True)
    with pytest.raises(ValueError, match="not a polydata mesh"):
        (tmp_path / "empty.vtk").write_text("# vtk\nASCII\n")
        tmesh.read_vtk_mesh(str(tmp_path / "empty.vtk"))


def test_dxf_files_match_byte_for_byte(tmp_path):
    v, t, _ = mesh(1)
    tdxf.write_dxf_mesh(str(tmp_path / "t.dxf"), v, t, layer="robot")
    jdxf.write_dxf_mesh(str(tmp_path / "j.dxf"), v, t, layer="robot")
    assert (tmp_path / "t.dxf").read_bytes() == (tmp_path / "j.dxf").read_bytes()
    (vt, tt), (vj, tj) = tdxf.read_dxf_mesh(str(tmp_path / "j.dxf")), jdxf.read_dxf_mesh(str(tmp_path / "j.dxf"))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(vt[tt], v[t], atol=1e-6)  # the same faces, vertices deduplicated


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_mesh_points_match(seed):
    v, t, _ = mesh(seed)
    got = tmesh.sample_mesh_points(v, t, 2000, seed=seed)
    np.testing.assert_array_equal(got, jmesh.sample_mesh_points(v, t, 2000, seed=seed))
    # every sample on the surface: within 1e-5 m of the plane of some triangle, inside its footprint
    a, b, c = (v[t[:, k]].astype(np.float64) for k in range(3))
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    dist = np.abs(np.einsum("tk,ptk->pt", n, got[:, None, :] - a[None]))
    assert dist.min(axis=1).max() < 1e-5
    with pytest.raises(ValueError, match="degenerate"):
        tmesh.sample_mesh_points(np.zeros((3, 3)), np.array([[0, 1, 2]]), 5)


def test_virtual_view_depth_matches():
    v, t, _ = mesh(2)
    got = tmesh.virtual_view_depth(v, t, camera_pose(), (48, 64), fx=40, fy=40, device="cpu")
    want = jmesh.virtual_view_depth(v, t, camera_pose(), (48, 64), fx=40, fy=40)
    assert got.dtype == np.float32 and (want > 0).mean() > 0.5
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_virtual_view_intensity_and_ppm_match(tmp_path):
    v, t, s = mesh(4)
    got = tmesh.virtual_view_intensity(v, t, s, camera_pose(), (48, 64), fx=40, fy=40, device="cpu")
    want = jmesh.virtual_view_intensity(v, t, s, camera_pose(), (48, 64), fx=40, fy=40)
    assert got.dtype == np.uint8 and got.max() == 255  # values over 255 clamped
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    tmesh.write_ppm(str(tmp_path / "t.ppm"), want)
    jmesh.write_ppm(str(tmp_path / "j.ppm"), want)
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()
    np.testing.assert_array_equal(tmesh.read_ppm(str(tmp_path / "j.ppm")), want)
    (tmp_path / "bad.ppm").write_text("P6\n1 1\n255\n")
    with pytest.raises(ValueError, match="not an ASCII PPM"):
        tmesh.read_ppm(str(tmp_path / "bad.ppm"))


def test_virtual_views_on_cuda_without_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    v, t, s = mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.virtual_view_depth(v, t, camera_pose())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.virtual_view_intensity(v, t, s, camera_pose())


def write_semantic_map(path, n_doors=6, seed=0):
    """A kitchen in the reference's SemanticMap XML layout: walls,
    horizontal surfaces, handles, knobs and candidates with faces."""
    rng = np.random.default_rng(seed)
    ents, eid = [], 1

    def fmt(a):
        return " ".join(f"{x:.4f}" for x in a)

    for k, (lo, hi) in enumerate((((0, 3.2, 0), (4.0, 3.22, 2.6)), ((0, 0, 0), (0.02, 3.2, 2.6)))):
        ents.append(f'<wall name="wall-{k}" id="{eid}"><model>0 1 0 -3.2</model><minD>{fmt(lo)}</minD>'
                    f'<maxD>{fmt(hi)}</maxD></wall>')
        eid += 1
    ents.append(f'<horizontal name="counter" id="{eid}"><model>0 0 1 0.85</model><minD>0.5 2.6 0.85</minD>'
                f'<maxD>3.5 3.2 0.85</maxD></horizontal>')
    eid += 1
    for d in range(n_doors):
        x0 = 0.5 + 0.5 * d
        door = eid
        faces = "".join(f'<face side="{side}">' + "".join(f"<point>{fmt(rng.uniform(0, 3, 3))}</point>"
                                                          for _ in range(4)) + "</face>" for side in ("front", "top"))
        ents.append(f'<candidate name="drawer-{d}" id="{door}" type="{d % 3}" typename="drawer">'
                    f'<wallID>1</wallID>{faces}</candidate>')
        ents.append(f'<handle name="handle-{d}" id="{door + 1}"><center>{fmt((x0 + 0.2, 2.58, 0.6))}</center>'
                    f'<elongation>0.08 0.01 0.01</elongation><doorID>{door}</doorID></handle>')
        ents.append(f'<knob name="knob-{d}" id="{door + 2}"><center>{fmt((x0, 2.58, 0.3))}</center>'
                    f'<radius>0.02</radius><doorID>{door}</doorID></knob>')
        eid += 3
    ents.append('<unknown name="ignored" id="999"/>')
    with open(path, "w") as fp:
        fp.write("<SemanticMap>\n" + "\n".join(ents) + "\n</SemanticMap>\n")


def test_semantic_map_matches(tmp_path):
    path = str(tmp_path / "kitchen.xml")
    write_semantic_map(path)
    mt, mj = tsm.parse_semantic_map(path), jsm.parse_semantic_map(path)
    assert (len(mt.walls), len(mt.horizontals), len(mt.handles), len(mt.knobs), len(mt.candidates)) == (2, 1, 6, 6, 6)
    for group in ("walls", "horizontals", "handles", "knobs", "candidates"):
        for a, b in zip(getattr(mt, group), getattr(mj, group)):
            da, db = vars(a), vars(b)
            assert da.keys() == db.keys()
            for k in da:
                if k == "faces":
                    assert [f.side for f in da[k]] == [f.side for f in db[k]]
                    for fa, fb in zip(da[k], db[k]):
                        np.testing.assert_array_equal(np.asarray(fa.points), np.asarray(fb.points))
                else:
                    np.testing.assert_array_equal(da[k], db[k])
    assert sorted(mt.by_id()) == sorted(mj.by_id())
    np.testing.assert_array_equal(tsm.corner_frame_offset(mt), jsm.corner_frame_offset(mj))
    assert tsm.map_to_boxes(mt, 0.03) == jsm.map_to_boxes(mj, 0.03)
    assert len(tsm.map_to_boxes(mt)) == 2 + 1 + 6
    empty = tsm.SemanticMap([], [], [], [], [])
    np.testing.assert_array_equal(tsm.corner_frame_offset(empty), np.zeros(3))
