"""The ported slices end to end: the port's ``icp_register`` CLI against
the JAX package's on the same 4 small PCDs (a chain of rigid steps over
tests/test_icp.py's bumpy surface), and its ``build_map`` CLI against the
JAX package's on 4 scans of tests/test_scan_to_map.py's world.
Trajectories within 1e-4.  The tabletop CLIs, ``table_pipeline`` and
``clean_table``, against the JAX package's on small synthetic tabletop
frames: they draw their RANSAC samples from different generators, so the
outcomes are compared (tables, object names and types equal, object
centres within 5e-3, grasp positions and widths within 5e-3 and 1e-2).
Also: the port never imports jax."""
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_icp import _bumpy_surface

from mapping_private_tpu.apps import build_map as jmap
from mapping_private_tpu.apps import clean_table as jclean
from mapping_private_tpu.apps import icp_register as jcli
from mapping_private_tpu.apps import table_pipeline as jpipe
from mapping_private_tpu.core.se3 import se3_exp
from mapping_private_tpu_torch.apps import build_map as tmap
from mapping_private_tpu_torch.apps import clean_table as tclean
from mapping_private_tpu_torch.apps import icp_register as tcli
from mapping_private_tpu_torch.apps import table_pipeline as tpipe
from mapping_private_tpu_torch.io.pcd import load_pcd, load_pcd_arrays, save_pcd

REPO = pathlib.Path(__file__).resolve().parents[1]


def _chain(tmp_path, n_scans=4, n=1200, seed=7):
    """PCD files of a scan chain + the true step transforms (bench.py's
    step sizes)."""
    rng = np.random.default_rng(seed)
    scans, steps = [_bumpy_surface(seed=seed, n=n)], []
    for _ in range(n_scans - 1):
        xi = rng.uniform(-1, 1, 6) * np.array([0.05, 0.04, 0.03, 0.02, 0.02, 0.03])
        T = np.asarray(se3_exp(jnp.asarray(xi.astype(np.float32))))
        scans.append(((scans[-1] - T[:3, 3]) @ T[:3, :3]).astype(np.float32))
        steps.append(T)
    paths = []
    for k, s in enumerate(scans):
        paths.append(str(tmp_path / f"scan{k}.pcd"))
        save_pcd(paths[-1], {"xyz": s})
    return paths, np.stack(steps)


def test_cli_matches_jax_cli(tmp_path, capsys):
    paths, steps = _chain(tmp_path)
    assert jcli.main(paths + ["--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert tcli.main(paths + ["--json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    np.testing.assert_allclose(got["pairwise"], want["pairwise"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["trajectory"], want["trajectory"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["pairwise"], steps, atol=5e-3)


def test_cli_text_output(tmp_path, capsys):
    paths, _ = _chain(tmp_path, n_scans=2, n=500)
    assert tcli.main(paths + ["--device", "cpu", "--iters", "5"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["scan 0", "scan 1"]


def test_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    paths, _ = _chain(tmp_path, n_scans=2, n=300)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(paths)


def _world_scans(tmp_path, n_scans=4, n=2500):
    """tests/test_scan_to_map.py's world seen from poses moving along x."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-1.5, 1.5, (n, 2))
    z = 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * np.cos(2.5 * xy[:, 1])
    world = np.column_stack([xy, z]).astype(np.float32)
    paths = []
    for k in range(n_scans):
        T = np.asarray(se3_exp(jnp.asarray([0.04 * k, 0.0, 0.0, 0, 0, 0.01 * k], jnp.float32)))
        Tinv = np.linalg.inv(T)
        paths.append(str(tmp_path / f"scan{k}.pcd"))
        save_pcd(paths[-1], {"xyz": (world @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)})
    return paths


def test_build_map_cli_matches_jax_cli(tmp_path, capsys):
    paths = _world_scans(tmp_path)
    flags = ["--json", "--relax", "--keyframe-trans", "0.03", "--map-voxel", "0.05",
             "--map-capacity", "8192", "--icp-iters", "8"]
    jout, tout = str(tmp_path / "jmap.pcd"), str(tmp_path / "tmap.pcd")
    assert jmap.main(paths + flags + ["--out-map", jout]) == 0
    want = json.loads(capsys.readouterr().out)
    assert tmap.main(paths + flags + ["--out-map", tout, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys() == {"trajectory", "keyframes", "map_points"}
    np.testing.assert_allclose(got["trajectory"], want["trajectory"], rtol=0, atol=1e-4)
    assert got["keyframes"] == want["keyframes"] >= 3
    assert got["map_points"] == want["map_points"] > 500
    assert abs(got["trajectory"][-1][0][3] - 0.12) < 0.02  # recovered x motion
    np.testing.assert_allclose(
        load_pcd_arrays(tout)["x"], load_pcd_arrays(jout)["x"], rtol=0, atol=1e-4)


def test_build_map_cli_text_output(tmp_path, capsys):
    paths = _world_scans(tmp_path, n_scans=2, n=600)
    assert tmap.main(paths + ["--device", "cpu", "--icp-iters", "4", "--keyframe-trans", "0.03"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and lines[0].endswith("[keyframe]")
    assert lines[-1].startswith("keyframes=2 map_points=")


def test_build_map_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    paths = _world_scans(tmp_path, n_scans=2, n=300)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmap.main(paths)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmap.main(paths + ["--device", "cuda"])


def test_pcd_roundtrip_matches_jax_reader(tmp_path):
    from mapping_private_tpu.io import pcd as jpcd

    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(250, 3)).astype(np.float32)
    xyz[3] = np.nan  # a Kinect hole: dropped on load
    path = str(tmp_path / "a.pcd")
    save_pcd(path, {"xyz": xyz, "intensity": rng.uniform(size=250), "hist": rng.uniform(size=(250, 4))})
    got, want = load_pcd_arrays(path), jpcd.load_pcd_arrays(path)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    tc, jc = load_pcd(path, device="cpu"), jpcd.load_pcd(path)
    np.testing.assert_array_equal(tc.xyz.numpy(), np.asarray(jc.xyz))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.channel("hist").numpy(), np.asarray(jc.channel("hist")))
    assert load_pcd(path, capacity_bucket=512, device="cpu").capacity == 512


def _tabletop_frame(seed=0, shift=(0.0, 0.0), n=4096):
    """A 1.0 x 0.8 m table at z = 0.75 (2 mm noise) holding a 0.1 m box at
    (0.2, 0.1) and a cylinder of radius 0.04 at (-0.25, -0.2), with floor
    and a wall; ``n`` points (4,096: the JAX CLIs' two loaders give the
    same capacity, so detect_table compiles once), moved by ``shift``."""
    rng = np.random.default_rng(seed)
    t = rng.uniform([-0.5, -0.4], [0.5, 0.4], (1900, 2))
    table = np.column_stack([t, 0.75 + rng.normal(0, 0.002, len(t))])
    b = rng.uniform(-0.05, 0.05, (700, 3)) * [1, 1, 1.2]
    face = rng.integers(0, 5, 700)  # the top and the four sides
    b[face == 0, 2] = 0.06
    for f, (ax, v) in enumerate([(0, -0.05), (0, 0.05), (1, -0.05), (1, 0.05)], start=1):
        b[face == f, ax] = v
    th = rng.uniform(0, 2 * np.pi, 500)
    cyl = np.column_stack([-0.25 + 0.04 * np.cos(th), -0.2 + 0.04 * np.sin(th), rng.uniform(0.75, 0.9, 500)])
    rest = n - 1900 - 700 - 500
    floor = rng.uniform([-2, -2, 0], [2, 2, 0.02], (rest // 2, 3))
    k = rest - rest // 2
    wall = np.column_stack([np.full(k, 1.8), rng.uniform(-2, 2, k), rng.uniform(0, 2, k)])
    xyz = np.vstack([table, b + [0.2, 0.1, 0.81], cyl, floor, wall]) + [shift[0], shift[1], 0.0]
    return xyz[rng.permutation(n)].astype(np.float32)


def _tabletop_pcds(tmp_path, n_frames=2):
    paths = []
    for k in range(n_frames):
        paths.append(str(tmp_path / f"frame{k}.pcd"))
        save_pcd(paths[-1], {"xyz": _tabletop_frame(k, (0.01 * k, -0.005 * k))})
    return paths


BOX = ["--box", "-1.5", "-1.5", "0.3", "1.5", "1.5", "1.6"]


def test_table_pipeline_cli_matches_jax_cli(tmp_path, capsys):
    paths = _tabletop_pcds(tmp_path)
    jck, tck = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert jpipe.main(paths + BOX + ["--json", "--checkpoint", jck]) == 0
    want = json.loads(capsys.readouterr().out)
    viz = tmp_path / "viz"
    assert tpipe.main(paths + BOX + ["--json", "--checkpoint", tck, "--device", "cpu",
                                     "--dump-viz", str(viz)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys() == {"table_0"}
    assert [(o["name"], o["type"]) for o in got["table_0"]] == [(o["name"], o["type"]) for o in want["table_0"]]
    assert sorted(o["type"] for o in got["table_0"]) == ["box", "cylinder"]
    np.testing.assert_allclose([o["center"] for o in got["table_0"]], [o["center"] for o in want["table_0"]],
                               rtol=0, atol=5e-3)
    markers = json.loads((viz / "table_memory_markers.json").read_text())
    assert [m["kind"] for m in markers] == ["polygon", "text", "text"]
    # each package resumes the other's checkpoint and goes on naming alike
    assert tpipe.main(paths[:1] + BOX + ["--json", "--resume", jck, "--device", "cpu"]) == 0
    again = json.loads(capsys.readouterr().out)
    assert [o["name"] for o in again["table_0"]] == [o["name"] for o in want["table_0"]]


def test_table_pipeline_cli_text_output(tmp_path, capsys):
    paths = _tabletop_pcds(tmp_path, n_frames=1)
    empty = str(tmp_path / "empty.pcd")
    save_pcd(empty, {"xyz": np.random.default_rng(0).uniform(-2, 2, (300, 3)).astype(np.float32)})
    assert tpipe.main([empty] + paths + BOX + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].endswith("denoise output invalid, skipped") or lines[0].endswith("no table found")
    assert lines[1] == f"{paths[0]}: table 0, 2 objects"
    assert json.loads("\n".join(lines[2:]))["table_0"][0]["name"] == "object_0"


def test_clean_table_cli_matches_jax(tmp_path, capsys):
    (path,) = _tabletop_pcds(tmp_path, n_frames=1)
    want = jclean.plan_clean_table(path)
    assert tclean.main([path, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["table_found"] and want["table_found"]
    assert abs(got["table_height"] - want["table_height"]) < 5e-3
    assert len(got["grasps"]) == len(want["grasps"]) == 2
    for g, w in zip(got["grasps"], want["grasps"]):
        # yaw is not compared: both footprints are near-square or round
        np.testing.assert_allclose(g["position"], w["position"], rtol=0, atol=5e-3)
        assert abs(g["width"] - w["width"]) < 1e-2 and g["pregrasp"][2] > g["position"][2]
        assert g["place"] == w["place"] == [0.0, -0.6, 0.5]


@pytest.mark.parametrize("cli", [tpipe, tclean])
def test_tabletop_clis_cuda_without_card_raise(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    paths = _tabletop_pcds(tmp_path, n_frames=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(paths)


def test_port_imports_no_jax():
    pkg = REPO / "mapping_private_tpu_torch"
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py"))
    assert {"mapping_private_tpu_torch.apps.build_map", "mapping_private_tpu_torch.ops.nn_gather",
            "mapping_private_tpu_torch.ops.nn_matmul", "mapping_private_tpu_torch.ops.tiled_nn",
            "mapping_private_tpu_torch.ops.nn_dispatch", "mapping_private_tpu_torch.ops.neighbors",
            "mapping_private_tpu_torch.registration.scan_to_map",
            "mapping_private_tpu_torch._build", "mapping_private_tpu_torch.ops.voxel",
            "mapping_private_tpu_torch.ops.filters", "mapping_private_tpu_torch.ops.cluster",
            "mapping_private_tpu_torch.ops.hull", "mapping_private_tpu_torch.ops.mls",
            "mapping_private_tpu_torch.fit.ransac", "mapping_private_tpu_torch.fit.box",
            "mapping_private_tpu_torch.fit.cylinder", "mapping_private_tpu_torch.models.table_detector",
            "mapping_private_tpu_torch.models.table_memory", "mapping_private_tpu_torch.io.viz",
            "mapping_private_tpu_torch.apps.table_pipeline",
            "mapping_private_tpu_torch.apps.clean_table"} <= set(mods)
    mods.append("chip_smoke")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mapping_private_tpu.'))"
        " or m == 'mapping_private_tpu']\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
