"""The ported slices end to end: the port's ``icp_register`` CLI against
the JAX package's on the same 4 small PCDs (a chain of rigid steps over
tests/test_icp.py's bumpy surface), and its ``build_map`` CLI against the
JAX package's on 4 scans of tests/test_scan_to_map.py's world.
Trajectories within 1e-4.  Also: the port never imports jax."""
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
from mapping_private_tpu.apps import icp_register as jcli
from mapping_private_tpu.core.se3 import se3_exp
from mapping_private_tpu_torch.apps import build_map as tmap
from mapping_private_tpu_torch.apps import icp_register as tcli
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


def test_port_imports_no_jax():
    pkg = REPO / "mapping_private_tpu_torch"
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py"))
    assert {"mapping_private_tpu_torch.apps.build_map", "mapping_private_tpu_torch.ops.nn_gather",
            "mapping_private_tpu_torch.ops.nn_matmul", "mapping_private_tpu_torch.ops.tiled_nn",
            "mapping_private_tpu_torch.ops.nn_dispatch", "mapping_private_tpu_torch.ops.neighbors",
            "mapping_private_tpu_torch.registration.scan_to_map",
            "mapping_private_tpu_torch._build"} <= set(mods)
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
