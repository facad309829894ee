"""Port parity: the cloud_ops CLI against the JAX package's on the same
synthetic PCDs (a noisy surface with an intensity channel and scattered
outliers): every subcommand writes the same files — transform within
1e-6 (both take it in float64 and round once to float32), crop, project
and concat identical, the denoise's kept rows identical (the same
statistical_outlier_mask, tests/test_torch_filters.py)."""
import os

import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.apps import cloud_ops as jops
from mapping_private_tpu_torch.apps import cloud_ops as tops
from mapping_private_tpu_torch.io.pcd import load_pcd_arrays, save_pcd


def _pcds(tmp_path, n=600, n_out=30, files=2):
    rng = np.random.default_rng(0)
    paths = []
    for f in range(files):
        xy = rng.uniform(-1, 1, (n, 2))
        surf = np.column_stack([xy, 0.1 * np.sin(3 * xy[:, 0]) + rng.normal(0, 0.002, n)])
        outl = rng.uniform(-1, 1, (n_out, 3)) * [1, 1, 0.5] + [0, 0, 0.6]
        xyz = np.vstack([surf, outl]).astype(np.float32)
        paths.append(str(tmp_path / f"in{f}.pcd"))
        save_pcd(paths[-1], {"xyz": xyz, "intensity": rng.uniform(0, 1, len(xyz)).astype(np.float32)})
    return paths


CASES = {
    "transform": (["transform", "--x", "0.1", "--y", "-0.2", "--z", "0.05", "--roll", "0.1",
                   "--pitch", "-0.2", "--yaw", "0.3", "--scale", "1.5"], "tf", 1e-6),
    "crop": (["crop", "--axis", "z", "--min", "-0.05", "--max", "0.05"], "crop_z", 0),
    "denoise": (["denoise", "--mean-k", "10", "--std-mul", "1.0"], "denoised", 0),
    "project": (["project"], "proj", 0),
}


@pytest.mark.parametrize("cmd", sorted(CASES))
def test_subcommand_matches_jax(cmd, tmp_path):
    paths = _pcds(tmp_path)
    args, suffix, atol = CASES[cmd]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jops.main(args + ["--out-dir", jdir] + paths) == 0
    assert tops.main(args + ["--out-dir", tdir, "--device", "cpu"] + paths) == 0
    for p in paths:
        name = f"{os.path.splitext(os.path.basename(p))[0]}_{suffix}.pcd"
        want, got = load_pcd_arrays(os.path.join(jdir, name)), load_pcd_arrays(os.path.join(tdir, name))
        assert got.keys() == want.keys() == {"x", "y", "z", "intensity"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)
        if cmd == "denoise":
            assert 570 <= len(got["x"]) < 630  # most outliers go, the surface stays


def test_transform_inverse_and_concat(tmp_path):
    """A yaw and a translation, then their inverse (yaw −θ, translation
    −Rz(−θ) t) through the CLI again: the points come back within 1e-5."""
    paths = _pcds(tmp_path, files=1)
    yaw, t = 0.7, np.array([0.3, -0.1, 0.2])
    assert tops.main(["transform", "--yaw", str(yaw), *sum(([f"--{a}", str(v)] for a, v in zip("xyz", t)), []),
                      "--out-dir", str(tmp_path / "a"), "--device", "cpu", *paths]) == 0
    moved = str(tmp_path / "a" / "in0_tf.pcd")
    t_inv = -(tops._euler_matrix(0, 0, -yaw) @ t)
    assert tops.main(["transform", "--yaw", str(-yaw), *sum(([f"--{a}", repr(float(v))] for a, v in zip("xyz", t_inv)), []),
                      "--out-dir", str(tmp_path / "b"), "--device", "cpu", moved]) == 0
    back, orig = load_pcd_arrays(str(tmp_path / "b" / "in0_tf_tf.pcd")), load_pcd_arrays(paths[0])
    for k in ("x", "y", "z", "intensity"):
        np.testing.assert_allclose(back[k], orig[k], rtol=0, atol=1e-5)
    out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    assert tops.main(["concat", "--out", out_t, paths[0], moved]) == 0
    assert jops.main(["concat", "--out", out_j, paths[0], moved]) == 0
    got, want = load_pcd_arrays(out_t), load_pcd_arrays(out_j)
    assert len(got["x"]) == 2 * 630
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    paths = _pcds(tmp_path, files=1)
    for cmd in (["transform"], ["crop", "--min", "0", "--max", "1"], ["denoise"], ["project"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tops.main(cmd + paths)
