"""Port parity: the ``detect_object`` CLI against the JAX package's, on
synthetic PCD files in a temporary directory.

A small table scene (grey top, a red box, a green cylinder) and views of
the red box.  Both packages learn the thresholds (equal), the scene and
object PCA files (variances within 1e-4 relative, subspaces by
projector) and detect the box from the same PCA files: the top scores
within 1e-4 and both top boxes on the red box (``_same_dets`` says why
no more), and every box's similarity within 1e-4 of the JAX one in each
search mode.  The files cross: each package detects
alike from the other's.  ``variance-show`` prints the same lines."""
import json

import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.apps import detect_object as jcli
from mapping_private_tpu.recognition import pca as jpca
from mapping_private_tpu_torch.apps import detect_object as tcli
from mapping_private_tpu_torch.io.pcd import save_pcd

BOX = ((0.05, 0.02, 0.0), (0.11, 0.06, 0.08))  # the red box, min and max corner


def _scene(seed, n=5000, box_only=False, turn=False):
    """Points of a 0.3 x 0.2 m grey table top at z = 0, the red box on it
    and a green cylinder (r 2.5 cm) at (-0.08, -0.04); integer colours,
    ±10 noise.  ``box_only`` keeps the box's points; ``turn`` turns them
    90° about z around the box's centre."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(BOX[0]), np.asarray(BOX[1])
    n_box, n_cyl = n // 4, n // 5
    n_top = n - n_box - n_cyl
    p = rng.uniform(lo, hi, (n_box, 3))
    face = rng.integers(0, 5, n_box)  # top, -x, +x, -y, +y
    p[face == 0, 2] = hi[2]
    for f, (ax, v) in enumerate([(0, lo[0]), (0, hi[0]), (1, lo[1]), (1, hi[1])], start=1):
        p[face == f, ax] = v
    th = rng.uniform(0, 2 * np.pi, n_cyl)
    cyl = np.column_stack([-0.08 + 0.025 * np.cos(th), -0.04 + 0.025 * np.sin(th), rng.uniform(0, 0.1, n_cyl)])
    top = np.column_stack([rng.uniform([-0.15, -0.1], [0.15, 0.1], (n_top, 2)), np.zeros(n_top)])
    cols = [np.tile(c, (m, 1)) for c, m in (((200, 30, 30), n_box), ((40, 180, 50), n_cyl), ((128, 128, 120), n_top))]
    xyz, rgb = np.vstack([p, cyl, top]), np.vstack(cols) + rng.normal(0, 10, (n, 3))
    if box_only:
        xyz, rgb = xyz[:n_box], rgb[:n_box]
        if turn:
            c = (lo + hi) / 2
            xyz = (xyz - c) @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]]).T + c
    rgb = np.clip(rgb, 0, 255).round().astype(np.float32)
    return {"xyz": (xyz + rng.normal(0, 0.0005, xyz.shape)).astype(np.float32),
            "r": rgb[:, 0], "g": rgb[:, 1], "b": rgb[:, 2]}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("detect")
    paths = {}
    for name, kw in [("scene", {"seed": 0}), ("env1", {"seed": 1}), ("env2", {"seed": 2})] + [
            (f"obj{k}", {"seed": 10 + k, "box_only": True, "turn": k >= 3}) for k in range(5)]:
        paths[name] = str(d / f"{name}.pcd")
        save_pcd(paths[name], _scene(**kw))
    return d, paths


def _proj(axis, k):
    W = np.asarray(axis, np.float64)[:, :k]
    return W @ W.T


def _same_dets(a, b):
    """The C3-HLAC similarity of any box of red voxels is within ~1e-5 of
    1, so ranks among such near-ties swap with the rounding, and the
    overlap suppression then keeps other boxes: the top scores agree
    within 1e-4 and both top boxes overlap the red box (the similarity
    grids themselves are compared in ``test_similarity_grids_match``)."""
    assert a and b
    assert abs(a[0]["score"] - b[0]["score"]) < 1e-4
    assert _overlaps_box(a[0]) and _overlaps_box(b[0])


def _overlaps_box(det):
    lo, hi = np.asarray(det["box_min"]), np.asarray(det["box_max"])
    return bool(np.all(lo < np.asarray(BOX[1])) and np.all(np.asarray(BOX[0]) < hi))


def test_detect_object_cli_matches_jax(files, capsys):
    d, p = files
    envs = [p["scene"], p["env1"], p["env2"]]
    thr_t = tcli.learn_threshold(envs, str(d / "t_thr.txt"), device="cpu")
    thr_j = jcli.learn_threshold(envs, str(d / "j_thr.txt"))
    assert thr_t == thr_j and (d / "t_thr.txt").read_text() == (d / "j_thr.txt").read_text()
    assert tcli.read_color_threshold(str(d / "j_thr.txt")) == thr_t

    objs = [p[f"obj{k}"] for k in range(5)]
    assert tcli.main(["learn-scene", p["env1"], p["env2"], "--out", str(d / "t_scene.pca"), "--block-size", "2",
                      "--color-threshold", str(d / "t_thr.txt"), "--device", "cpu"]) == 0
    assert tcli.main(["learn-object", *objs, "--out", str(d / "t_obj.pca"), "--color-threshold",
                      str(d / "t_thr.txt"), "--device", "cpu"]) == 0
    jcli.main(["learn-scene", p["env1"], p["env2"], "--out", str(d / "j_scene.pca"), "--block-size", "2",
               "--color-threshold", str(d / "j_thr.txt")])
    jcli.main(["learn-object", *objs, "--out", str(d / "j_obj.pca"), "--color-threshold", str(d / "j_thr.txt")])
    capsys.readouterr()
    for name in ("scene", "obj"):
        a, b = jpca.read_pca(str(d / f"t_{name}.pca")), jpca.read_pca(str(d / f"j_{name}.pca"))
        np.testing.assert_allclose(a.variance, b.variance, rtol=1e-4, atol=1e-6 * b.variance[0])
        # the leading subspaces that are well defined: eigengap above 1e-3 of the largest
        ks = [k for k in range(1, 11) if b.variance[k - 1] - b.variance[k] > 1e-3 * b.variance[0]]
        assert ks
        for k in ks:
            np.testing.assert_allclose(_proj(a.axis, k), _proj(b.axis, k), atol=1e-3)

    ranges = ["3", "2", "4"]
    for scene_pca in (None, "scene.pca"):
        for files_of in ("t", "j"):
            argv = ["detect", p["scene"], "--object-pca", str(d / f"{files_of}_obj.pca"), "--ranges", *ranges,
                    "--block-size", "2", "--dim", "20", "--color-threshold", str(d / "t_thr.txt"),
                    "--exist-threshold", "4"]
            if scene_pca:
                argv += ["--scene-pca", str(d / f"{files_of}_{scene_pca}")]
            assert tcli.main(argv + ["--device", "cpu"]) == 0
            got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            if files_of == "j" and scene_pca:  # the JAX CLI once; the port reads both packages' files
                assert jcli.main(argv) == 0
                want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
                _same_dets(got, want)
            assert got[0]["score"] > 0.99 and all(x["score"] <= got[0]["score"] for x in got)

    for extra in ([], ["--dim", "4"], ["-d", "3"], ["-c", "0.9"]):
        assert tcli.main(["variance-show", str(d / "j_obj.pca"), *extra]) == 0
        got = capsys.readouterr().out
        jcli.main(["variance-show", str(d / "j_obj.pca"), *extra])
        assert got == capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_detect_object_cli_refuses_cuda_without_a_card(files):
    _, p = files
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["learn-threshold", p["scene"]])
    with pytest.raises(ValueError, match="invalid RGB threshold"):
        bad = p["scene"] + ".thr"
        with open(bad, "w") as fp:
            fp.write("1 2 300\n")
        tcli.read_color_threshold(bad)


def test_similarity_grids_match(files):
    """Each mode's similarity grid of the scene, from the JAX package's
    object subspace: within 1e-4 everywhere (exist threshold 4)."""
    import jax.numpy as jnp

    from mapping_private_tpu.apps.detect_object import _grid as jgrid
    from mapping_private_tpu.features import colorchlac117_subdiv as j117, occupied_count_subdiv as jocc
    from mapping_private_tpu.io.pcd import load_pcd as jload
    from mapping_private_tpu.recognition import build_scene_data as jbuild, pca_fit as jfit, subspace_axis
    from mapping_private_tpu.recognition.search import _MODE_PERMS, _mode_scores as jscores
    from mapping_private_tpu_torch.features import colorchlac117_subdiv as t117, occupied_count_subdiv as tocc
    from mapping_private_tpu_torch.io.pcd import load_pcd as tload
    from mapping_private_tpu_torch.recognition import build_scene_data as tbuild
    from mapping_private_tpu_torch.recognition.search import _mode_scores as tscores

    d, p = files
    from mapping_private_tpu_torch.features import colorchlac117 as t117w

    feats = np.stack([t117w(tcli._grid(tload(p[f"obj{k}"], device="cpu"))[0]).numpy() for k in range(5)])
    aq = subspace_axis(jfit(jnp.asarray(feats)), 5)
    jg, tg = jgrid(jload(p["scene"]))[0], tcli._grid(tload(p["scene"], device="cpu"))[0]
    js = jbuild(j117(jg, 2), jocc(jg, 2))
    ts = tbuild(t117(tg, 2), tocc(tg, 2))
    for perm in _MODE_PERMS:
        r = tuple((3, 2, 4)[i] for i in perm)
        want = np.asarray(jscores(js.int_feat, js.int_exist, *r, jnp.asarray(aq), 4.0))
        got = tscores(ts.int_feat, ts.int_exist, *r, torch.tensor(aq), 4.0).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert (got > 0.99).sum() > 3  # the near-ties of _same_dets
