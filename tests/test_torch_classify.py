"""Port parity: classify/subspace.py, linear.py and libsvm.py against the
JAX package, and the ``classify`` CLI on a synthetic corpus.

- Subspaces by projector (eigenvectors have arbitrary signs); a JAX
  ``SubspaceClassifier`` carried across classifies alike: similarities
  within 1e-5, labels equal wherever the top two similarities are more
  than 1e-5 apart.
- The linear SVC: 200 Barzilai–Borwein steps amplify rounding, so the
  weights agree within 1e-2 of their scale and the labels where the top
  two decision values are more than 1e-2 apart.
- libsvm models and scale files read alike; decision values within
  1e-5 relative for each kernel, labels exactly.
- The CLI: ``rate`` with and without ``--leave-one-out`` on 3 objects × 3
  views written as PCD files, the leave-one-out one against the library
  on the same files; the library's rates equal the JAX CLI's on the same
  features; it refuses ``--device cuda`` without a card."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.apps import classify as jcli
from mapping_private_tpu.classify import libsvm as jlib
from mapping_private_tpu.classify import linear as jlin
from mapping_private_tpu.classify import subspace as jsub
from mapping_private_tpu.classify import train_svm as jsvm
from mapping_private_tpu_torch.apps import classify as tcli
from mapping_private_tpu_torch.classify import libsvm as tlib
from mapping_private_tpu_torch.classify import linear as tlin
from mapping_private_tpu_torch.classify import subspace as tsub
from mapping_private_tpu_torch.io.pcd import save_pcd


def _classes(seed, n_cls=4, d=12, n=48):
    rng = np.random.default_rng(seed)
    bases = [rng.normal(size=(3, d)) for _ in range(n_cls)]
    train = [(rng.normal(size=(n, 3)) @ b + 0.05 * rng.normal(size=(n, d))).astype(np.float32) for b in bases]
    test = np.vstack([rng.normal(size=(16, 3)) @ b for b in bases]).astype(np.float32)
    return train, test, np.repeat(np.arange(n_cls), 16)


@pytest.mark.parametrize("ms", [False, True])
def test_subspace_classifier_matches(ms):
    train, test, want = _classes(0)
    tc = tsub.train_subspaces(train, 3, multiple_similarity=ms, device="cpu")
    jc = jsub.train_subspaces(train, 3, multiple_similarity=ms)
    assert tc.axes.shape == jc.axes.shape == (4, 3, 12)
    np.testing.assert_array_equal(tc.labels, jc.labels)
    for a, b in zip(tc.axes, jc.axes):
        np.testing.assert_allclose(a.T @ a, b.T @ b, atol=1e-4)
    lt, st = tsub.classify_subspace(tc, torch.tensor(test))
    lj, sj = jsub.classify_subspace(jc, jnp.asarray(test))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-4)
    assert (lt.numpy() == want).mean() > 0.95
    carried = tsub.SubspaceClassifier(**dataclasses.asdict(jc))
    lc, sc = tsub.classify_subspace(carried, torch.tensor(test))
    np.testing.assert_allclose(sc.numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    top2 = np.sort(np.asarray(sj), axis=1)[:, -2:]
    firm = top2[:, 1] - top2[:, 0] > 1e-5
    np.testing.assert_array_equal(lc.numpy()[firm], np.asarray(lj)[firm])
    custom = tsub.train_subspaces(train, 2, labels=[7, 5, 3, 1], device="cpu")
    assert set(tsub.classify_subspace(custom, torch.tensor(test))[0].tolist()) <= {7, 5, 3, 1}


def test_linear_svm_matches():
    rng = np.random.default_rng(2)
    n = 120
    X = rng.normal(size=(3 * n, 4)).astype(np.float32)
    X[:n, 0] += 3
    X[n:2 * n, 1] += 3
    X[2 * n:, 2] += 3
    y = np.repeat([0, 1, 2], n)
    Wt = tlin.train_linear_svm(torch.tensor(X), torch.tensor(y), 3, C=1.0)
    Wj = np.asarray(jlin.train_linear_svm(jnp.asarray(X), jnp.asarray(y), 3, C=1.0))
    assert Wt.shape == (3, 5)
    np.testing.assert_allclose(Wt.numpy(), Wj, rtol=0, atol=1e-2 * np.abs(Wj).max())
    pt, dt = tlin.predict_linear(Wt, torch.tensor(X))
    pj, dj = jlin.predict_linear(jnp.asarray(Wj), jnp.asarray(X))
    top2 = np.sort(np.asarray(dj), axis=1)[:, -2:]
    firm = top2[:, 1] - top2[:, 0] > 1e-2
    np.testing.assert_array_equal(pt.numpy()[firm], np.asarray(pj)[firm])
    assert (pt.numpy() == y).mean() > 0.95
    # the same weights decide alike
    pc, dc = tlin.predict_linear(torch.tensor(Wj), torch.tensor(X))
    np.testing.assert_allclose(dc.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    rng = np.random.default_rng(3)
    X = np.vstack([rng.normal(c, 0.5, (15, 6)) for c in (-1.0, 0.0, 1.0, 2.0)]).astype(np.float32)
    y = np.repeat(np.arange(4), 15)
    path = tmp_path_factory.mktemp("svm") / "m.model"
    jsvm.save_libsvm_model(jsvm.to_libsvm_model(jsvm.train_svc_ovo(X, y, 4, C=5.0)), str(path))
    return str(path), X


@pytest.mark.parametrize("kernel", ["rbf", "linear", "polynomial", "sigmoid"])
def test_libsvm_models_match(model_file, kernel):
    path, X = model_file
    tm, jm = tlib.load_libsvm_model(path), jlib.load_libsvm_model(path)
    for f in dataclasses.fields(jm):
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    assert tm.nr_class == 4
    jm = dataclasses.replace(jm, kernel=kernel, gamma=0.1, coef0=0.5, degree=2)
    tm = tlib.SVMModel(**dataclasses.asdict(jm))  # carried across
    x = X[::3] * 0.9
    dt = tlib.svm_decision_values(tm, torch.tensor(x)).numpy()
    dj = np.asarray(jlib.svm_decision_values(jm, jnp.asarray(x)))
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5 * np.abs(dj).max())
    firm = (np.abs(dj) > 1e-4).all(axis=1)
    np.testing.assert_array_equal(tlib.svm_predict_batch(tm, torch.tensor(x)).numpy()[firm],
                                  np.asarray(jlib.svm_predict_batch(jm, jnp.asarray(x)))[firm])
    # shorter and longer queries are padded / cut to the model's width
    for width in (4, 8):
        xx = np.pad(x, ((0, 0), (0, 2)))[:, :width]
        np.testing.assert_allclose(tlib.svm_decision_values(tm, torch.tensor(xx)).numpy(),
                                   np.asarray(jlib.svm_decision_values(jm, jnp.asarray(xx))), rtol=1e-5,
                                   atol=1e-5 * np.abs(dj).max())


def test_scale_files_match(tmp_path):
    p = tmp_path / "s.scp"
    p.write_text("x\n-1 1\n1 0 10\n2 5 5\n4 -2 2\n")
    lt, ut, rt = tlib.load_scale_params(str(p))
    lj, uj, rj = jlib.load_scale_params(str(p))
    assert (lt, ut) == (lj, uj) == (-1.0, 1.0)
    np.testing.assert_array_equal(rt, rj)
    x = np.random.default_rng(5).uniform(-3, 12, (10, 6)).astype(np.float32)
    np.testing.assert_allclose(tlib.scale_features(torch.tensor(x), lt, ut, rt).numpy(),
                               np.asarray(jlib.scale_features(jnp.asarray(x), lj, uj, rj)), rtol=1e-6, atol=1e-6)
    (tmp_path / "y.scp").write_text("y\n0 1\n")
    with pytest.raises((ValueError, AssertionError)):
        tlib.load_scale_params(str(tmp_path / "y.scp"))


def _object_view(kind, rng, n=700):
    """One synthetic view of an object: points of its visible side, turned
    by a random angle about z, integer colours with noise."""
    if kind == 0:  # red box
        p = rng.uniform(-0.04, 0.04, (n, 3))
        face = rng.integers(0, 3, n)
        p[np.arange(n), face] = 0.04
        col = (200, 30, 30)
    elif kind == 1:  # green cylinder
        th = rng.uniform(-np.pi / 2, np.pi / 2, n)
        p = np.column_stack([0.03 * np.cos(th), 0.03 * np.sin(th), rng.uniform(0, 0.1, n)])
        col = (40, 190, 60)
    elif kind == 2:  # blue sphere
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        v[:, 0] = np.abs(v[:, 0])
        p = 0.035 * v
        col = (40, 60, 200)
    else:  # yellow flat plate
        p = np.column_stack([rng.uniform(-0.06, 0.06, (n, 2)), rng.normal(0, 0.001, n)])
        col = (210, 200, 40)
    a = rng.uniform(0, 2 * np.pi)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    xyz = (p @ R.T + rng.normal(0, 0.0008, p.shape)).astype(np.float32)
    rgb = np.clip(np.asarray(col) + rng.normal(0, 10, (n, 3)), 0, 255).round().astype(np.float32)
    return {"xyz": xyz, "r": rgb[:, 0], "g": rgb[:, 1], "b": rgb[:, 2]}


def write_corpus(root, n_objects=3, n_views=4, seed=0, n_points=700):
    rng = np.random.default_rng(seed)
    for o in range(n_objects):
        (root / f"obj{o:02d}").mkdir(parents=True)
        for v in range(n_views):
            save_pcd(str(root / f"obj{o:02d}" / f"view{v:02d}.pcd"), _object_view(o, rng, n_points))
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus"), n_views=3, n_points=400)


def test_classify_cli_round_trip(corpus, capsys):
    argv = ["rate", "--data-dir", corpus, "--feature", "r", "--dim", "2", "--device", "cpu"]
    assert tcli.main(argv + ["--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out["per_object"]) == ["obj00", "obj01", "obj02"] and out["rate"] == 1.0
    assert tcli.main(argv + ["--leave-one-out"]) == 0
    text = capsys.readouterr().out
    rate, per = tcli.classification_rate(corpus, "r", 2, leave_one_out=True, device="cpu")
    assert f"overall: {rate * 100:.2f}% ({round(rate * 9)}/9)" in text and rate >= 0.66
    assert all(f"{n}: {v * 100:.1f}%" in text for n, v in per.items())
    views = tcli.corpus_views(corpus, objects=["obj01"], max_views=2)
    assert views == jcli.corpus_views(corpus, objects=["obj01"], max_views=2)
    assert list(views) == ["obj01"] and len(views["obj01"]) == 2
    assert tcli.compute_feature(views["obj01"][0], "g", device="cpu").shape == (20,)


def test_classification_rate_matches_jax_on_the_same_features(corpus, monkeypatch):
    """The rate protocols (resubstitution and leave-one-out) of both
    packages on the port's features of the corpus (the JAX extraction is
    held to the port's in test_torch_evaluate.py): the same rates."""
    feats = {p: tcli.compute_feature(p, "r", device="cpu") for vs in tcli.corpus_views(corpus).values() for p in vs}
    monkeypatch.setattr(tcli, "compute_feature", lambda p, t, device: feats[p])
    monkeypatch.setattr(jcli, "compute_feature", lambda p, t: feats[p])
    for loo in (False, True):
        got = tcli.classification_rate(corpus, "r", 2, leave_one_out=loo, device="cpu")
        want = jcli.classification_rate(corpus, "r", 2, leave_one_out=loo)
        assert got[0] == want[0] and got[1] == want[1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_classify_cli_refuses_cuda_without_a_card(corpus):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["rate", "--data-dir", corpus, "--device", "cuda"])
