"""Port parity: classify/train_svm.py against the JAX package.

The same seeded blobs go through both trainers.  The SMO steps round
differently (the JAX CPU program may fuse the gradient update's
multiply-adds), so late working sets and the solutions differ in the
last bits: decision values agree within 2e-3 and predicted labels
exactly wherever no decision value lies within 1e-4 of 0.  A JAX
``OVOSVM`` carried into the port gives the same decision values (1e-5)
and votes; ``to_libsvm_model`` of it gives the same arrays, and
``save_libsvm_model`` the same bytes, in both packages."""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.classify import libsvm as jlib
from mapping_private_tpu.classify import train_svm as jsvm
from mapping_private_tpu_torch.classify import libsvm as tlib
from mapping_private_tpu_torch.classify import train_svm as tsvm


def _blobs(rng, n_per, centers, scale=0.35):
    X, y = [], []
    for c, mu in enumerate(centers):
        X.append(rng.normal(mu, scale, (n_per, len(mu))))
        y.append(np.full(n_per, c))
    return np.vstack(X).astype(np.float32), np.concatenate(y)


def _compare(tm, jm, X):
    dt = tsvm.decision_values_ovo(tm, torch.tensor(X)).numpy()
    dj = np.asarray(jsvm.decision_values_ovo(jm, jnp.asarray(X)))
    np.testing.assert_allclose(dt, dj, rtol=0, atol=2e-3)
    firm = (np.abs(dj) > 1e-4).all(axis=1)
    lt, vt = tsvm.predict_ovo(tm, torch.tensor(X))
    lj, vj = jsvm.predict_ovo(jm, jnp.asarray(X))
    np.testing.assert_array_equal(lt.numpy()[firm], np.asarray(lj)[firm])
    np.testing.assert_array_equal(vt.numpy()[firm], np.asarray(vj)[firm])
    assert firm.mean() > 0.9
    return lt.numpy()


def test_rbf_kernel_matches():
    rng = np.random.default_rng(0)
    x, z = rng.normal(size=(30, 5)).astype(np.float32), rng.normal(size=(20, 5)).astype(np.float32)
    np.testing.assert_allclose(tsvm.rbf_kernel(torch.tensor(x), torch.tensor(z), 0.3).numpy(),
                               np.asarray(jsvm.rbf_kernel(jnp.asarray(x), jnp.asarray(z), 0.3)), rtol=1e-5, atol=1e-6)


def test_binary_smo_matches_and_meets_kkt():
    rng = np.random.default_rng(0)
    X, y = _blobs(rng, 40, [(-1.0, 0.0), (1.0, 0.0)], scale=0.6)
    tm = tsvm.train_svc_ovo(X, y, 2, C=10.0, gamma=0.5, tol=1e-4, device="cpu")
    jm = jsvm.train_svc_ovo(X, y, 2, C=10.0, gamma=0.5, tol=1e-4)
    np.testing.assert_array_equal(tm.pair_idx, jm.pair_idx)
    np.testing.assert_allclose(tm.alpha_y, jm.alpha_y, rtol=0, atol=2e-3 * 10.0)
    np.testing.assert_allclose(tm.rho, jm.rho, rtol=0, atol=2e-3)
    assert (tm.gamma, tm.C, tm.num_classes) == (jm.gamma, jm.C, jm.num_classes)
    _compare(tm, jm, X)
    # KKT on the port's own solution: free SVs on the margin, yᵀα = 0
    ay = np.zeros(len(X))
    ok = tm.pair_idx[0] >= 0
    ay[tm.pair_idx[0][ok]] = tm.alpha_y[0][ok]
    dec = tsvm.decision_values_ovo(tm, torch.tensor(X)).numpy()[:, 0]
    ysgn = np.where(y == 0, 1.0, -1.0)
    free = (np.abs(ay) > 1e-6) & (np.abs(ay) < 10.0 - 1e-6)
    assert free.any()
    np.testing.assert_allclose((ysgn * dec)[free], 1.0, atol=5e-3)
    assert np.all((ysgn * dec)[np.abs(ay) <= 1e-6] > 1.0 - 5e-3)
    assert abs(ay.sum()) < 1e-5


def test_multiclass_matches_and_model_carries_across(tmp_path):
    rng = np.random.default_rng(2)
    centers = [(-2, -2, 0), (2, -2, 0), (-2, 2, 0), (2, 2, 1), (0, 0, 2)]
    Xtr, ytr = _blobs(rng, 24, centers, scale=0.9)
    Xte, yte = _blobs(rng, 12, centers, scale=0.9)
    tm = tsvm.train_svc_ovo(Xtr, ytr, 5, C=10.0, device="cpu")
    jm = jsvm.train_svc_ovo(Xtr, ytr, 5, C=10.0)
    assert tm.gamma == jm.gamma == 1.0 / 3
    np.testing.assert_array_equal(tm.pairs, jm.pairs)
    pred = _compare(tm, jm, Xte)
    assert (pred == yte).mean() > 0.8

    carried = tsvm.OVOSVM(**dataclasses.asdict(jm))
    np.testing.assert_allclose(tsvm.decision_values_ovo(carried, torch.tensor(Xte)).numpy(),
                               np.asarray(jsvm.decision_values_ovo(jm, jnp.asarray(Xte))), rtol=0, atol=1e-5)
    ts, js = tsvm.to_libsvm_model(carried), jsvm.to_libsvm_model(jm)
    for f in dataclasses.fields(js):
        a, b = getattr(ts, f.name), getattr(js, f.name)
        (np.testing.assert_array_equal if isinstance(b, np.ndarray) else (lambda u, v: (u == v) or pytest.fail(f.name)))(a, b)
    pt, pj = tmp_path / "t.model", tmp_path / "j.model"
    tsvm.save_libsvm_model(ts, str(pt))
    jsvm.save_libsvm_model(js, str(pj))
    assert pt.read_bytes() == pj.read_bytes()
    # the retrained model drops in for a bundled one, in both packages
    loaded = tlib.load_libsvm_model(str(pj))
    lab = tlib.svm_predict_batch(loaded, torch.tensor(Xte)).numpy()
    np.testing.assert_array_equal(lab, np.asarray(jlib.svm_predict_batch(jlib.load_libsvm_model(str(pt)),
                                                                         jnp.asarray(Xte))))
    np.testing.assert_array_equal(lab, tsvm.predict_ovo(carried, torch.tensor(Xte))[0].numpy())


def test_max_iter_warns_in_both():
    rng = np.random.default_rng(3)
    X, y = _blobs(rng, 20, [(0, 0), (0.3, 0)], scale=1.0)
    with pytest.warns(UserWarning, match="max_iter=5"):
        tm = tsvm.train_svc_ovo(X, y, 2, C=10.0, max_iter=5, device="cpu")
    with pytest.warns(UserWarning, match="max_iter=5"):
        jm = jsvm.train_svc_ovo(X, y, 2, C=10.0, max_iter=5)
    # five steps from the same start take the same working sets
    np.testing.assert_allclose(tm.alpha_y, jm.alpha_y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.rho, jm.rho, rtol=0, atol=1e-5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsvm.train_svc_ovo(X, y, 2, C=10.0, device="cpu")


def test_smo_freezes_converged_pairs():
    """A batch of two problems: the easy one stops at its own step count
    and keeps its state while the other goes on."""
    rng = np.random.default_rng(4)
    Xa, ya = _blobs(rng, 10, [(-3, 0), (3, 0)], scale=0.2)
    Xb, yb = _blobs(rng, 10, [(0, 0), (0.2, 0)], scale=1.0)
    Q, Y, V = [], [], []
    for X, y in ((Xa, ya), (Xb, yb)):
        s = np.where(y == 0, 1.0, -1.0).astype(np.float32)
        K = tsvm.rbf_kernel(torch.tensor(X), torch.tensor(X), 0.5)
        Q.append(torch.tensor(s)[:, None] * torch.tensor(s)[None, :] * K)
        Y.append(torch.tensor(s))
        V.append(torch.ones(len(s), dtype=torch.bool))
    a, rho, gap, it = tsvm._smo(torch.stack(Q), torch.stack(Y), torch.stack(V), 10.0, 1e-3, 20000)
    for k in range(2):
        a1, rho1, gap1, it1 = tsvm._smo(Q[k][None], Y[k][None], V[k][None], 10.0, 1e-3, 20000)
        assert int(it1[0]) == int(it[k])
        assert torch.equal(a1[0], a[k])  # the steps are elementwise: bit for bit
        torch.testing.assert_close(rho1, rho[k:k + 1], rtol=0, atol=1e-6)  # a product of another batch
    assert int(it[0]) < int(it[1]) and (gap < 1e-3).all()
    ja, jrho, jgap, jit_ = jsvm._smo(jnp.asarray(Q[0].numpy()), jnp.asarray(Y[0].numpy()), jnp.asarray(V[0].numpy()),
                                     10.0, 1e-3, 20000)
    np.testing.assert_allclose(a[0].numpy(), np.asarray(ja), rtol=0, atol=1e-3)
