"""Port parity: ops/nn_dispatch.py (the 1-NN front door) against the JAX
package's ``nn_1nn``, same numpy inputs through both.

The port's brute engine sums direct differences (ops/nn_argmin.py); the
JAX package's CPU brute engine uses the expansion form, which cancels, so
brute distances are compared within 1e-5 and indices on rows whose
runner-up is farther than that.  The compact and lattice engines sum the
same direct differences: distances within 1e-6 (the JAX CPU program
fuses multiply-adds), indices on untied rows.

One divergence is by design: above ``LATTICE_CELL_LIMIT`` lattice cells
the JAX package silently runs the compact engine when asked for the
lattice (a limit of its compiler); the port always runs the lattice.
Both engines give the same d² (bit for bit within the port, see
``test_lattice_matches_compact_within_the_port``) and the same indices
wherever d² is not tied, so the results agree either way."""
import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.ops import nn_dispatch as jd
from mapping_private_tpu_torch.ops import nn_dispatch as td


def _cloud(n, seed=0, extent=2.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, (n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _pair():
    tgt = _cloud(2048, 0)
    qry = (tgt + np.float32(0.01)).astype(np.float32)
    tm = np.ones(2048, bool)
    tm[::7] = False
    qm = np.ones(2048, bool)
    qm[5:9] = False
    return qry, qm, tgt, tm


@pytest.mark.parametrize("nq,nt,radius", [
    (2048, 20000, 0.25), (1_000_000, 1_000_000, 0.05), (200_000, 200_000, 0.1),
    (1_000_000, 1_000_000, None), (32767, 32767, 0.1), (65536, 65536, 0.1),
])
def test_policy_matches(nq, nt, radius):
    assert td.choose_nn_engine(nq, nt, radius) == jd.choose_nn_engine(nq, nt, radius)
    assert td.BRUTE_PAIR_LIMIT == jd.BRUTE_PAIR_LIMIT


@pytest.mark.parametrize("engine", ["brute", "compact", "lattice"])
def test_engine_matches_jax(engine):
    qry, qm, tgt, tm = _pair()
    ij, sj = (np.asarray(a) for a in jd.nn_1nn(qry, qm, tgt, tm, radius=0.3, engine=engine))
    it, st = (a.numpy() for a in td.nn_1nn(*_t(qry, qm, tgt, tm), radius=0.3, engine=engine))
    assert it.dtype == np.int32 and st.dtype == np.float32
    np.testing.assert_array_equal(it == -1, ij == -1)
    ok = it >= 0
    np.testing.assert_allclose(st[ok], sj[ok], rtol=0, atol=1e-5 if engine == "brute" else 1e-6)
    assert np.isinf(st[~ok]).all() and (it[~qm] == -1).all()
    d2 = ((qry[:, None, :].astype(np.float64) - tgt[None, tm, :]) ** 2).sum(-1)
    part = np.partition(d2, 1, axis=1)
    clear = ok & (part[:, 1] - part[:, 0] > 2e-5)
    assert clear.sum() > 1900
    np.testing.assert_array_equal(it[clear], ij[clear])
    np.testing.assert_array_equal(it[clear], np.flatnonzero(tm)[d2.argmin(1)][clear])


def test_engines_agree_exactly_within_the_port():
    """Both engines sum direct differences, so they agree bit for bit
    wherever the nearest distance is untied."""
    qry, qm, tgt, tm = _pair()
    ib, sb = (a.numpy() for a in td.nn_1nn(*_t(qry, qm, tgt, tm), radius=0.3, engine="brute"))
    ic, sc = (a.numpy() for a in td.nn_1nn(*_t(qry, qm, tgt, tm), radius=0.3, engine="compact"))
    np.testing.assert_array_equal(sb, sc)
    assert (ib == ic).mean() > 0.999
    ia, sa = (a.numpy() for a in td.nn_1nn(*_t(qry, qm, tgt, tm), radius=0.3))  # auto: brute
    np.testing.assert_array_equal(ia, ib)


@pytest.mark.parametrize("engine", ["brute", "compact"])
def test_radius_gates(engine):
    tgt = _cloud(512, 1)
    qry = tgt + np.float32([0.0, 0.0, 1.0])  # 1 m away in z
    ones = np.ones(512, bool)
    i, s = td.nn_1nn(*_t(qry, ones, tgt, ones), radius=0.3, engine=engine)
    assert (i.numpy() == -1).all() and np.isinf(s.numpy()).all()


def test_no_radius_is_global_argmin():
    tgt = _cloud(600, 2)
    qry = tgt[:200] + np.float32([0.0, 0.0, 1.0])
    tm = np.ones(600, bool)
    tm[::3] = False
    i, s = td.nn_1nn(*_t(qry, np.ones(200, bool), tgt, tm))
    d2 = ((qry[:, None, :] - tgt[None, tm, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(i.numpy(), np.flatnonzero(tm)[d2.argmin(1)])
    np.testing.assert_allclose(s.numpy(), d2.min(1), rtol=1e-6)


@pytest.mark.parametrize("which", ["target", "query"])
def test_empty_side(which):
    tgt = _cloud(128, 2)
    ones, zeros = np.ones(128, bool), np.zeros(128, bool)
    args = (tgt, ones, tgt, zeros) if which == "target" else (tgt, zeros, tgt, ones)
    i, s = td.nn_1nn(*_t(*args), radius=0.3)
    assert (i.numpy() == -1).all() and np.isinf(s.numpy()).all()
    assert np.all(np.asarray(jd.nn_1nn(*args, radius=0.3)[0]) == -1)


def test_lattice_matches_compact_within_the_port():
    """The dense lattice and the compact engine walk the same stencil over
    the same distances: d² bit for bit, indices equal where untied."""
    qry, qm, tgt, tm = _pair()
    il, sl = (a.numpy() for a in td.nn_1nn(*_t(qry, qm, tgt, tm), radius=0.3, engine="lattice"))
    ic, sc = (a.numpy() for a in td.nn_1nn(*_t(qry, qm, tgt, tm), radius=0.3, engine="compact"))
    np.testing.assert_array_equal(sl, sc)
    assert (il == ic).mean() > 0.999 and (il[~qm] == -1).all()


def test_bad_arguments():
    tgt = _cloud(128, 3)
    ones = np.ones(128, bool)
    with pytest.raises(ValueError, match="radius"):
        td.nn_1nn(*_t(tgt, ones, tgt, ones), engine="compact")
    with pytest.raises(ValueError, match="radius"):
        td.nn_1nn(*_t(tgt, ones, tgt, ones), engine="lattice")
    with pytest.raises(ValueError, match="unknown engine"):
        td.nn_1nn(*_t(tgt, ones, tgt, ones), radius=0.3, engine="kdtree")


def test_lattice_overflow_raises():
    """A lattice whose cell count would wrap int32 keys raises through
    nn_1nn, as in the JAX package."""
    tgt = _cloud(256, 4, extent=500.0)
    ones = np.ones(256, bool)
    with pytest.raises(ValueError, match="lattice"):
        td.nn_1nn(*_t(tgt, ones, tgt, ones), radius=0.001, engine="compact")


def test_two_host_syncs_for_compact(monkeypatch):
    """The front door reads the device twice: live counts with bounds,
    then both occupancies."""
    calls = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: (calls.append(1), real_cpu(self, *a, **k))[1])
    for name in ("item", "tolist", "__bool__", "__float__"):
        def forbid(self, *a, _n=name, **k):
            raise AssertionError(f"host read through Tensor.{_n}")
        monkeypatch.setattr(torch.Tensor, name, forbid)
    qry, qm, tgt, tm = _pair()
    td.nn_1nn(*_t(qry, qm, tgt, tm), radius=0.3, engine="compact")
    assert len(calls) == 2
