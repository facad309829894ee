"""Port parity: ops/nn_gather.py (the fused 1-NN + gather).

The plain PyTorch version is held against the JAX Pallas kernel
``nn_gather_prepared(..., interpret=True)``, as
tests/test_pallas_kernels.py runs it, in all three distance modes:

- ``vpu``: both sides sum the same direct differences in f32: ``sq``
  within 1e-6, gathered rows within 1e-6 (the JAX side gathers through a
  one-hot product).
- ``mxu``: the expansion form cancels, and the two sides round in
  different places: ``sq`` within 8·eps·(|q|² + |r|²); gathered rows are
  compared on rows whose runner-up is farther than twice that.
- ``mxu_fast``: on the TPU one bf16 pass, in JAX interpret mode on the
  CPU a full f32 product, so it is checked by outcome: the gathered xyz
  is a ref row and its true distance is within the bf16 bound
  2⁻⁵·|q|·|r| of the true nearest.

Exact ties (duplicated refs with different aux) are averaged inside one
aligned window of 512 refs and resolved by strict '<' across windows;
both rules are held against the JAX kernel and a numpy oracle.  The CUDA
kernel is held against the plain version on the card (marked ``cuda``;
skipped without a GPU)."""
import numpy as np
import pytest
import torch

from mapping_private_tpu_torch.core.cloud import PAD_COORD
from mapping_private_tpu_torch.ops import nn_gather

EPS = np.finfo(np.float32).eps
W = nn_gather.TIE_WINDOW


def _random(nq, nr, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (nq, 3)).astype(np.float32),
            rng.uniform(-1, 1, (nr, 3)).astype(np.float32),
            rng.normal(size=(nr, 3)).astype(np.float32))


def _dead(seed):
    q, r, a = _random(300, 1300, seed)
    q[::7] = -PAD_COORD
    r[::5] = PAD_COORD
    return q, r, a


def _ties(seed):
    """Duplicated refs with DIFFERENT aux rows: pairs inside window 0,
    pairs split across windows 0|1 and 1|2, and a triple inside window
    1.  The first 40 queries sit exactly on the duplicated points."""
    q, r, a = _random(200, 3 * W - 100, seed)
    for k in range(10):
        r[20 + k] = r[300 + k]                       # both in window 0
        r[W + 40 + k] = r[100 + k]                   # windows 0 | 1
        r[2 * W + 5 + k] = r[W + 200 + k]            # windows 1 | 2
        r[W + 300 + k] = r[W + 320 + k] = r[W + 340 + k]  # triple in window 1
    q[:10], q[10:20] = r[300:310], r[100:110]
    q[20:30], q[30:40] = r[W + 200:W + 210], r[W + 340:W + 350]
    return q, r, a


CASES = {
    "random_300x900": lambda: _random(300, 900, 0),
    "four_windows_500x1900": lambda: _random(500, 1900, 1),
    "dead_queries_and_refs": lambda: _dead(2),
    "ties_in_and_across_windows": lambda: _ties(3),
}


def _port(q, r, a, dist, device="cpu"):
    out = nn_gather.nn_gather(*(torch.from_numpy(x).to(device) for x in (q, r, a)), dist=dist)
    return tuple(t.cpu().numpy() for t in out)


def _jax(q, r, a, dist):
    import jax.numpy as jnp

    from mapping_private_tpu.ops.pallas_nn import nn_gather_pallas

    out = nn_gather_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(a), interpret=True, dist=dist)
    return tuple(np.asarray(x) for x in out)


def _true_d2(q, r):
    return ((q[:, None, :].astype(np.float64) - r[None, :, :].astype(np.float64)) ** 2).sum(-1)


def _oracle_vpu(q, r, a):
    """numpy, window by window: average the exact ties of a window,
    replace the carry only on a strictly smaller window minimum."""
    sq = np.full(len(q), np.inf, np.float32)
    qs = np.zeros((len(q), 3), np.float64)
    ns = np.zeros((len(q), 3), np.float64)
    for w0 in range(0, len(r), W):
        rw, aw = r[w0:w0 + W], a[w0:w0 + W]
        d = q[:, None, :] - rw[None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        m = d2.min(1)
        hits = (d2 == m[:, None]).astype(np.float64)
        hits /= hits.sum(1, keepdims=True)
        better = m < sq
        sq = np.where(better, m, sq)
        qs = np.where(better[:, None], hits @ rw.astype(np.float64), qs)
        ns = np.where(better[:, None], hits @ aw.astype(np.float64), ns)
    return sq, qs, ns


@pytest.mark.parametrize("case", sorted(CASES))
def test_vpu_matches_jax_interpret_and_oracle(case):
    q, r, a = CASES[case]()
    sq_t, qs_t, ns_t = _port(q, r, a, "vpu")
    sq_j, qs_j, ns_j = _jax(q, r, a, "vpu")
    live = q[:, 0] > -1e7
    np.testing.assert_allclose(sq_t[live], sq_j[live], rtol=0, atol=1e-6)
    np.testing.assert_allclose(sq_t[~live], sq_j[~live], rtol=1e-6)
    np.testing.assert_allclose(qs_t[live], qs_j[live], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ns_t[live], ns_j[live], rtol=0, atol=1e-5)
    sq_o, qs_o, ns_o = _oracle_vpu(q, r, a)
    np.testing.assert_array_equal(sq_t, sq_o)
    np.testing.assert_allclose(qs_t[live], qs_o[live], rtol=0, atol=2 * EPS)
    np.testing.assert_allclose(ns_t[live], ns_o[live], rtol=0, atol=8 * EPS)
    assert sq_t.dtype == qs_t.dtype == ns_t.dtype == np.float32
    assert np.isfinite(sq_t).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_mxu_matches_jax_interpret(case):
    q, r, a = CASES[case]()
    sq_t, qs_t, ns_t = _port(q, r, a, "mxu")
    sq_j, qs_j, ns_j = _jax(q, r, a, "mxu")
    live = q[:, 0] > -1e7
    d2 = _true_d2(q, r)
    part = np.partition(d2, 1, axis=1)
    scale = (q.astype(np.float64) ** 2).sum(1) + (r[d2.argmin(1)].astype(np.float64) ** 2).sum(1)
    tol = 8 * EPS * scale
    assert np.all(np.abs(sq_t - sq_j)[live] <= tol[live])
    assert np.all(np.abs(sq_t - part[:, 0])[live] <= tol[live])
    # rows with one clear winner (duplicated points: compare below)
    clear = live & ((part[:, 1] - part[:, 0]) > 2 * tol)
    assert clear.sum() > 0.8 * live.sum() - 40
    np.testing.assert_array_equal(qs_t[clear], r[d2.argmin(1)][clear])
    np.testing.assert_array_equal(ns_t[clear], a[d2.argmin(1)][clear])
    np.testing.assert_allclose(qs_t[clear], qs_j[clear], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ns_t[clear], ns_j[clear], rtol=0, atol=1e-5)


def test_mxu_ties_match_jax():
    """Duplicated refs give bit-equal d² in any form, so the expansion
    mode averages and carries them exactly as the vpu mode does."""
    q, r, a = _ties(3)
    _, qs_t, ns_t = _port(q[:40], r, a, "mxu")
    _, qs_j, ns_j = _jax(q[:40], r, a, "mxu")
    _, qs_o, ns_o = _oracle_vpu(q[:40], r, a)
    np.testing.assert_allclose(qs_t, qs_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ns_t, ns_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ns_t, ns_o, rtol=0, atol=8 * EPS)


def test_tie_rules_by_hand():
    """In one window: the average of the tied aux rows.  Across windows:
    the first window's row alone."""
    q, r, a = _ties(3)
    for dist in ("vpu", "mxu"):
        sq, qs, ns = _port(q[:40], r, a, dist)
        # duplicates average to themselves: exactly for pairs (weight 1/2),
        # within an ulp for the triple (weight 1/3)
        np.testing.assert_array_equal(qs[:30], q[:30])
        np.testing.assert_allclose(qs[30:], q[30:40], rtol=0, atol=2 * EPS)
        np.testing.assert_allclose(ns[:10], (a[20:30] + a[300:310]) / 2, atol=8 * EPS)
        np.testing.assert_array_equal(ns[10:20], a[100:110])
        np.testing.assert_array_equal(ns[20:30], a[W + 200:W + 210])
        triple = (a[W + 300:W + 310] + a[W + 320:W + 330] + a[W + 340:W + 350]) / 3
        np.testing.assert_allclose(ns[30:40], triple, atol=8 * EPS)
        if dist == "vpu":
            np.testing.assert_array_equal(sq, 0.0)


@pytest.mark.parametrize("case", ["random_300x900", "four_windows_500x1900", "dead_queries_and_refs"])
def test_mxu_fast_outcomes(case):
    q, r, a = CASES[case]()
    sq_t, qs_t, ns_t = _port(q, r, a, "mxu_fast")
    live = q[:, 0] > -1e7
    d2 = _true_d2(q, r)
    # the gathered xyz is a ref row (ties between distinct refs under bf16
    # are possible but not on this data), and the aux row is that ref's
    match = (qs_t[:, None, :] == r[None, :, :]).all(-1)
    assert match.any(1)[live].all()
    pick = match.argmax(1)
    np.testing.assert_array_equal(ns_t[live], a[pick][live])
    bound = 2.0 ** -5 * np.linalg.norm(q, axis=1) * np.linalg.norm(r[pick], axis=1) + 1e-5
    rows = np.arange(len(q))
    assert np.all((d2[rows, pick] - d2.min(1))[live] <= bound[live])
    assert np.all(np.abs(sq_t - d2[rows, pick])[live] <= bound[live])
    # and it is a different function from the exact modes on some rows
    assert np.isfinite(sq_t).all()


def test_plain_blocks_over_query_rows(monkeypatch):
    q, r, a = _ties(4)
    want = _port(q, r, a, "mxu")
    monkeypatch.setattr(nn_gather, "_CHUNK_ELEMS", len(r) * 64)
    got = _port(q, r, a, "mxu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_prepared_form_and_default_mode():
    q, r, a = _random(50, 700, 5)
    rt, nt = nn_gather.prepare_nn_ref(torch.from_numpy(r), torch.from_numpy(a))
    assert rt.shape == nt.shape == (3, 700) and rt.is_contiguous()
    got = nn_gather.nn_gather_prepared(torch.from_numpy(q), rt, nt)  # default: mxu
    want = _port(q, r, a, "mxu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("bad", ["dist", "query_cols", "rt_rows", "nt_shape", "dtype", "no_refs", "aux_shape"])
def test_wrapper_rejects_bad_inputs(bad):
    q, rt, nt = torch.zeros(4, 3), torch.zeros(3, 5), torch.zeros(3, 5)
    f = nn_gather.nn_gather_prepared
    if bad == "dist":
        with pytest.raises(ValueError, match="dist"):
            f(q, rt, nt, dist="exact")
    elif bad == "query_cols":
        with pytest.raises(ValueError):
            f(q[:, :2], rt, nt)
    elif bad == "rt_rows":
        with pytest.raises(ValueError):
            f(q, torch.zeros(5, 3), torch.zeros(5, 3))
    elif bad == "nt_shape":
        with pytest.raises(ValueError):
            f(q, rt, torch.zeros(3, 6))
    elif bad == "dtype":
        with pytest.raises(TypeError):
            f(q, rt.double(), nt.double())
    elif bad == "no_refs":
        with pytest.raises(ValueError):
            f(q, rt[:, :0], nt[:, :0])
    else:
        with pytest.raises(ValueError):
            nn_gather.prepare_nn_ref(torch.zeros(5, 3), torch.zeros(4, 3))


def test_cpu_never_counts_a_launch_and_empty_queries():
    before = nn_gather.launches
    q, r, a = _random(0, 20, 6)
    sq, qs, ns = _port(q, r, a, "vpu")
    assert sq.shape == (0,) and qs.shape == ns.shape == (0, 3)
    _port(*_random(10, 20, 6), "mxu")
    assert nn_gather.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel is CUDA C++ for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dist", nn_gather.DIST_MODES)
@pytest.mark.parametrize("case", sorted(CASES) + ["ragged_20011x19997", "one_query"])
def test_kernel_matches_plain_on_card(case, dist, cuda_device):
    if case == "ragged_20011x19997":
        q, r, a = _random(20011, 19997, 10)
    elif case == "one_query":
        q, r, a = _random(1, 5, 11)
    else:
        q, r, a = CASES[case]()
    before = nn_gather.launches
    sq_k, qs_k, ns_k = _port(q, r, a, dist, cuda_device)
    torch.cuda.synchronize()
    assert nn_gather.launches == before + 1
    rt, nt = nn_gather.prepare_nn_ref(torch.from_numpy(r).to(cuda_device), torch.from_numpy(a).to(cuda_device))
    sq_p, qs_p, ns_p = (t.cpu().numpy() for t in nn_gather.nn_gather_plain(
        torch.from_numpy(q).to(cuda_device), rt, nt, dist))
    # the same f32 operations in the same order: d² bit for bit; gathered
    # rows equal, tie averages within 4 ulp of the largest value (the
    # plain version sums the tied rows in the library's order)
    np.testing.assert_array_equal(sq_k, sq_p)
    np.testing.assert_allclose(qs_k, qs_p, rtol=0, atol=4 * EPS * max(1.0, float(np.abs(qs_p).max())))
    np.testing.assert_allclose(ns_k, ns_p, rtol=0, atol=4 * EPS * max(1.0, float(np.abs(ns_p).max())))
