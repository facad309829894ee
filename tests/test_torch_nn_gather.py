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
both rules are held against the JAX kernel and a numpy oracle.  In
``vpu`` mode the refs end as if padded to a whole window with
(PAD_COORD, PAD_COORD, PAD_COORD) refs of aux 0, as the JAX package pads
them, which shows where dead refs hold the minimum of a partial last
window (every ref dead and N < 512, say).  The CUDA kernel is held
against the plain version on the card (marked ``cuda``; skipped without
a GPU), with the refs split into stretches so that tie windows straddle a
boundary between two blocks."""
import re

import numpy as np
import pytest
import torch

from mapping_private_tpu_torch import _build
from mapping_private_tpu_torch.core.cloud import PAD_COORD
from mapping_private_tpu_torch.ops import nn_gather, nn_search
from mapping_private_tpu_torch.utils.metrics import metrics

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
    replace the carry only on a strictly smaller window minimum; the refs
    padded to a whole window as the JAX package pads them."""
    pad = -len(r) % W
    r = np.concatenate([r, np.full((pad, 3), PAD_COORD, np.float32)])
    a = np.concatenate([a, np.zeros((pad, 3), np.float32)])
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


def _dead_refs(n, seed):
    """Every ref dead (+PAD_COORD); live and dead queries."""
    q, r, a = _random(40, n, seed)
    r[:] = PAD_COORD
    q[::4] = -PAD_COORD
    return q, r, a


def _half_dead(n, seed):
    """Half of the refs dead; live queries, dead ones, and queries on the
    dead refs' point, whose minimum (0) is the dead refs'."""
    q, r, a = _random(40, n, seed)
    r[np.random.default_rng(seed).permutation(n)[: n // 2]] = PAD_COORD
    q[::4] = -PAD_COORD
    q[1::4] = PAD_COORD
    return q, r, a


DEAD_CASES = {
    "all_refs_dead_100": lambda: _dead_refs(100, 40),
    "all_refs_dead_700": lambda: _dead_refs(700, 41),
    "half_refs_dead_300": lambda: _half_dead(300, 42),
}


@pytest.mark.parametrize("dist", ["vpu", "mxu"])
@pytest.mark.parametrize("case", sorted(DEAD_CASES))
def test_dead_refs_match_jax_interpret(case, dist):
    """Where dead refs hold the minimum, the JAX kernel's padding joins the
    average in vpu mode when the last window is partial (N = 100: the aux
    rows' sum over 512, not over 100) and never in mxu mode (its padding's
    r² sums eight rows).  sq exactly on the rows that dead refs win (a
    live row elsewhere may differ in its last bit: XLA's CPU backend may
    fuse the JAX side's products into FMAs); gathered rows within 1e-6,
    the xyz relative to their size, except that the JAX side's f32
    one-hot product sums 512 rows of PAD_COORD / 512 to 1e8 - 168, where
    the exact average, the numpy oracle's and the port's, is 1e8 (2e-6)."""
    q, r, a = DEAD_CASES[case]()
    sq_t, qs_t, ns_t = _port(q, r, a, dist)
    sq_j, qs_j, ns_j = _jax(q, r, a, dist)
    dead_won = qs_t[:, 0] > 0.5 * PAD_COORD
    assert dead_won.sum() >= 10
    np.testing.assert_array_equal(sq_t[dead_won], sq_j[dead_won])
    np.testing.assert_allclose(sq_t, sq_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ns_t, ns_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(qs_t, qs_j, rtol=2e-6, atol=1e-6)
    if dist == "vpu":
        sq_o, qs_o, ns_o = _oracle_vpu(q, r, a)
        np.testing.assert_array_equal(sq_t, sq_o)
        np.testing.assert_allclose(qs_t, qs_o, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ns_t, ns_o, rtol=0, atol=1e-6)
    if case == "all_refs_dead_100":  # worked by hand: 100 dead refs and 412 padding refs tie
        live = q[:, 0] > -1e7
        want = a.sum(0) / (512 if dist == "vpu" else 100)
        np.testing.assert_allclose(ns_t[live], np.broadcast_to(want, ns_t[live].shape), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(qs_t[live], PAD_COORD)


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
    before = metrics.counters["nn_gather.launches"]
    q, r, a = _random(0, 20, 6)
    sq, qs, ns = _port(q, r, a, "vpu")
    assert sq.shape == (0,) and qs.shape == ns.shape == (0, 3)
    _port(*_random(10, 20, 6), "mxu")
    assert metrics.counters["nn_gather.launches"] == before


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
    before = metrics.counters["nn_gather.launches"]
    sq_k, qs_k, ns_k = _port(q, r, a, dist, cuda_device)
    torch.cuda.synchronize()
    assert metrics.counters["nn_gather.launches"] == before + 1
    rt, nt = nn_gather.prepare_nn_ref(torch.from_numpy(r).to(cuda_device), torch.from_numpy(a).to(cuda_device))
    sq_p, qs_p, ns_p = (t.cpu().numpy() for t in nn_gather.nn_gather_plain(
        torch.from_numpy(q).to(cuda_device), rt, nt, dist))
    # the same f32 operations in the same order: d² bit for bit; gathered
    # rows equal, tie averages within 4 ulp of the largest value (the
    # plain version sums the tied rows in the library's order)
    np.testing.assert_array_equal(sq_k, sq_p)
    np.testing.assert_allclose(qs_k, qs_p, rtol=0, atol=4 * EPS * max(1.0, float(np.abs(qs_p).max())))
    np.testing.assert_allclose(ns_k, ns_p, rtol=0, atol=4 * EPS * max(1.0, float(np.abs(ns_p).max())))


# -- the search skeleton's split of the refs (ops/nn_search.py) -------------

def test_entry_point_extends_the_skeleton_launch():
    """``nn_gather_launch`` takes ``nn_search::launch``'s arguments, as
    ``nn_argmin_launch`` does, with the output policy's (mode, aux rows,
    three outputs) in place of (idx, sq): what ``ops/nn_gather.py`` passes
    through ``nn_search.search``."""
    def names(kernel):
        text = _build.source_path(kernel).read_text()
        params = re.search(rf'extern "C" int {kernel}_launch\(([^)]*)\)', text).group(1).split(",")
        return [p.split()[-1].lstrip("*") for p in params]

    argmin, gather = names("nn_argmin"), names("nn_gather")
    assert argmin[-3:] == ["idx", "sq", "stream"]
    assert gather == argmin[:-3] + ["mode", "nt", "sq", "qsel", "nsel", "stream"]
    assert _build.KERNELS["nn_gather"][:-6] == _build.KERNELS["nn_argmin"][:-3]


def _split_cases():
    """name -> (queries, refs, aux, stretches asked for, whether the data
    has exact ties).  In the first, tie copies lie on both sides of a
    stretch boundary inside one window (averaged) and in two windows of two
    stretches (the first wins alone): its first 30 queries sit on them."""
    cases = {}
    nr, splits = 5000, 3
    b = nn_search.stretch_len(nr, splits)
    assert b % W and (b - 20) // W == (b + 19) // W  # the boundary falls inside a window
    q, r, a = _random(400, nr, 30)
    r[b : b + 20] = r[b - 20 : b]
    r[2 * b : 2 * b + 10] = r[10:20]
    q[:20], q[20:30] = r[b - 20 : b], r[10:20]
    cases["ties_inside_a_window_across_a_boundary_3_stretches"] = (q, r, a, splits, True)
    cases["one_query_4_stretches"] = (*_random(1, 9000, 31), 4, False)
    cases["ragged_5_stretches"] = (*_random(513, 4099, 32), 5, False)
    q, r, a = _dead(33)
    q[:] = -PAD_COORD  # every ref ~1e8 away: d2 steps by ~2e9 there, ties everywhere
    cases["all_queries_dead_3_stretches"] = (q, r, a, 3, True)
    cases["all_refs_dead_100_2_stretches"] = (*_dead_refs(100, 34), 2, True)
    cases["half_refs_dead_300_3_stretches"] = (*_half_dead(300, 35), 3, True)
    return cases


SPLIT_CASES = sorted(_split_cases())


def _by_hand(q, r, a):
    """The first case's 30 queries: (aux rows of the copies averaged, the
    first copy's aux row alone)."""
    b = nn_search.stretch_len(len(r), 3)
    return np.concatenate([(a[b - 20 : b] + a[b : b + 20]) / 2, a[10:20]])


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_cases_on_cpu_oracle(case):
    """The cases themselves: the plain version equals the numpy oracle in
    vpu mode, and in both exact modes the averages worked out by hand."""
    q, r, a, _, _ = _split_cases()[case]
    sq_t, qs_t, ns_t = _port(q, r, a, "vpu")
    sq_o, qs_o, ns_o = _oracle_vpu(q, r, a)
    np.testing.assert_array_equal(sq_t, sq_o)
    np.testing.assert_allclose(qs_t, qs_o, rtol=1e-6, atol=2 * EPS)
    np.testing.assert_allclose(ns_t, ns_o, rtol=0, atol=8 * EPS)
    if case.startswith("ties_inside"):
        for dist in ("vpu", "mxu"):
            _, qs, ns = _port(q[:30], r, a, dist)
            np.testing.assert_array_equal(qs, q[:30])
            np.testing.assert_allclose(ns, _by_hand(q, r, a), rtol=0, atol=8 * EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("dist", nn_gather.DIST_MODES)
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_kernel_split_boundaries_on_card(case, dist, cuda_device):
    """At the stretches asked for, at one and at the wrapper's own choice:
    sq bit for bit, gathered rows equal to the plain version's (tie
    averages within 4 ulp of the largest value: the plain version sums the
    tied rows in the library's order), the ticket counters zeroed after."""
    q, r, a, splits, ties = _split_cases()[case]
    qd = torch.from_numpy(q).to(cuda_device)
    rt, nt = nn_gather.prepare_nn_ref(torch.from_numpy(r).to(cuda_device), torch.from_numpy(a).to(cuda_device))
    sq_p, qs_p, ns_p = (t.cpu().numpy() for t in nn_gather.nn_gather_plain(qd, rt, nt, dist))
    tol_q = 4 * EPS * max(1.0, float(np.abs(qs_p).max()))
    tol_n = 4 * EPS * max(1.0, float(np.abs(ns_p).max()))
    for s in (splits, 1, None):
        sq_k, qs_k, ns_k = (t.cpu().numpy() for t in nn_gather._launch(qd, rt, nt, dist, s))
        torch.cuda.synchronize()
        if s == splits:
            assert nn_search.last_stretches == nn_search.stretch_count(len(r), splits) > 1
        np.testing.assert_array_equal(sq_k.view(np.int32), sq_p.view(np.int32))
        np.testing.assert_allclose(qs_k, qs_p, rtol=0, atol=tol_q)
        np.testing.assert_allclose(ns_k, ns_p, rtol=0, atol=tol_n)
        if not ties:
            np.testing.assert_array_equal(qs_k, qs_p)
            np.testing.assert_array_equal(ns_k, ns_p)
        if case.startswith("ties_inside") and dist != "mxu_fast":
            np.testing.assert_array_equal(qs_k[:30], q[:30])
            np.testing.assert_allclose(ns_k[:30], _by_hand(q, r, a), rtol=0, atol=8 * EPS)
    for counters in nn_search._counters.values():
        assert int(counters.count_nonzero()) == 0


@pytest.mark.cuda
def test_launch_refuses_an_unknown_mode(cuda_device):
    nq, nr = 5, 40
    q, rt, nt = (torch.zeros(shape, device=cuda_device) for shape in ((nq, 3), (3, nr), (3, nr)))
    sq = torch.full((nq,), -7.0, device=cuda_device)
    sel = torch.empty((nq, 3), device=cuda_device)
    with pytest.raises(RuntimeError, match="invalid"):
        nn_search.search("nn_gather", q, rt, nr, (len(nn_gather.DIST_MODES), nt, sq, sel, sel), 1)
    torch.cuda.synchronize()
    assert bool((sq == -7.0).all())
