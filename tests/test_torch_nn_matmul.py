"""Port parity: ops/nn_matmul.py (the matmul-form 1-NN).

The plain PyTorch version is held against the JAX Pallas kernel
``nn_pallas(..., interpret=True)``, as tests/test_pallas_kernels.py runs
it.  Both compute d² = q² + r² − 2 q·r in f32 but round in different
places (the JAX side's cross term is XLA's CPU dot), and the form cancels:
d² carries an error of about 4·eps·(|q|² + |r|²).  So ``sq`` is compared
within 8·eps·(|q|² + |r|²) per row, and ``idx`` only on rows whose
runner-up is farther than twice that (all other rows must still pick a
ref whose true distance is within the bound of the best).  Against a
numpy oracle in the port's own operation order the plain version is
bit-exact.  The CUDA kernel is held against the plain version on the card
(marked ``cuda``; skipped without a GPU), also with the refs split into
stretches so that ties, dead refs, the NaN-filled tile tail and slightly
negative d² fall on and around a boundary between two blocks; jax is
imported inside the parity tests only, so ``-m cuda --noconftest`` needs
no jax."""
import numpy as np
import pytest
import torch

from mapping_private_tpu_torch.core.cloud import PAD_COORD
from mapping_private_tpu_torch.ops import nn_matmul, nn_search
from mapping_private_tpu_torch.utils.metrics import metrics

EPS = np.finfo(np.float32).eps


def _random(nq, nr, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (nq, 3)).astype(np.float32),
            rng.uniform(-scale, scale, (nr, 3)).astype(np.float32))


def _dead_refs(seed):
    q, r = _random(300, 1500, seed)
    r[::5] = PAD_COORD
    return q, r


def _near_ties(seed):
    """Each query sits between two refs that differ by ~1e-6 in distance:
    below the form's cancellation error at |x| ~ 3."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(2, 3, (200, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32) * 0.05
    r = np.concatenate([q + d, q - d * (1 + 1e-5)]).astype(np.float32)
    return q, r[rng.permutation(len(r))]


CASES = {
    "random_300x900": lambda: _random(300, 900, 0),
    "three_ref_tiles_1000x2500": lambda: _random(1000, 2500, 1),
    "dead_refs": lambda: _dead_refs(2),
    "near_ties": lambda: _near_ties(3),
    "far_from_origin": lambda: tuple(a + np.float32(40.0) for a in _random(300, 900, 4)),
}


def _port(q, r, device="cpu"):
    idx, sq = nn_matmul.nn_matmul(torch.from_numpy(q).to(device), torch.from_numpy(r).to(device))
    return idx.cpu().numpy(), sq.cpu().numpy()


def _oracle(q, r):
    """numpy f32 in the port's operation order; first minimum wins."""
    q2 = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    r2 = (r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]) + r[:, 2] * r[:, 2]
    cross = (q[:, 0:1] * r[None, :, 0] + q[:, 1:2] * r[None, :, 1]) + q[:, 2:3] * r[None, :, 2]
    d2 = (q2[:, None] + r2[None, :]) - np.float32(2.0) * cross
    return d2.argmin(1).astype(np.int32), d2.min(1)


def _true_d2(q, r):
    return ((q[:, None, :].astype(np.float64) - r[None, :, :].astype(np.float64)) ** 2).sum(-1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_interpret(case):
    import jax.numpy as jnp

    from mapping_private_tpu.ops.pallas_nn import nn_pallas

    q, r = CASES[case]()
    idx_j, sq_j = (np.asarray(a) for a in nn_pallas(jnp.asarray(q), jnp.asarray(r), interpret=True))
    idx_t, sq_t = _port(q, r)
    assert idx_t.dtype == np.int32 and sq_t.dtype == np.float32
    d2 = _true_d2(q, r)
    rows = np.arange(len(q))
    scale = (q.astype(np.float64) ** 2).sum(1) + (r[idx_t].astype(np.float64) ** 2).sum(1)
    tol = 8 * EPS * scale
    assert np.all(np.abs(sq_t - sq_j) <= tol)
    assert np.all(np.abs(sq_t - d2[rows, idx_t]) <= tol)
    # the chosen ref is (within the form's error) a nearest one
    assert np.all(d2[rows, idx_t] - d2.min(1) <= 2 * tol)
    part = np.partition(d2, 1, axis=1)
    clear = (part[:, 1] - part[:, 0]) > 2 * tol
    if case not in ("near_ties", "far_from_origin"):  # those two are mostly unclear rows
        assert clear.sum() > 0.9 * len(q)
    np.testing.assert_array_equal(idx_t[clear], idx_j[clear])
    np.testing.assert_array_equal(idx_t[clear], d2.argmin(1)[clear])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_ordered_numpy_oracle(case):
    """Same f32 operations in the same order: bit-exact, lowest index."""
    q, r = CASES[case]()
    idx_o, sq_o = _oracle(q, r)
    idx_t, sq_t = _port(q, r)
    np.testing.assert_array_equal(idx_t, idx_o)
    np.testing.assert_array_equal(sq_t, sq_o)


def test_exact_ties_go_to_lowest_index():
    q, r = _random(200, 300, 5)
    rng = np.random.default_rng(6)
    r = np.concatenate([r, r, r])[rng.permutation(900)]
    idx, _ = _port(q, r)
    first = {tuple(p): i for i, p in reversed(list(enumerate(r)))}
    np.testing.assert_array_equal(idx, [first[tuple(r[i])] for i in idx])


def test_dead_refs_never_win_and_stay_finite():
    q, r = _dead_refs(7)
    q[::9] = -PAD_COORD  # dead queries too: 1e16-sized terms, still finite
    idx, sq = _port(q, r)
    assert np.isfinite(sq).all()
    assert (idx % 5 != 0).all()  # every 5th ref is dead
    live_q = np.ones(len(q), bool)
    live_q[::9] = False
    assert (sq[live_q] < 1.0).all() and (sq[~live_q] > 1e16).all()


def test_plain_blocks_over_query_rows(monkeypatch):
    q, r = _random(301, 700, 8)
    want = _port(q, r)
    monkeypatch.setattr(nn_matmul, "_CHUNK_ELEMS", 700 * 64)
    got = _port(q, r)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("bad", ["query_cols", "ref_cols", "no_refs", "dtype"])
def test_wrapper_rejects_bad_inputs(bad):
    q, r = torch.zeros(4, 3), torch.zeros(5, 3)
    if bad == "query_cols":
        with pytest.raises(ValueError):
            nn_matmul.nn_matmul(q[:, :2], r)
    elif bad == "ref_cols":
        with pytest.raises(ValueError):
            nn_matmul.nn_matmul(q, r.T.contiguous())
    elif bad == "no_refs":
        with pytest.raises(ValueError):
            nn_matmul.nn_matmul(q, r[:0])
    else:
        with pytest.raises(TypeError):
            nn_matmul.nn_matmul(q.double(), r)


def test_cpu_never_counts_a_launch_and_empty_queries():
    before = metrics.counters["nn_matmul.launches"]
    idx, sq = _port(*_random(0, 20, 9))
    assert idx.shape == (0,) and sq.shape == (0,)
    _port(*_random(10, 20, 9))
    assert metrics.counters["nn_matmul.launches"] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel is CUDA C++ for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + ["ragged_20011x19997", "one_query"])
def test_kernel_matches_plain_on_card(case, cuda_device):
    if case == "ragged_20011x19997":
        q, r = _random(20011, 19997, 10)
    elif case == "one_query":
        q, r = _random(1, 5, 11)
    else:
        q, r = CASES[case]()
    before = metrics.counters["nn_matmul.launches"]
    idx_k, sq_k = _port(q, r, cuda_device)
    torch.cuda.synchronize()
    assert metrics.counters["nn_matmul.launches"] == before + 1
    idx_p, sq_p = (t.cpu().numpy() for t in nn_matmul.nn_matmul_plain(
        torch.from_numpy(q).to(cuda_device), torch.from_numpy(r).to(cuda_device)))
    # the same f32 operations in the same order, no FMA contraction
    np.testing.assert_array_equal(idx_k, idx_p)
    np.testing.assert_array_equal(sq_k, sq_p)


# -- cases where a boundary between two stretches of refs matters -----------

def _ties_across_boundary(splits, nr=5000, nq=400, seed=12):
    """Each of the first 100 queries has its nearest ref twice: the last
    refs of stretch 0 repeated on the first refs of stretch 1, and refs of
    the first stretch repeated in the last.  The lower index must win."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-1, 1, (nr, 3)).astype(np.float32)
    b = nn_search.stretch_len(nr, splits)
    last = (nn_search.stretch_count(nr, splits) - 1) * b
    assert last > b
    r[b : b + 50] = r[b - 50 : b]
    r[last : last + 50] = r[10:60]
    q = rng.uniform(-1, 1, (nq, 3)).astype(np.float32)
    q[:50], q[50:100] = r[b - 50 : b], r[10:60]
    return q, r, np.concatenate([np.arange(b - 50, b), np.arange(10, 60)])


def _boundary_cases():
    """name -> (queries, refs, splits, indices known for the first queries)."""
    none = np.empty(0, np.int64)
    cases = {}
    for splits in (3, 7):
        q, r, want = _ties_across_boundary(splits)
        cases[f"ties_across_boundary_{splits}_stretches"] = (q, r, splits, want)
    cases["fewer_refs_than_stretches"] = (*_random(70, 5, 13), 16, none)
    cases["ragged_refs_5_stretches"] = (*_random(513, 4099, 14), 5, none)
    cases["tile_tail_2_stretches"] = (*_random(130, 2 * nn_search.REF_TILE + 3, 15), 2, none)
    cases["one_query_4_stretches"] = (*_random(1, 9000, 16), 4, none)
    q, r = _dead_refs(17)
    q[::3] = -PAD_COORD  # dead queries: 1e16-sized terms, ties everywhere
    cases["dead_queries_and_refs_3_stretches"] = (q, r, 3, none)
    q, r = _random(300, 3000, 18)
    q, r = q + np.float32(40.0), r + np.float32(40.0)
    # a ref 1e-3 from each query: d2 cancels to about 0 in steps of ~1e-3
    # (an ulp of q2 + r2 ~ 1e4), of either sign, with many exact ties
    r[1400:1700] = q + np.random.default_rng(19).normal(0, 1e-3, q.shape).astype(np.float32)
    cases["cancelling_d2_far_from_origin_4_stretches"] = (q, r, 4, none)
    return cases


BOUNDARY_CASES = sorted(_boundary_cases())


@pytest.mark.parametrize("case", BOUNDARY_CASES)
def test_boundary_cases_on_cpu_oracle(case):
    """The cases themselves: the plain version equals the numpy oracle in
    the port's operation order and the indices worked out by hand."""
    q, r, _, want = _boundary_cases()[case]
    idx_t, sq_t = _port(q, r)
    idx_o, sq_o = _oracle(q, r)
    np.testing.assert_array_equal(idx_t, idx_o)
    np.testing.assert_array_equal(sq_t, sq_o)
    np.testing.assert_array_equal(idx_t[: len(want)], want)
    if case.startswith("cancelling"):
        assert (sq_t < 0).any()  # the case does reach below zero


@pytest.mark.cuda
@pytest.mark.parametrize("case", BOUNDARY_CASES)
def test_kernel_split_boundaries_on_card(case, cuda_device):
    q, r, splits, want = _boundary_cases()[case]
    qd, rd = torch.from_numpy(q).to(cuda_device), torch.from_numpy(r).to(cuda_device)
    idx_p, sq_p = (t.cpu().numpy() for t in nn_matmul.nn_matmul_plain(qd, rd))
    for s in (splits, 1, None):  # as asked, one stretch, the wrapper's own choice
        idx_k, sq_k = (t.cpu().numpy() for t in nn_search.search_index("nn_matmul", qd, rd, rd.shape[0], s))
        np.testing.assert_array_equal(idx_k, idx_p)
        np.testing.assert_array_equal(sq_k.view(np.int32), sq_p.view(np.int32))
        np.testing.assert_array_equal(idx_k[: len(want)], want)
    for counters in nn_search._counters.values():
        assert int(counters.count_nonzero()) == 0
