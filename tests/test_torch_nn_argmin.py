"""Port parity: ops/nn_argmin.py (the exact-argmin 1-NN).

The plain PyTorch version is held against the JAX Pallas kernel in
interpret mode (``nn_argmin_prepared(..., interpret=True)``), as
tests/test_pallas_kernels.py runs it.  Indices must be identical and
squared distances within 1e-6: both sides sum the same direct
differences in f32.  The CUDA kernel is held against the plain version
on the card (marked ``cuda``; skipped without a GPU), with the refs split
into stretches so that ties, dead points and ragged sizes fall on and
around a boundary between two blocks.  How many ways to split, and the
workspace that follows, are pure functions tested here on the CPU.  The
JAX package is imported only by the parity tests, so ``-m cuda
--noconftest`` runs the card tests on a machine without jax."""
import re

import numpy as np
import pytest
import torch

from mapping_private_tpu_torch import _build
from mapping_private_tpu_torch.core.cloud import PAD_COORD
from mapping_private_tpu_torch.ops import nn_argmin, nn_search
from mapping_private_tpu_torch.utils.metrics import metrics


def _random(nq, nr, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (nq, 3)).astype(np.float32),
            rng.uniform(-1, 1, (nr, 3)).astype(np.float32))


def _dead(seed):
    """Dead queries (−PAD_COORD) and dead refs (+PAD_COORD)."""
    q, r = _random(300, 900, seed)
    q[::7] = -PAD_COORD
    r[::5] = PAD_COORD
    return q, r


def _duplicates(seed):
    """Every ref appears three times, in shuffled order: exact ties."""
    q, r = _random(300, 300, seed)
    rng = np.random.default_rng(seed + 100)
    r = np.concatenate([r, r, r])[rng.permutation(900)]
    return np.concatenate([q, r[:50]]), r


def _lattice(seed):
    """Refs on an integer lattice, queries at cell centres, face centres
    and edge midpoints: 8-, 4- and 2-way exact ties in any summation order
    (integers and halves are exact in f32)."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1).reshape(-1, 3)
    r = g[rng.permutation(len(g))].astype(np.float32)
    base = g[(g < 5).all(1)][:100].astype(np.float32)
    q = np.concatenate([base + [0.5, 0.5, 0.5], base + [0.5, 0.5, 0.0], base + [0.0, 0.5, 0.0]])
    return q.astype(np.float32), r


CASES = {
    "random_300x900": lambda: _random(300, 900, 0),
    "dead_queries_and_refs": lambda: _dead(1),
    "duplicated_refs": lambda: _duplicates(2),
    "lattice_midpoints": lambda: _lattice(3),
}


def _jax_ref(q, r):
    import jax.numpy as jnp

    from mapping_private_tpu.ops import pallas_nn

    rt = pallas_nn.prepare_nn_ref_argmin(jnp.asarray(r))
    idx, sq = pallas_nn.nn_argmin_prepared(jnp.asarray(q), rt, interpret=True)
    return np.asarray(idx), np.asarray(sq)


def _port(q, r, device="cpu"):
    prep = nn_argmin.prepare_nn_ref_argmin(torch.from_numpy(r).to(device))
    idx, sq = nn_argmin.nn_argmin_prepared(torch.from_numpy(q).to(device), prep)
    return idx.cpu().numpy(), sq.cpu().numpy()


def _lowest_index_oracle(q, r):
    """numpy, same summation order; np.argmin takes the first minimum."""
    d = q[:, None, :] - r[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return d2.argmin(1), d2.min(1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    q, r = CASES[case]()
    idx_j, sq_j = _jax_ref(q, r)
    idx_t, sq_t = _port(q, r)
    assert idx_t.dtype == np.int32 and sq_t.dtype == np.float32
    np.testing.assert_array_equal(idx_t, idx_j)
    live = q[:, 0] > -PAD_COORD
    np.testing.assert_allclose(sq_t[live], sq_j[live], rtol=0, atol=1e-6)
    # dead queries: ~1.2e17 but finite (the ICP distance gate relies on it)
    assert np.isfinite(sq_t).all()
    np.testing.assert_allclose(sq_t[~live], sq_j[~live], rtol=1e-6)


@pytest.mark.parametrize("case", ["duplicated_refs", "lattice_midpoints"])
def test_exact_ties_take_lowest_index(case):
    q, r = CASES[case]()
    idx_o, sq_o = _lowest_index_oracle(q, r)
    idx_t, sq_t = _port(q, r)
    np.testing.assert_array_equal(idx_t, idx_o)
    np.testing.assert_array_equal(sq_t, sq_o)


def test_plain_blocks_over_query_rows(monkeypatch):
    """Several query blocks give the same answer as one."""
    q, r = _random(301, 700, 4)
    want = _port(q, r)
    monkeypatch.setattr(nn_argmin, "_CHUNK_ELEMS", 700 * 64)
    got = _port(q, r)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(4, 3)
    prep = nn_argmin.prepare_nn_ref_argmin(torch.zeros(5, 3))
    with pytest.raises(ValueError):
        nn_argmin.nn_argmin_prepared(q[:, :2], prep)
    with pytest.raises(ValueError):
        nn_argmin.nn_argmin_prepared(q, prep.T.contiguous())
    with pytest.raises(TypeError):
        nn_argmin.nn_argmin_prepared(q.double(), prep)
    with pytest.raises(ValueError):
        nn_argmin.prepare_nn_ref_argmin(torch.zeros(5, 4))


def test_cpu_never_counts_a_launch():
    before = metrics.counters["nn_argmin.launches"]
    _port(*_random(10, 20, 5))
    assert metrics.counters["nn_argmin.launches"] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel is CUDA C++ for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + ["ragged_20011x19997", "one_query"])
def test_kernel_matches_plain_on_card(case, cuda_device):
    if case == "ragged_20011x19997":
        q, r = _random(20011, 19997, 6)
    elif case == "one_query":
        q, r = _random(1, 5, 7)
    else:
        q, r = CASES[case]()
    before = metrics.counters["nn_argmin.launches"]
    idx_k, sq_k = _port(q, r, cuda_device)
    torch.cuda.synchronize()
    assert metrics.counters["nn_argmin.launches"] == before + 1
    qd = torch.from_numpy(q).to(cuda_device)
    prep = nn_argmin.prepare_nn_ref_argmin(torch.from_numpy(r).to(cuda_device))
    idx_p, sq_p = (t.cpu().numpy() for t in nn_argmin.nn_argmin_plain(qd, prep))
    np.testing.assert_array_equal(idx_k, idx_p)
    # no FMA contraction in the kernel: the same f32 ops, bit for bit
    np.testing.assert_array_equal(sq_k, sq_p)


# -- the split of the refs across blocks (ops/nn_search.py) -----------------

SIZES = [(1, 5), (1, 20_000), (1, 2_049), (300, 900), (20_000, 20_000), (20_000, 65_536),
         (20_011, 19_997), (200_000, 200_000), (200_000, 100), (1_000_000, 1_000_000)]


@pytest.mark.parametrize("sm_count", [1, 108, 132, 144])
@pytest.mark.parametrize("nq,nr", SIZES)
def test_split_count_bounds(nq, nr, sm_count):
    s = nn_search.split_count(nq, nr, sm_count)
    ref_tiles = -(-nr // nn_search.REF_TILE)
    q_tiles = -(-nq // nn_search.QUERY_TILE)
    assert 1 <= s <= ref_tiles
    # all blocks resident at once, unless the query tiles alone are more
    assert s == 1 or s * q_tiles <= nn_search.BLOCKS_PER_SM * sm_count
    n = nn_search.stretch_count(nr, s)
    length = nn_search.stretch_len(nr, s)
    assert 1 <= n <= s
    assert length % nn_search.STRETCH_ALIGN == 0
    assert (n - 1) * length < nr <= n * length  # no stretch is empty, none is left out
    # no allowed split fills the card's last round of blocks more than 1% better,
    # and no smaller one fills it as well
    allowed = [k for k in range(1, ref_tiles + 1) if k == 1 or k * q_tiles <= nn_search.BLOCKS_PER_SM * sm_count]
    fills = {k: nn_search.fill(k * q_tiles, sm_count) for k in allowed}
    assert fills[s] >= max(fills.values()) * (1 - nn_search.FILL_SLACK)
    assert all(fills[k] < max(fills.values()) * (1 - nn_search.FILL_SLACK) for k in allowed if k < s)


@pytest.mark.parametrize("blocks,sm_count,want", [(132, 132, 1.0), (133, 132, 133 / 264), (395, 132, 395 / 396),
                                                  (1, 132, 1 / 132), (782, 132, 782 / 792)])
def test_fill_of_the_last_round(blocks, sm_count, want):
    assert nn_search.fill(blocks, sm_count) == pytest.approx(want)


@pytest.mark.parametrize("nq,nr,want", [
    (200_000, 200_000, 1),  # 782 query tiles: 5.92 a SM, the queries alone fill the card
    (20_000, 20_000, 5),  # 79 query tiles x 5 = 395 blocks on 132 SMs: 2.99 a SM
    (20_000, 65_536, 5),
    (1, 20_000, 10),  # one query tile: as many stretches as ref tiles
    (1, 5, 1),
    (3_000, 65_536, 11),  # 12 query tiles x 11 = 132 blocks
])
def test_split_count_on_132_sms(nq, nr, want):
    assert nn_search.split_count(nq, nr, 132) == want


@pytest.mark.parametrize("nq,nr,splits,want", [
    (20_000, 20_000, 1, (0, 0)),  # one stretch: the block writes the outputs itself
    (20_000, 20_000, 5, (5, 79)),
    (20_011, 19_997, 7, (7, 79)),
    (1, 5, 1000, (0, 0)),  # fewer refs than stretches asked for: one stretch of 32
    (1, 100, 3, (2, 1)),  # a third of 100 rounds up to 64: stretches of 64 and 36
    (1, 100, 4, (4, 1)),  # 32, 32, 32, 4
    (257, 4_096, 128, (128, 2)),
])
def test_workspace_sizes(nq, nr, splits, want):
    assert nn_search.workspace_sizes(nq, nr, splits) == want


@pytest.mark.parametrize("constant,mirror", [("kBlock", "BLOCK_THREADS"), ("kQueries", "QUERIES_PER_THREAD"),
                                             ("kTile", "REF_TILE")])
def test_header_constants_match_their_mirrors(constant, mirror):
    header = (_build.CSRC_DIR / "nn_search.cuh").read_text()
    (value,) = re.findall(rf"constexpr int {constant} = (\d+);", header)
    assert int(value) == getattr(nn_search, mirror)
    assert nn_search.QUERY_TILE == nn_search.BLOCK_THREADS * nn_search.QUERIES_PER_THREAD


def test_stretch_geometry_lives_in_python_only():
    """The launch is told the stretch, the workspace rows and the counters
    and checks its grid against them; the header derives none of it."""
    header = (_build.CSRC_DIR / "nn_search.cuh").read_text()
    assert "int stretch, int rows" in header and "int n_counters" in header
    assert not re.search(r"\bsplits\b|kStretchAlign|stretch_len", header)


@pytest.mark.parametrize("bad", [(0, 5, 132), (5, 0, 132), (5, 5, 0)])
def test_split_count_rejects_empty(bad):
    with pytest.raises(ValueError):
        nn_search.split_count(*bad)


# -- cases where a boundary between two stretches matters (card) -------------

def _ties_across_boundary(splits, nr=5000, nq=400, seed=8):
    """Every query's nearest ref appears twice: on the last refs of one
    stretch and on the first refs of the next, or both copies inside one
    stretch, or copies in the first and the last stretch.  The copy with
    the lower index must win each time."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-1, 1, (nr, 3)).astype(np.float32)
    length = nn_search.stretch_len(nr, splits)
    n = nn_search.stretch_count(nr, splits)
    assert n >= 3
    b = length  # first ref of stretch 1
    r[b : b + 50] = r[b - 50 : b]  # copies on both sides of the boundary
    r[b + 60 : b + 110] = r[b + 120 : b + 170]  # both copies inside stretch 1
    last = (n - 1) * length
    r[last : last + 50] = r[10:60]  # copies in the first and the last stretch
    q = rng.uniform(-1, 1, (nq, 3)).astype(np.float32)
    q[:50], q[50:100], q[100:150] = r[b - 50 : b], r[b + 60 : b + 110], r[10:60]
    want = np.concatenate([np.arange(b - 50, b), np.arange(b + 60, b + 110), np.arange(10, 60)])
    return q, r, want


def _boundary_cases():
    """name -> (queries, refs, splits, indices known for the first queries)."""
    none = np.empty(0, np.int64)
    cases = {}
    for splits in (3, 7):
        q, r, want = _ties_across_boundary(splits)
        cases[f"ties_across_boundary_{splits}_stretches"] = (q, r, splits, want)
    q, r = _random(70, 5, 20)
    cases["fewer_refs_than_stretches"] = (q, r, 16, none)
    q, r = _random(513, 4099, 21)  # no multiple of 4, 8, 32 or the tile; 3 query tiles
    cases["ragged_refs_5_stretches"] = (q, r, 5, none)
    q, r = _random(130, 2 * nn_search.REF_TILE + 3, 22)  # a second tile of 3 refs, then a stretch
    cases["tile_tail_2_stretches"] = (q, r, 2, none)
    q, r = _random(1, 9000, 23)
    cases["one_query_4_stretches"] = (q, r, 4, none)
    q, r = _dead(24)
    q[:] = -PAD_COORD  # every ref ~1e8 away: d2 steps by ~2e9 there, ties everywhere
    cases["all_queries_dead_3_stretches"] = (q, r, 3, none)
    q, r = _lattice(25)
    cases["lattice_midpoints_6_stretches"] = (q, r, 6, none)
    return cases


BOUNDARY_CASES = sorted(_boundary_cases())


@pytest.mark.parametrize("case", BOUNDARY_CASES)
def test_boundary_cases_on_cpu_oracle(case):
    """The cases themselves: the plain version gives the lowest index (the
    numpy oracle's) and the indices worked out by hand."""
    q, r, _, want = _boundary_cases()[case]
    idx_t, sq_t = _port(q, r)
    idx_o, sq_o = _lowest_index_oracle(q, r)
    np.testing.assert_array_equal(idx_t, idx_o)
    np.testing.assert_array_equal(sq_t, sq_o)
    np.testing.assert_array_equal(idx_t[: len(want)], want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BOUNDARY_CASES)
def test_kernel_split_boundaries_on_card(case, cuda_device):
    q, r, splits, want = _boundary_cases()[case]
    qd = torch.from_numpy(q).to(cuda_device)
    prep = nn_argmin.prepare_nn_ref_argmin(torch.from_numpy(r).to(cuda_device))
    idx_p, sq_p = (t.cpu().numpy() for t in nn_argmin.nn_argmin_plain(qd, prep))
    for s in (splits, 1, None):  # as asked, one stretch, the wrapper's own choice
        idx_k, sq_k = (t.cpu().numpy() for t in nn_search.search_index("nn_argmin", qd, prep, prep.shape[1], s))
        np.testing.assert_array_equal(idx_k, idx_p)
        np.testing.assert_array_equal(sq_k.view(np.int32), sq_p.view(np.int32))
        np.testing.assert_array_equal(idx_k[: len(want)], want)
    # the merging block leaves the ticket counters zeroed for the next launch
    for counters in nn_search._counters.values():
        assert int(counters.count_nonzero()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_counters", [(2, 4), (3, 1)])
def test_launch_refuses_a_grid_beyond_its_workspace(rows, n_counters, cuda_device):
    """3 stretches x 2 query tiles need 3 workspace rows and 2 counters: with
    fewer of either nothing is launched and the outputs stay untouched."""
    nq, nr = nn_search.QUERY_TILE + 1, 96
    q = torch.zeros((nq, 3), device=cuda_device)
    rt = torch.zeros((3, nr), device=cuda_device)
    part_d = torch.empty((3, nq), device=cuda_device)
    part_i = torch.empty((3, nq), dtype=torch.int32, device=cuda_device)
    counters = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    idx = torch.full((nq,), -7, dtype=torch.int32, device=cuda_device)
    sq = torch.full((nq,), -7.0, device=cuda_device)
    args = [q.data_ptr(), nq, rt.data_ptr(), nr, 32, rows, part_d.data_ptr(), part_i.data_ptr(), n_counters,
            counters.data_ptr(), idx.data_ptr(), sq.data_ptr(), torch.cuda.current_stream().cuda_stream]
    with pytest.raises(RuntimeError, match="invalid"):
        _build.launch("nn_argmin", *args)
    torch.cuda.synchronize()
    assert bool((idx == -7).all()) and bool((sq == -7.0).all()) and int(counters.count_nonzero()) == 0
    args[5], args[8] = 3, 2  # enough of both: the launch goes through
    _build.launch("nn_argmin", *args)
    torch.cuda.synchronize()
    assert bool((idx == 0).all()) and bool((sq == 0.0).all()) and int(counters.count_nonzero()) == 0
