"""ops/knn_kbest.py: the k smallest squared distances of the statistical
outlier filter.

The plain version is held against a float64 numpy brute k-NN (within
float32 rounding) and against the same direct-difference formula in
float32 numpy (exactly), on random clouds, duplicates, fewer than k + 1
points and k at each edge of the kernel's buckets.  The filter takes the
kernel for k <= K_MAX and keeps the dense search above it and on the grid
path.  The CUDA kernel is held against the plain version bit for bit on
the card (marked ``cuda``; skipped without a GPU): a tabletop frame's
~97,200 live of 307,200 rows and ragged sizes.  No JAX here, so ``-m cuda
--noconftest`` runs the card tests on a machine without it."""
import re

import numpy as np
import pytest
import torch

from mapping_private_tpu_torch import _build
from mapping_private_tpu_torch.ops import filters, knn_kbest
from mapping_private_tpu_torch.ops.nn_argmin import prepare_nn_ref_argmin
from mapping_private_tpu_torch.utils.metrics import metrics

# every edge of the buckets (multiples of K_STEP), both sides
BUCKET_EDGES = sorted({1, knn_kbest.K_MAX} | {e + d for e in range(knn_kbest.K_STEP, knn_kbest.K_MAX, knn_kbest.K_STEP)
                                               for d in (0, 1)})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)


def _duplicates(seed):
    """Every point twice and one point four times: zero distances."""
    p = _random(150, seed)
    return np.concatenate([p, p, p[:1], p[:1]])


CLOUDS = {
    "random_700": lambda: _random(700, 0),
    "ragged_257": lambda: _random(257, 1),  # one past a block's 256 queries
    "duplicates": lambda: _duplicates(2),
    "clustered": lambda: (_random(400, 3) * np.float32(1e-3) + np.float32(0.5)).astype(np.float32),
}


def _rows(xyz, device="cpu"):
    return prepare_nn_ref_argmin(torch.from_numpy(xyz).to(device))


def _f64_oracle(xyz, k):
    p = xyz.astype(np.float64)
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    out = np.full((len(p), k), np.inf)
    kk = min(k, len(p))
    out[:, :kk] = np.sort(d2, axis=1)[:, :kk]
    return out


def _f32_formula(xyz, k):
    """d2 = (dx*dx + dy*dy) + dz*dz in float32, self by index excluded,
    the k smallest ascending."""
    d = xyz[:, None, :] - xyz[None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    np.fill_diagonal(d2, np.float32(np.inf))
    out = np.full((len(xyz), k), np.inf, np.float32)
    kk = min(k, len(xyz))
    out[:, :kk] = np.sort(d2, axis=1)[:, :kk]
    return out


@pytest.mark.parametrize("k", [1, 20, knn_kbest.K_MAX])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_plain_matches_float64_oracle(cloud, k):
    xyz = CLOUDS[cloud]()
    got = knn_kbest.knn_kbest(_rows(xyz), k).numpy()
    want = _f64_oracle(xyz, k)
    assert got.shape == (len(xyz), k) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12)


@pytest.mark.parametrize("k", BUCKET_EDGES)
def test_plain_is_the_f32_formula_exactly(k):
    xyz = _random(300, 10 + k)
    np.testing.assert_array_equal(knn_kbest.knn_kbest(_rows(xyz), k).numpy(), _f32_formula(xyz, k))


@pytest.mark.parametrize("n, k", [(1, 1), (1, 20), (5, 5), (6, 5), (20, 20), (21, 20), (64, knn_kbest.K_MAX)])
def test_fewer_than_k_plus_one_points_pad_with_inf(n, k):
    xyz = _random(n, n)
    got = knn_kbest.knn_kbest(_rows(xyz), k).numpy()
    have = min(k, n - 1)
    assert np.isfinite(got[:, :have]).all() and np.isposinf(got[:, have:]).all()
    np.testing.assert_array_equal(got, _f32_formula(xyz, k))


def test_self_is_excluded_by_index_not_by_distance():
    xyz = _duplicates(4)
    got = knn_kbest.knn_kbest(_rows(xyz), 3).numpy()
    # each point's twin lies at 0, its own index never counts: the 4-fold point sees three zeros
    assert (got[:, 0] == 0).all()
    assert (got[0] == 0).all() and (got[150] == 0).all() and (got[-1] == 0).all()
    assert (got[1:150, 1] > 0).all()
    unique = _random(150, 4)
    assert (knn_kbest.knn_kbest(_rows(unique), 3).numpy()[:, 0] > 0).all()


def test_plain_blocks_over_query_rows(monkeypatch):
    xyz = _random(500, 7)
    whole = knn_kbest.knn_kbest_plain(_rows(xyz), 12)
    monkeypatch.setattr(knn_kbest, "_CHUNK_ELEMS", 500 * 37)  # 37 rows a block, a ragged last one
    np.testing.assert_array_equal(knn_kbest.knn_kbest_plain(_rows(xyz), 12).numpy(), whole.numpy())


def test_empty_set():
    got = knn_kbest.knn_kbest(torch.zeros((3, 0)), 5)
    assert got.shape == (0, 5)


def test_live_rows_compacts_in_order():
    xyz = torch.from_numpy(_random(40, 8))
    mask = torch.arange(40) % 3 != 1
    rows, rt = knn_kbest.live_rows(xyz, mask)
    np.testing.assert_array_equal(rows.numpy(), np.flatnonzero(mask.numpy()))
    assert rt.shape == (3, int(mask.sum())) and rt.is_contiguous()
    np.testing.assert_array_equal(rt.T.numpy(), xyz[mask].numpy())


def test_wrapper_rejects_bad_inputs():
    rt = torch.zeros((3, 10))
    with pytest.raises(ValueError):
        knn_kbest.knn_kbest(rt.T.contiguous(), 3)
    with pytest.raises(TypeError):
        knn_kbest.knn_kbest(rt.double(), 3)
    for k in (0, knn_kbest.K_MAX + 1):
        with pytest.raises(ValueError):
            knn_kbest.knn_kbest(rt, k)


@pytest.mark.parametrize("constant, mirror", [("kStep", "K_STEP"), ("kMax", "K_MAX")])
def test_kernel_constants_match_their_mirrors(constant, mirror):
    text = _build.source_path("knn_kbest").read_text()
    assert int(re.search(rf"constexpr int {constant} = (\d+);", text).group(1)) == getattr(knn_kbest, mirror)


def test_cpu_never_counts_a_launch():
    before = metrics.counters["knn_kbest.launches"]
    knn_kbest.knn_kbest(_rows(_random(50, 9)), 4)
    assert metrics.counters["knn_kbest.launches"] == before


def _masked_cloud(n=600, seed=11):
    rng = np.random.default_rng(seed)
    xyz = torch.from_numpy(np.concatenate([_random(n, seed), rng.uniform(-3, 3, (20, 3)).astype(np.float32)]))
    return xyz, torch.from_numpy(rng.uniform(size=len(xyz)) < 0.7)


@pytest.mark.parametrize("k, path", [(1, "kbest"), (20, "kbest"), (knn_kbest.K_MAX, "kbest"),
                                     (knn_kbest.K_MAX + 1, "dense"), (20, "grid")])
def test_the_filter_takes_the_kbest_search_for_k_up_to_k_max(monkeypatch, k, path):
    xyz, mask = _masked_cloud()
    calls = []
    for mod, name in ((filters, "knn_kbest"), (filters, "knn_bruteforce"), (filters, "knn_grid")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **kw: calls.append(_n) or _o(*a, **kw))
    keep = filters.statistical_outlier_mask(xyz, mask, k=k, use_grid=path == "grid", cell_size=0.5)
    assert calls == [{"kbest": "knn_kbest", "dense": "knn_bruteforce", "grid": "knn_grid"}[path]]
    assert not (keep & ~mask).any() and 0.5 * int(mask.sum()) < int(keep.sum()) < int(mask.sum())


@pytest.mark.parametrize("k", [5, 20])
def test_the_kbest_filter_keeps_what_the_dense_search_keeps(monkeypatch, k):
    """The same mean distances from the live rows alone as from the dense
    search over every row (which reaches live refs only), up to the
    matmul form's rounding: on this cloud no row lies near the cut."""
    xyz, mask = _masked_cloud(seed=12)
    got = filters.statistical_outlier_mask(xyz, mask, k=k, alpha=1.0)
    monkeypatch.setattr(filters, "K_MAX", 0)
    want = filters.statistical_outlier_mask(xyz, mask, k=k, alpha=1.0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel is CUDA C++ for sm_90a)")
    return torch.device("cuda")


def _tabletop_live_rows():
    """chip_smoke's tabletop frame (307,200 points) through the tabletop
    pipeline's box: ~97,200 live rows, in frame order."""
    import chip_smoke

    xyz, _ = chip_smoke.tabletop_frame(0)
    lo, hi = np.asarray(chip_smoke.TABLE_BOX[:3]), np.asarray(chip_smoke.TABLE_BOX[3:])
    return xyz[((xyz >= lo) & (xyz <= hi)).all(1)]


CARD_CASES = {
    "tabletop_frame": (_tabletop_live_rows, [20]),
    "ragged_1001": (lambda: _random(1001, 20), [1, 20, knn_kbest.K_MAX]),
    "ragged_5003": (lambda: _random(5003, 21), BUCKET_EDGES),
    "duplicates": (lambda: _duplicates(22), [1, 20, knn_kbest.K_MAX]),
    "n_below_k": (lambda: _random(17, 23), [1, 20, knn_kbest.K_MAX]),
    "one_point": (lambda: _random(1, 24), [1, 20]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_on_card(case, cuda_device):
    make, ks = CARD_CASES[case]
    xyz = make()
    if case == "tabletop_frame":
        assert 90_000 < len(xyz) < 105_000
    rt = _rows(xyz, cuda_device)
    for k in ks:
        before = metrics.counters["knn_kbest.launches"]
        got = knn_kbest.knn_kbest(rt, k)
        torch.cuda.synchronize()
        assert metrics.counters["knn_kbest.launches"] == before + 1
        want = knn_kbest.knn_kbest_plain(rt, k)
        # the same unfused f32 ops and the same k smallest: bit for bit
        np.testing.assert_array_equal(got.view(torch.int32).cpu().numpy(), want.view(torch.int32).cpu().numpy(),
                                      err_msg=f"k = {k}")


@pytest.mark.cuda
def test_launch_refuses_k_past_its_lists(cuda_device):
    rt = _rows(_random(10, 25), cuda_device)
    out = torch.empty((10, knn_kbest.K_MAX + 1), device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    for k in (0, knn_kbest.K_MAX + 1):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.launch("knn_kbest", rt.data_ptr(), 10, k, out.data_ptr(), stream)
