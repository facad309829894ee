"""Port parity: features/colorchlac.py against the JAX package and a
float64 numpy oracle.

Both packages are held against the oracle (the contractions sum over
the grid in different orders, so within rtol 2e-5 of the largest bin
of each block) and against each other; the permutation and layout
tables, the neighbour offsets, the histograms and the learned integer
thresholds must be exactly equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import jit_call, one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.core import PointCloud as JCloud
from mapping_private_tpu.core.voxelgrid import voxelize as jvoxelize
from mapping_private_tpu.features import colorchlac as jcc
from mapping_private_tpu_torch.core import PointCloud
from mapping_private_tpu_torch.core.voxelgrid import voxelize as tvoxelize
from mapping_private_tpu_torch.features import colorchlac as tcc


def _grids(seed, dims=(7, 6, 5), n=400, spread=None):
    """The same seeded coloured cloud voxelized by both packages (several
    points a voxel, integer colours)."""
    rng = np.random.default_rng(seed)
    hi = np.asarray(dims) * 0.01
    xyz = (rng.uniform(0, 1, (n, 3)) * hi).astype(np.float32)
    base = rng.integers(0, 256, (n, 3)) if spread is None else np.clip(rng.normal(spread, 25, (n, 3)), 0, 255)
    ch = {c: np.round(base[:, i]).astype(np.float32) for i, c in enumerate("rgb")}
    jg = jvoxelize(JCloud.from_numpy(xyz, channels=ch), 0.01, jnp.zeros(3), dims, channels=("r", "g", "b"))
    tg = tvoxelize(PointCloud.from_numpy(xyz, ch, device="cpu"), 0.01, torch.zeros(3), dims,
                   channels=("r", "g", "b"))
    return jg, tg


def _shift_np(x, d):
    out = np.zeros_like(x)
    dst, src = [], []
    for axis, s in enumerate(d):
        n = x.shape[axis]
        dst.append(slice(max(0, -s), n - max(0, s)))
        src.append(slice(max(0, s), n - max(0, -s)))
    out[tuple(dst)] = x[tuple(src)]
    return out


def _oracle(tg, thr=(127, 127, 127), bs=None, variant=117):
    """float64 contractions from the f32 voxel means (so the binarization
    sees the same values); per block when ``bs`` is given."""
    count = tg.count.numpy()
    occ = (count > 0).astype(np.float64)
    m = [tg.mean(c).numpy().astype(np.float32).astype(np.float64) for c in "rgb"]
    u = np.stack([m[0], 255 - m[0], m[1], 255 - m[1], m[2], 255 - m[2]], -1) * occ[..., None]
    bits = [(m[i] > thr[i]).astype(np.float64) for i in range(3)]
    w = np.stack([bits[0], 1 - bits[0], bits[1], 1 - bits[1], bits[2], 1 - bits[2]], -1) * occ[..., None]
    whole = bs is None
    if whole:
        bs = max(count.shape)
    X, Y, Z = (-(-s // bs) * bs for s in count.shape)

    def pad(a):
        out = np.zeros((X, Y, Z) + a.shape[3:])
        out[: a.shape[0], : a.shape[1], : a.shape[2]] = a
        return out.reshape((X // bs, bs, Y // bs, bs, Z // bs, bs) + a.shape[3:])

    def bsum(a):
        return pad(a).sum((1, 3, 5))

    def bpair(a, b):
        return np.einsum("xaybzcC,xaybzcD->xyzCD", pad(a), pad(b))

    ui, uj = zip(*tcc._UPPER_TRI)
    bi, bj = zip(*tcc._BIN_CENTER_PAIRS)
    B = bsum(occ).shape
    mu, mw = bpair(u, u), bpair(w, w)
    if variant == 117:
        su = sum(_shift_np(u, d) for d in tcc.NEIGHBOR_OFFSETS_13)
        sw = sum(_shift_np(w, d) for d in tcc.NEIGHBOR_OFFSETS_13)
        parts = [bsum(u) / 255, bpair(u, su).reshape(B + (36,)) / 845325, mu[..., ui, uj] / 65025,
                 bsum(w), bpair(w, sw).reshape(B + (36,)) / 13, mw[..., bi, bj]]
    else:
        parts = [bsum(u) / 255]
        parts += [bpair(u, _shift_np(u, d)).reshape(B + (36,)) / 65025 for d in tcc.NEIGHBOR_OFFSETS_13]
        parts += [mu[..., ui, uj] / 65025, bsum(w)]
        parts += [bpair(w, _shift_np(w, d)).reshape(B + (36,)) for d in tcc.NEIGHBOR_OFFSETS_13]
        parts += [mw[..., bi, bj]]
    out = np.concatenate(parts, -1)
    return out[0, 0, 0] if whole else out


def _blocks_of(variant):
    """Bin ranges of the feature's parts, each held to its largest value."""
    return ([0, 6, 42, 63, 69, 105, 117] if variant == 117 else
            [0, 6] + [6 + 36 * k for k in range(1, 14)] + [495, 501] + [501 + 36 * k for k in range(1, 14)] + [981])


def _close(got, want, variant, rtol=2e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    edges = _blocks_of(variant)
    for a, b in zip(edges[:-1], edges[1:]):
        scale = max(np.abs(want[..., a:b]).max(), 1e-30)
        np.testing.assert_allclose(got[..., a:b], want[..., a:b], rtol=0, atol=rtol * scale, err_msg=f"bins {a}:{b}")


def test_constants_and_tables_equal():
    assert tcc.NEIGHBOR_OFFSETS_13 == jcc.NEIGHBOR_OFFSETS_13
    assert (tcc._N0, tcc._N1, tcc._N1_RI, tcc._N1_BIN_RI) == (jcc._N0, jcc._N1, jcc._N1_RI, jcc._N1_BIN_RI)
    assert tcc._UPPER_TRI == jcc._UPPER_TRI and tcc._BIN_CENTER_PAIRS == jcc._BIN_CENTER_PAIRS
    for mode in "xyz":
        np.testing.assert_array_equal(tcc._rotation_matrix(mode), jcc._rotation_matrix(mode))
        np.testing.assert_array_equal(tcc._rotation_permutation_981(mode), jcc._rotation_permutation_981(mode))
    np.testing.assert_array_equal(tcc._perm_own_to_reference_981(), jcc._perm_own_to_reference_981())


@pytest.mark.parametrize("thr", [(127, 127, 127), (60, 200, 90)])
def test_colorchlac117_and_981_match(thr):
    jg, tg = _grids(0)
    for a, b in zip(tcc.color_channels(tg, thr), jcc.color_channels(jg, thr)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))  # integer colours: exact
    got = tcc.colorchlac117(tg, thr).numpy()
    assert got.shape == (117,) and got.dtype == np.float32
    _close(got, _oracle(tg, thr), 117)
    _close(np.asarray(jit_call(jcc.colorchlac117, jg, thresholds=thr)), _oracle(tg, thr), 117)
    got = tcc.colorchlac981(tg, thr).numpy()
    assert got.shape == (981,)
    _close(got, _oracle(tg, thr, variant=981), 981)
    _close(got, np.asarray(jit_call(jcc.colorchlac981, jg, thresholds=thr)), 981)


@pytest.mark.parametrize("bs", [2, 3])
def test_subdiv_match(bs):
    jg, tg = _grids(1, dims=(8, 7, 5))
    got = tcc.colorchlac117_subdiv(tg, bs).numpy()
    want = np.asarray(jit_call(jcc.colorchlac117_subdiv, jg, block_size=bs))
    assert got.shape == want.shape == tuple(-(-d // bs) for d in (8, 7, 5)) + (117,)
    _close(got, _oracle(tg, bs=bs), 117)
    _close(got, want, 117)
    # the blocks add up to the whole grid's feature
    _close(got.sum((0, 1, 2)), tcc.colorchlac117(tg).numpy(), 117, rtol=1e-4)
    got = tcc.colorchlac981_subdiv(tg, bs).numpy()
    _close(got, _oracle(tg, bs=bs, variant=981), 981)
    _close(got, np.asarray(jit_call(jcc.colorchlac981_subdiv, jg, block_size=bs)), 981)
    occ = tcc.occupied_count_subdiv(tg, bs)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jcc.occupied_count_subdiv(jg, bs)))


def test_shift_and_neighbor_sum_match():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 4, 3, 2)).astype(np.float32)
    for d in [(1, 0, -1), (-1, -1, 0), (0, 2, 0), (5, 0, 0), (0, 0, -3)]:  # up to a whole axis
        np.testing.assert_array_equal(tcc._shift(torch.tensor(x), d).numpy(), np.asarray(jcc._shift(jnp.asarray(x), d)))
    np.testing.assert_allclose(tcc.neighbor_sum(torch.tensor(x)).numpy(),
                               np.asarray(jcc.neighbor_sum(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_rotation_and_layout_maps_match():
    rng = np.random.default_rng(3)
    f = rng.normal(size=(2, 981)).astype(np.float32)
    for mode in "xyz":
        want = np.stack([np.asarray(jcc.rotate_feature_981(jnp.asarray(r), mode)) for r in f])
        np.testing.assert_array_equal(tcc.rotate_feature_981(torch.tensor(f), mode).numpy(), want)
    ref = tcc.to_reference_layout_981(torch.tensor(f))
    np.testing.assert_array_equal(ref.numpy(), np.asarray(jcc.to_reference_layout_981(jnp.asarray(f))))
    np.testing.assert_array_equal(tcc.from_reference_layout_981(ref).numpy(), f)


def test_rotated_grid_gives_the_permuted_feature():
    """Rotating a grid's contents 90° about z moves its 981 feature by the
    z permutation, exactly as far as the sums' order allows."""
    jg, tg = _grids(4, dims=(6, 6, 6))
    count, sums = tg.count.numpy(), {c: tg.sums[c].numpy() for c in "rgb"}
    # rotating +90° about z: (x, y) -> (X-1-y, x)
    rot = lambda a: np.rot90(a, k=1, axes=(0, 1)).copy()  # noqa: E731
    from mapping_private_tpu_torch.core import VoxelGrid

    tr = VoxelGrid(origin=tg.origin, voxel_size=tg.voxel_size, count=torch.tensor(rot(count)),
                   sums={c: torch.tensor(rot(v)) for c, v in sums.items()})
    f = tcc.colorchlac981(tg)
    fr = tcc.colorchlac981(tr)
    _close(tcc.rotate_feature_981(f, "z").numpy(), fr.numpy(), 981, rtol=1e-5)


def test_threshold_learning_matches():
    jg, tg = _grids(5, dims=(9, 9, 9), n=900, spread=(180, 60, 120))
    h = tcc.rgb_voxel_histograms(tg)
    assert h.dtype == torch.int32 and h.shape == (3, 256)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jcc.rgb_voxel_histograms(jg)))
    assert int(h.sum()) == 3 * int((tg.count > 0).sum())
    rng = np.random.default_rng(6)
    for _ in range(20):
        hist = rng.integers(0, 50, (3, 256)) * (rng.uniform(size=(3, 256)) < rng.uniform())
        assert tcc.calc_auto_threshold(hist) == jcc.calc_auto_threshold(hist)
    jg2, tg2 = _grids(7, dims=(9, 9, 9), n=900, spread=(40, 220, 100))
    got = tcc.calc_scene_auto_threshold([tg, tg2])
    assert got == jcc.calc_scene_auto_threshold([jg, jg2])
    assert all(isinstance(v, int) for v in got)
    with pytest.raises(ValueError):
        tcc.calc_scene_auto_threshold([])
