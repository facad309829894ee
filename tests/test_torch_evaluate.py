"""Port parity: classify/evaluate.py against the JAX package.

The protocols run on the first 16 objects of the committed corpus
features (``tests/data_corpus_features_gr.npz``, 24 views each).

- g (leave-one-out, 10-dim subspaces of the 20-dim GRSD): the port's
  prediction is the JAX one wherever its top two similarities are more
  than 1e-5 apart, so each object's count of correct views equals the
  JAX count up to that object's ambiguous views.
- r (-sub 50 over 23 training views: every fold basis is padded past the
  data's rank with null-space directions no solver fixes, and the port
  solves in f64 where the JAX package solves in f32): the count of
  correct views within one view per object of the JAX count.
- The SVM cross-validation: each object's rate within one view.
- The split protocol's similarities against JAX and a float64 oracle
  (see its test), the rotation orbit and augmentation exactly, one
  view's four descriptors against the JAX extraction (g within the
  transitions of the few voxels whose type flips, the ColorCHLAC parts
  within 2e-5 of each block's largest bin), and the npz feature cache
  read by both."""
import os

import numpy as np
import pytest
from jax_ref import jit_call, one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.classify import evaluate as jev
from mapping_private_tpu_torch.classify import evaluate as tev

DATA = os.path.join(os.path.dirname(__file__), "data_corpus_features_gr.npz")
N_OBJ = 16


@pytest.fixture(scope="module")
def subset():
    z = np.load(DATA, allow_pickle=True)
    keep = z["labels"] < N_OBJ
    return z["features_g"][keep], z["features_r"][keep], z["labels"][keep], list(z["names"])[:N_OBJ]


def _counts(res, names):
    return np.array([round(res.per_object[n] * 24) for n in names])


def test_leave_one_out_g_matches(subset):
    Fg, _, L, names = subset
    sims = tev.leave_one_out_similarities(Fg, L, "g", device="cpu").numpy()
    top2 = np.sort(sims, axis=1)[:, -2:]
    ambiguous = np.bincount(L[top2[:, 1] - top2[:, 0] <= 1e-5], minlength=N_OBJ)
    t = tev.leave_one_out_subspace(Fg, L, names, "g", device="cpu")
    j = jev.leave_one_out_subspace(Fg, L, names, "g")
    assert (t.n_total, t.n_correct) == (len(L), int((sims.argmax(1) == L).sum()))
    assert np.all(np.abs(_counts(t, names) - _counts(j, names)) <= ambiguous)
    assert 0.2 < t.rate < 0.9


@pytest.mark.parametrize("whiten,bin_normalize", [(False, False), (True, True)])
def test_leave_one_out_r_within_one_view_per_object(subset, whiten, bin_normalize):
    _, Fr, L, names = subset
    t = tev.leave_one_out_subspace(Fr, L, names, "r", whiten=whiten, bin_normalize=bin_normalize, device="cpu")
    j = jev.leave_one_out_subspace(Fr, L, names, "r", whiten=whiten, bin_normalize=bin_normalize)
    assert abs(t.n_correct - j.n_correct) <= N_OBJ
    assert t.rate > 0.8


def test_crossval_svm_within_one_view_per_object(subset):
    _, Fr, L, names = subset
    t = tev.crossval_svm(Fr, L, names, n_folds=4, device="cpu")
    j = jev.crossval_svm(Fr, L, names, n_folds=4)
    assert np.abs(_counts(t, names) - _counts(j, names)).max() <= 1
    assert t.rate > 0.8


def _split_oracle(Xtr, Ltr, Xte, n_class, sub_dim, compress_dim, whiten):
    """The split protocol in float64 numpy."""
    Xtr, Xte = Xtr.astype(np.float64), Xte.astype(np.float64)

    def axes(X, dim):
        w, v = np.linalg.eigh(X.T @ X)
        return v[:, ::-1][:, :dim], w[::-1][:dim]

    if compress_dim:
        comp, var = axes(Xtr, compress_dim)
        Xtr, Xte = Xtr @ comp, Xte @ comp
        if whiten:
            Xtr, Xte = Xtr / np.sqrt(var), Xte / np.sqrt(var)
    W = np.stack([axes(Xtr[Ltr == c], sub_dim)[0] for c in range(n_class)])
    proj = np.einsum("nd,cds->ncs", Xte, W)
    return (proj ** 2).sum(-1) / (Xte ** 2).sum(-1, keepdims=True)


@pytest.mark.parametrize("compress_dim,whiten", [(None, False), (40, False), (40, True)])
def test_split_protocol_matches(subset, compress_dim, whiten):
    """Unwhitened, the port is within 3e-4 of JAX and 1e-4 of a float64
    oracle.  Whitening by 1/sqrt(variance) amplifies the error of the
    trailing f32 eigenvectors (a 1e9 eigenvalue spread): the port solves
    in f64 and stays within 1e-2 of the oracle where the JAX package is
    ~0.2 off, so there only the rates are compared."""
    _, Fr, L, _ = subset
    tr = (np.arange(len(L)) % 24) < 18
    kw = dict(compress_dim=compress_dim, whiten=whiten)
    pt, st = tev.subspace_split_protocol(Fr[tr], L[tr], Fr[~tr], N_OBJ, 8, device="cpu", **kw)
    pj, sj = jev.subspace_split_protocol(Fr[tr], L[tr], Fr[~tr], N_OBJ, 8, **kw)
    so = _split_oracle(Fr[tr], L[tr], Fr[~tr], N_OBJ, 8, **kw)
    np.testing.assert_allclose(st, so, rtol=0, atol=1e-2 if whiten else 1e-4)
    assert (pt == L[~tr]).mean() > 0.9 and (pj == L[~tr]).mean() > 0.9
    if not whiten:
        np.testing.assert_allclose(st, sj, rtol=0, atol=3e-4)
        top2 = np.sort(sj, axis=1)[:, -2:]
        firm = top2[:, 1] - top2[:, 0] > 3e-4
        np.testing.assert_array_equal(pt[firm], pj[firm])
        assert firm.mean() > 0.9


def test_rotation_augmentation_exact():
    np.testing.assert_array_equal(tev._rotation_orbit_perms_981(), jev._rotation_orbit_perms_981())
    rng = np.random.default_rng(0)
    L = np.repeat(np.arange(2), 3)
    for t, d in (("c", 981), ("d", 1001), ("r", 137)):
        F = rng.normal(size=(6, d)).astype(np.float32)
        (Ft, Lt), (Fj, Lj) = tev._augment_rotations(F, L, t), jev._augment_rotations(F, L, t)
        np.testing.assert_array_equal(Ft, Fj)
        np.testing.assert_array_equal(Lt, Lj)
    assert tev.PROTOCOL == jev.PROTOCOL and tev.FEATURE_DIMS == jev.FEATURE_DIMS


def _jax_view_features(path):
    """The JAX package's compute_all_features, its device stages jitted
    (one compile each instead of op by op: the same functions)."""
    from mapping_private_tpu.features import colorchlac as jcc
    from mapping_private_tpu.features import extract as jex
    from mapping_private_tpu.features import rsd as jrsd
    from mapping_private_tpu.io.pcd import load_pcd

    cloud = load_pcd(path, capacity_bucket=2048)
    grid = jex.voxelize_for_features(cloud, dim_floor=32)
    types = jit_call(jex.voxel_types, cloud, grid)
    g = np.asarray(jit_call(jrsd.grsd20_from_types, types, grid.occupancy()))
    c = np.asarray(jit_call(jcc.colorchlac981, grid))
    return {"g": g, "c": c, "d": np.concatenate([g, c]),
            "r": np.concatenate([g, np.asarray(jit_call(jcc.colorchlac117, grid))])}, np.asarray(types)


def test_view_features_and_cache_match(tmp_path):
    from test_torch_classify import _object_view, write_corpus
    from test_torch_colorchlac import _close

    from mapping_private_tpu_torch.io.pcd import save_pcd

    path = str(tmp_path / "view.pcd")
    save_pcd(path, _object_view(0, np.random.default_rng(7), 600))
    got, (want, jtypes) = tev.compute_all_features(path, device="cpu"), _jax_view_features(path)
    assert {k: v.shape for k, v in got.items()} == {"g": (20,), "c": (981,), "d": (1001,), "r": (137,)}
    # the jitted JAX program fuses the kNN's multiply-adds, which moves a
    # few RSD votes across get_type's thresholds: each flipped voxel moves
    # at most 2 x 26 transition counts
    from mapping_private_tpu_torch.features import voxel_types, voxelize_for_features
    from mapping_private_tpu_torch.io.pcd import load_pcd

    cloud = load_pcd(path, capacity_bucket=2048, device="cpu")
    grid = voxelize_for_features(cloud, dim_floor=32)
    occ = grid.occupancy().numpy()
    flips = int((voxel_types(cloud, grid).numpy() != jtypes)[occ].sum())
    assert flips <= 0.03 * occ.sum()
    assert np.abs(got["g"] - want["g"]).sum() <= 52 * flips
    _close(got["c"], want["c"], 981)
    _close(got["r"][20:], want["r"][20:], 117)
    np.testing.assert_array_equal(tev.compute_feature(path, "d", device="cpu"), got["d"])

    root = write_corpus(tmp_path / "corpus", n_objects=2, n_views=2, n_points=300)
    cache = str(tmp_path / "all.npz")
    F, L, names = tev.extract_corpus_features_all(root, cache, device="cpu")
    assert names == ["obj00", "obj01"] and L.tolist() == [0, 0, 1, 1] and F["d"].shape == (4, 1001)
    Fj, Lj, names_j = jev.extract_corpus_features_all(root, cache)  # read from the port's cache
    assert names_j == names
    for t in "cdgr":
        np.testing.assert_array_equal(Fj[t], F[t])
    Fr, Lr, _ = tev.extract_corpus_features(root, "r", str(tmp_path / "r.npz"), device="cpu")
    np.testing.assert_array_equal(Fr, F["r"])
    np.testing.assert_array_equal(jev.extract_corpus_features(root, "r", str(tmp_path / "r.npz"))[0], Fr)
