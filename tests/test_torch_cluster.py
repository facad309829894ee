"""Port parity: ops/cluster.py against the JAX package.

Labels are integers, so every comparison is exact where the graph's
edges are carried across (``propagate_labels`` is fed the JAX package's
``radius_graph`` output).  Where each side builds its own kNN graph on
random clouds, the rows' edge sets agree on at least 99% of rows (a
neighbour within f32 rounding of the k-th may trade places with it) and
the cluster labels must still be equal.  ``top_clusters`` ranks equal sizes lowest label first, as
``lax.top_k`` does, and ``propagate_labels`` capped at ``max_iters``
returns exactly the JAX loop's labels after that many sweeps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import jit_call

from mapping_private_tpu.ops import cluster as jcl
from mapping_private_tpu_torch.ops import cluster as tcl


def _blobs(seed=0, n_blobs=5, per=120, dead_every=13):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-2, 2, (n_blobs, 3))
    xyz = np.concatenate([c + rng.normal(0, 0.05, (per, 3)) for c in centres])
    xyz = np.concatenate([xyz, rng.uniform(-3, 3, (40, 3))]).astype(np.float32)
    xyz = xyz[rng.permutation(len(xyz))]
    mask = np.arange(len(xyz)) % dead_every != 4
    nrm = rng.normal(size=xyz.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return xyz, mask, nrm


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("use_grid", [False, True])
@pytest.mark.parametrize("with_normals", [False, True])
def test_radius_graph_and_euclidean_cluster_match(use_grid, with_normals):
    xyz, mask, nrm = _blobs()
    kw = dict(k=12, use_grid=use_grid)
    if with_normals:
        kw.update(normals=nrm, angle_threshold=30.0 * np.pi / 180.0)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ji, jv = (np.asarray(a) for a in jit_call(jcl.radius_graph, jnp.asarray(xyz), jnp.asarray(mask),
                                               tolerance=0.15, **jkw))
    ti, tv = (a.numpy() for a in tcl.radius_graph(*_t(xyz, mask), 0.15, **tkw))
    # neighbours within f32 rounding of each other may swap places, or
    # trade the k-th slot, between the two libraries' matmul-form distances
    same = [set(a[va]) == set(b[vb]) for a, va, b, vb in zip(ti, tv, ji, jv)]
    assert np.mean(same) >= 0.99
    jl = np.asarray(jit_call(jcl.euclidean_cluster, jnp.asarray(xyz), jnp.asarray(mask), tolerance=0.15, **jkw))
    tl = tcl.euclidean_cluster(*_t(xyz, mask), 0.15, **tkw).numpy()
    assert tl.dtype == np.int32
    np.testing.assert_array_equal(tl, jl)
    assert len(np.unique(tl[mask])) >= 5


def _chain(n=300):
    """A path graph n-1 → … → 0 (one edge a row, to the previous row): min
    labels travel one row a sweep one way and any distance the other."""
    idx = np.stack([np.arange(n) - 1, np.zeros(n, int)], 1).astype(np.int32)
    valid = np.stack([np.arange(n) > 0, np.zeros(n, bool)], 1)
    init = np.arange(n, dtype=np.int32)[::-1].copy()  # the least label at the far end
    return init, idx, valid


@pytest.mark.parametrize("max_iters", [0, 1, 5, 8, 9, 17, 200])
def test_propagate_labels_capped_matches(max_iters):
    """Unconverged at the cap (the chain needs ~n/2 sweeps), and converged
    long before it; edges carried across."""
    init, idx, valid = _chain()
    mask = np.ones(len(init), bool)
    mask[150] = False  # cuts the chain
    want = np.asarray(jit_call(jcl.propagate_labels, *(jnp.asarray(a) for a in (init, idx, valid, mask)),
                               max_iters=max_iters))
    got = tcl.propagate_labels(*_t(init, idx, valid, mask), max_iters=max_iters).numpy()
    np.testing.assert_array_equal(got, want)
    if max_iters < 100:
        assert len(np.unique(got)) > 3  # not yet converged
    else:
        assert len(np.unique(got)) == 3  # two components and the dead row


def test_propagate_labels_carried_edges_on_blobs():
    xyz, mask, _ = _blobs(seed=1)
    ji, jv = jit_call(jcl.radius_graph, jnp.asarray(xyz), jnp.asarray(mask), tolerance=0.2, k=10)
    init = np.arange(len(xyz), dtype=np.int32)
    want = np.asarray(jit_call(jcl.propagate_labels, jnp.asarray(init), ji, jv, jnp.asarray(mask)))
    got = tcl.propagate_labels(*_t(init, ji, jv, mask)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cluster_sizes_and_top_clusters_with_equal_sizes():
    """Five clusters of sizes 4, 7, 7, 7, 2 and dead rows: the three of
    size 7 are ranked by label; asking for more clusters than exist pads
    with empty ones; min_size drops the small ones."""
    labels = np.array([3, 3, 3, 3, 9, 9, 9, 9, 9, 9, 9, 1, 1, 1, 1, 1, 1, 1,
                       5, 5, 5, 5, 5, 5, 5, 0, 0, 28, 28, 28], np.int32)
    n = 30
    perm = np.random.default_rng(0).permutation(n)
    labels = labels[perm]
    mask = labels != 28
    labels = np.where(mask, labels, n).astype(np.int32)
    np.testing.assert_array_equal(tcl.cluster_sizes(*_t(labels, mask)).numpy(),
                                  np.asarray(jcl.cluster_sizes(jnp.asarray(labels), jnp.asarray(mask))))
    for num, min_size in ((3, 1), (4, 1), (8, 1), (8, 5), (2, 8)):
        jm, js = (np.asarray(a) for a in jcl.top_clusters(jnp.asarray(labels), jnp.asarray(mask), num, min_size))
        tm, ts = (a.numpy() for a in tcl.top_clusters(*_t(labels, mask), num, min_size))
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tm, jm)
        if num == 8 and min_size == 1:
            assert [int(labels[m.argmax()]) for m in tm[:5]] == [1, 5, 9, 3, 0]
            assert list(ts) == [7, 7, 7, 4, 2, 0, 0, 0]
