"""Port parity: the tiled ICP modes that run the dense lattice
(``nn_backend="tiled"``, ``max_tiles=0``) and the segmented re-bucketing
(``rebucket_sweeps=k``) against the JAX package, on the synthetic cases
of tests/test_icp.py with the same (JAX-estimated) normals.  Tolerances
as in tests/test_torch_icp.py: transform within 1e-5, per-sweep RMSE
within rtol 1e-4 (or 1e-7 absolute once converged), correspondence
count exact.

One divergence is by design and does not show here: the JAX dense path
buckets dead source rows as live queries, where they take tile room;
the port buckets only the live rows (``query_mask``), so a live query
is never pushed past ``cap`` by dead ones.  The results differ only
where dead rows crowd a tile past ``cap``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import jit_call, one_torch_thread  # noqa: F401 (fixture)
from test_torch_icp import CASES, _assert_same_run, _inputs

from mapping_private_tpu.ops import tiled_nn as jt
from mapping_private_tpu.registration import icp as jicp
from mapping_private_tpu_torch.registration import icp as ticp


def _union_lattice(arrays, tile):
    """The lattice icp_point_to_plane_tiled sizes: both clouds' live
    bounds, two tiles of margin."""
    src, sm, tgt, tm, _ = arrays
    lo = np.minimum(src[sm].min(0), tgt[tm].min(0)) - np.float32(2 * tile)
    hi = np.maximum(src[sm].max(0), tgt[tm].max(0)) + np.float32(2 * tile)
    return tuple(float(v) for v in lo), tuple(int(v) for v in np.ceil((hi - lo) / np.float32(tile)))


@pytest.mark.parametrize("case,dead_every", [("recovers_known_transform", 5), ("grid_path_case", 0)])
def test_icp_dense_lattice_matches_jax(case, dead_every):
    """nn_backend='tiled' with max_tiles=0: the dense lattice, the queries
    re-bucketed every sweep (32 per tile, 10 sweeps)."""
    seed, xi, _, _ = CASES[case]
    arrays, T_true = _inputs(seed, xi, dead_every)
    origin, dims = _union_lattice(arrays, 0.3)
    kw = dict(iters=10, max_corr_dist=0.3, nn_backend="tiled", grid_cell=0.3, cap_per_cell=32,
              tile_origin=origin, tile_dims=dims, max_tiles=0)
    rj = jit_call(jicp.icp_point_to_plane, *[jnp.asarray(a) for a in arrays], **kw)
    rt = ticp.icp_point_to_plane(*[torch.tensor(a) for a in arrays], **kw)
    _assert_same_run(rt, rj, T_true)


@pytest.mark.parametrize("case,k", [("recovers_known_transform", 4), ("grid_path_case", 1)])
def test_icp_segmented_rebucket_matches_jax(case, k):
    """rebucket_sweeps=k: the queries bucketed at the entry of k segments
    of ceil(15/k) sweeps and re-scattered in between (k=4: segments of 4,
    the last one padded by a sweep in the JAX package); per_iter_rmse
    keeps one entry a sweep.  The lattice and slot count are the ones
    icp_point_to_plane_tiled sizes, with 64 points a tile (these scans
    hold at most 48 in one)."""
    seed, xi, iters, _ = CASES[case]
    arrays, T_true = _inputs(seed, xi, dead_every=5)
    ts = [torch.tensor(a) for a in arrays]
    lattice = ticp.size_tiled_lattice(ts[0], ts[1], ts[2], ts[3], tile_size=0.3, cap_per_cell=64)
    assert lattice["cap_per_cell"] == 128  # the wrapper's lane padding; the densest tile fits in 64
    maxcell = int(jt.lattice_occupancy(jnp.asarray(arrays[2]), jnp.asarray(arrays[3]),
                                       np.asarray(lattice["tile_origin"], np.float32), 0.3,
                                       np.asarray(lattice["tile_dims"], np.int32))[1])
    assert maxcell <= 64
    lattice["cap_per_cell"] = 64
    kw = dict(iters=iters, max_corr_dist=0.3, nn_backend="tiled", grid_cell=0.3, rebucket_sweeps=k, **lattice)
    rj = jit_call(jicp.icp_point_to_plane, *[jnp.asarray(a) for a in arrays], **kw)
    rt = ticp.icp_point_to_plane(*ts, **kw)
    assert rt.per_iter_rmse.shape == (iters,)
    _assert_same_run(rt, rj, T_true)
