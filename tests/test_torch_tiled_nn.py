"""Port parity: ops/tiled_nn.py (the compact occupied-tiles engine and
the dense lattice) against the JAX package, same numpy inputs through
both.

The bucket builds are integer work and stable sorts: every field must be
identical (the spare bucket row or tile, the only scatter destination
written more than once, is sliced off in both), and so must the planes
``refresh_compact_coords`` writes.  Both NN engines sum the same direct
differences in f32; squared distances within 1e-6 of the JAX package's
(its CPU program contracts the sum with fused multiply-adds, so a few
last bits differ) and bit for bit equal to a numpy direct-difference
oracle, which sums unfused as the port does.  Indices identical on rows
where the best distance is not tied (the JAX ``_minloc`` has no fixed
order among equal distances)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import jit_call, one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.ops import tiled_nn as jt
from mapping_private_tpu_torch.ops import tiled_nn as tt


def _cloud(n, seed, extent=2.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, (n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def _lattice(pts, tile):
    lo = pts.min(0) - 2 * tile
    dims = tuple(int(v) for v in np.ceil((pts.max(0) + 2 * tile - lo) / tile))
    return lo.astype(np.float32), dims


FIELDS = ("xyz", "valid", "idx", "tile_id", "slot_of", "slot_of_pt", "rank_of")


def _build_both(xyz, mask, lo, tile, dims, cap, mt, **kw):
    cj = jt.build_compact_tiles(jnp.asarray(xyz), jnp.asarray(mask), lo, tile, dims, cap, mt, **kw)
    ct = tt.build_compact_tiles(
        torch.from_numpy(xyz), torch.from_numpy(mask), lo, tile, dims, cap, mt, **kw)
    return cj, ct


@pytest.mark.parametrize("query_only", [False, True])
@pytest.mark.parametrize("cap,mt", [(128, 256), (8, 256), (128, 20)])
def test_build_matches(cap, mt, query_only):
    """Roomy, cap overflow (rank ≥ 8 dropped) and tile spill (max_tiles 20
    below the occupancy)."""
    xyz = _cloud(3000, 0)
    mask = np.ones(3000, bool)
    mask[::6] = False
    lo, dims = _lattice(xyz, 0.25)
    cj, ct = _build_both(xyz, mask, lo, 0.25, dims, cap, mt, query_only=query_only)
    for f in FIELDS:
        got, want = getattr(ct, f).numpy(), np.asarray(getattr(cj, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert ct.xyz.shape == (mt, 3, cap) and ct.idx.dtype == torch.int32
    assert (ct.dims, ct.cap, ct.max_tiles) == (cj.dims, cj.cap, cj.max_tiles)


def test_only_the_spare_row_takes_colliding_writes():
    """Every kept point has a destination of its own; all others go to
    the spare row, which the result does not contain."""
    xyz = _cloud(3000, 1)
    mask = np.ones(3000, bool)
    mask[::4] = False
    lo, dims = _lattice(xyz, 0.25)
    ct = tt.build_compact_tiles(torch.from_numpy(xyz), torch.from_numpy(mask), lo, 0.25, dims, 8, 20)
    idx = ct.idx.numpy()
    kept = idx[idx >= 0]
    assert len(kept) == len(set(kept.tolist())) == int(ct.valid.sum())
    assert mask[kept].all()
    slot, rank = ct.slot_of_pt.numpy()[kept], ct.rank_of.numpy()[kept]
    assert (slot >= 0).all() and (rank < 8).all()
    np.testing.assert_array_equal(idx[slot, rank], kept)
    np.testing.assert_array_equal(ct.xyz.numpy()[slot, :, rank], xyz[kept])
    assert ct.xyz.shape[0] == ct.valid.shape[0] == ct.idx.shape[0] == 20


def test_lattice_occupancy_and_bounds_match_numpy():
    rng = np.random.default_rng(3)
    for extent, radius in [(2.0, 0.3), (6.0, 0.05)]:
        pts = _cloud(4096, int(rng.integers(100)), extent)
        mask = np.ones(4096, bool)
        mask[::7] = False
        lo_t, hi_t = tt.masked_bounds(torch.from_numpy(pts), torch.from_numpy(mask))
        np.testing.assert_array_equal(lo_t.numpy(), pts[mask].min(0))
        np.testing.assert_array_equal(hi_t.numpy(), pts[mask].max(0))
        lo = pts[mask].min(0) - 2 * radius
        dims = np.ceil((pts[mask].max(0) + 2 * radius - lo) / radius).astype(np.int32)
        cell = np.clip(np.floor((pts - lo) / np.float32(radius)).astype(np.int64), 0, dims - 1)
        keys = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        _, counts = np.unique(keys[mask], return_counts=True)
        occ, maxcell = tt.lattice_occupancy(
            torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(lo),
            radius, torch.from_numpy(dims))
        assert (int(occ), int(maxcell)) == (len(counts), counts.max())
        oj, mj = jt.lattice_occupancy(jnp.asarray(pts), jnp.asarray(mask), lo, radius, dims)
        assert (int(occ), int(maxcell)) == (int(oj), int(mj))


@pytest.mark.parametrize("chunk", [1 << 26, 128 * 128 * 5])
def test_compact_nn_matches_jax_on_untied_rows(chunk, monkeypatch):
    monkeypatch.setattr(tt, "_CHUNK_ELEMS", chunk)  # one block, and blocks of 5 slots
    tgt = _cloud(3000, 4)
    qry = (tgt[:2500] + np.random.default_rng(5).normal(0, 0.01, (2500, 3))).astype(np.float32)
    tm = np.ones(3000, bool)
    tm[::7] = False
    qm = np.ones(2500, bool)
    qm[5:9] = False
    lo, dims = _lattice(np.concatenate([tgt, qry]), 0.25)
    tj, ttile = _build_both(tgt, tm, lo, 0.25, dims, 128, 256)
    qj, qtile = _build_both(qry, qm, lo, 0.25, dims, 128, 256, query_only=True)
    ij, sj = (np.asarray(a) for a in jt.compact_nn_1nn(tj, qj))
    it, st = (a.numpy() for a in tt.compact_nn_1nn(ttile, qtile))
    assert it.dtype == np.int32 and st.dtype == np.float32
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(it == -1, ij == -1)
    assert (it[~qm] == -1).all() and np.isinf(st[~qm]).all()
    d2 = ((qry[:, None, :].astype(np.float64) - tgt[None, tm, :]) ** 2).sum(-1)
    part = np.partition(d2, 1, axis=1)
    untied = qm & (part[:, 1] - part[:, 0] > 1e-6)
    assert untied.sum() > 2400
    np.testing.assert_array_equal(it[untied], ij[untied])
    # the true NN lies within the tile size here, so it is the exact one
    np.testing.assert_array_equal(it[untied], np.flatnonzero(tm)[d2.argmin(1)][untied])


def test_spill_contract():
    """A spilled or overflowed QUERY reads back as −1 / inf; a spilled
    TARGET tile yields a farther neighbour (which is why callers must
    size max_tiles from the target's occupancy)."""
    tgt = _cloud(3000, 6)
    ones = np.ones(3000, bool)
    lo, dims = _lattice(tgt, 0.25)
    full = tt.build_compact_tiles(torch.from_numpy(tgt), torch.from_numpy(ones), lo, 0.25, dims, 128, 256)
    occ = int((full.tile_id < dims[0] * dims[1] * dims[2]).sum())
    q_spill = tt.build_compact_tiles(
        torch.from_numpy(tgt), torch.from_numpy(ones), lo, 0.25, dims, 128, occ - 10, query_only=True)
    idx, sq = tt.compact_nn_1nn(full, q_spill)
    spilled = q_spill.slot_of_pt.numpy() < 0
    assert spilled.sum() > 0
    assert (idx.numpy()[spilled] == -1).all() and np.isinf(sq.numpy()[spilled]).all()
    np.testing.assert_array_equal(idx.numpy()[~spilled], np.flatnonzero(~spilled))  # self-NN
    q_cap = tt.build_compact_tiles(
        torch.from_numpy(tgt), torch.from_numpy(ones), lo, 0.25, dims, 16, 256, query_only=True)
    over = q_cap.rank_of.numpy() >= 16
    idx, _ = tt.compact_nn_1nn(full, q_cap)
    assert over.sum() > 0 and (idx.numpy()[over] == -1).all()
    # target side: the spilled tiles' points are gone, their queries match farther points
    t_spill = tt.build_compact_tiles(
        torch.from_numpy(tgt), torch.from_numpy(ones), lo, 0.25, dims, 128, occ - 10)
    q_full = tt.build_compact_tiles(
        torch.from_numpy(tgt), torch.from_numpy(ones), lo, 0.25, dims, 128, 256, query_only=True)
    idx, sq = tt.compact_nn_1nn(t_spill, q_full)
    lost = t_spill.slot_of_pt.numpy() < 0
    got = idx.numpy()[lost]
    assert lost.sum() > 0 and ((got == -1) | ~lost[np.maximum(got, 0)]).all()
    assert (sq.numpy()[lost] > 0).all()


def test_tiled_nn_for_icp_compact_branch():
    tgt = _cloud(2000, 7)
    mask = np.ones(2000, bool)
    lo, dims = _lattice(tgt, 0.25)
    p = (tgt + np.float32(0.004)).astype(np.float32)
    fj = jt.tiled_nn_for_icp(jnp.asarray(tgt), jnp.asarray(mask), jnp.asarray(lo), 0.25, dims, 128, max_tiles=128)
    ft = tt.tiled_nn_for_icp(torch.from_numpy(tgt), torch.from_numpy(mask), lo, 0.25, dims, 128, max_tiles=128)
    ij, sj = (np.asarray(a) for a in fj(jnp.asarray(p)))
    it, st = (a.numpy() for a in ft(torch.from_numpy(p)))
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    assert (it == ij).mean() > 0.999
    # the dense branch (max_tiles=0) returns the same correspondences
    i0, s0 = (a.numpy() for a in tt.tiled_nn_for_icp(
        torch.from_numpy(tgt), torch.from_numpy(mask), lo, 0.25, dims, 64)(torch.from_numpy(p)))
    np.testing.assert_array_equal(s0, st)
    assert (i0 == it).mean() > 0.999


def test_tiled_nn_for_icp_query_mask():
    """Dead query rows get idx -1 and inf; live rows are unchanged (exact)."""
    tgt = _cloud(2000, 7)
    mask = np.ones(2000, bool)
    lo, dims = _lattice(tgt, 0.25)
    p = torch.from_numpy((tgt + np.float32(0.004)).astype(np.float32))
    live = torch.from_numpy(np.arange(2000) % 3 != 0)
    args = (torch.from_numpy(tgt), torch.from_numpy(mask), lo, 0.25, dims, 128)
    i_all, s_all = tt.tiled_nn_for_icp(*args, max_tiles=128)(p)
    i_m, s_m = tt.tiled_nn_for_icp(*args, max_tiles=128, query_mask=live)(p)
    assert (i_m[~live] == -1).all() and torch.isinf(s_m[~live]).all()
    assert torch.equal(s_m[live], s_all[live]) and torch.equal(i_m[live], i_all[live])


def _oracle_sq(qry, tgt, idx):
    """Squared distances to the chosen rows, summed unfused in f32."""
    e = qry - tgt[np.maximum(idx, 0)]
    d = e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2]
    return np.where(idx >= 0, d, np.float32(np.inf))


DENSE_FIELDS = ("xyz", "valid", "idx", "tile_of", "rank_of")


@pytest.mark.parametrize("cap", [32, 4])
def test_dense_build_matches(cap):
    """Roomy tiles and cap overflow (rank ≥ 4 dropped)."""
    xyz = _cloud(1500, 8)
    mask = np.ones(1500, bool)
    mask[::6] = False
    lo, dims = _lattice(xyz, 0.25)
    tj = jt.build_tiles(jnp.asarray(xyz), jnp.asarray(mask), lo, 0.25, dims, cap)
    tl = tt.build_tiles(torch.from_numpy(xyz), torch.from_numpy(mask), lo, 0.25, dims, cap)
    for f in DENSE_FIELDS:
        got, want = getattr(tl, f).numpy(), np.asarray(getattr(tj, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert tl.xyz.shape == (dims[0] * dims[1] * dims[2], 3, cap) and tl.idx.dtype == torch.int32
    assert (tl.dims, tl.cap) == (tj.dims, tj.cap)
    assert (tl.tile_of.numpy()[~mask] == dims[0] * dims[1] * dims[2]).all()


@pytest.mark.parametrize("chunk", [1 << 26, 32 * 32 * 7])
def test_dense_nn_matches_jax_on_untied_rows(chunk, monkeypatch):
    """tiled_nn_1nn in one block and in blocks of 7 tiles; a 16-point cap
    on the query side, so some queries overflow to −1 / inf in both."""
    monkeypatch.setattr(tt, "_CHUNK_ELEMS", chunk)
    tgt = _cloud(1500, 4)
    qry = (tgt[:1200] + np.random.default_rng(5).normal(0, 0.01, (1200, 3))).astype(np.float32)
    tm = np.ones(1500, bool)
    tm[::7] = False
    qm = np.ones(1200, bool)
    qm[5:9] = False
    lo, dims = _lattice(np.concatenate([tgt, qry]), 0.25)
    tj = jt.build_tiles(jnp.asarray(tgt), jnp.asarray(tm), lo, 0.25, dims, 32)
    qj = jt.build_tiles(jnp.asarray(qry), jnp.asarray(qm), lo, 0.25, dims, 16)
    tl = tt.build_tiles(torch.from_numpy(tgt), torch.from_numpy(tm), lo, 0.25, dims, 32)
    ql = tt.build_tiles(torch.from_numpy(qry), torch.from_numpy(qm), lo, 0.25, dims, 16)
    ij, sj = (np.asarray(a) for a in jit_call(jt.tiled_nn_1nn, tj, qj, jnp.asarray(qry)))
    it, st = (a.numpy() for a in tt.tiled_nn_1nn(tl, ql, torch.from_numpy(qry)))
    assert it.dtype == np.int32 and st.dtype == np.float32
    np.testing.assert_array_equal(it == -1, ij == -1)
    over = ql.rank_of.numpy() >= 16
    assert over.sum() > 0 and (it[over] == -1).all() and (it[~qm] == -1).all()
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(st, _oracle_sq(qry, tgt, it))
    live_t = np.flatnonzero(tm)
    d2 = ((qry[:, None, :].astype(np.float64) - tgt[None, tm, :]) ** 2).sum(-1)
    part = np.partition(d2, 1, axis=1)
    untied = (it >= 0) & (part[:, 1] - part[:, 0] > 1e-6)
    assert untied.sum() > 800
    np.testing.assert_array_equal(it[untied], ij[untied])
    np.testing.assert_array_equal(it[untied], live_t[d2.argmin(1)][untied])


def test_dense_and_compact_agree_bit_for_bit():
    """The two engines walk the same stencil over the same distances."""
    tgt = _cloud(1500, 9)
    qry = (tgt[::-1] + np.float32(0.02)).astype(np.float32)
    ones = np.ones(1500, bool)
    lo, dims = _lattice(np.concatenate([tgt, qry]), 0.25)
    dense = tt.tiled_nn_1nn(
        tt.build_tiles(torch.from_numpy(tgt), torch.from_numpy(ones), lo, 0.25, dims, 32),
        tt.build_tiles(torch.from_numpy(qry), torch.from_numpy(ones), lo, 0.25, dims, 32),
        torch.from_numpy(qry))
    _, ct = _build_both(tgt, ones, lo, 0.25, dims, 32, 256)
    _, cq = _build_both(qry, ones, lo, 0.25, dims, 32, 256, query_only=True)
    compact = tt.compact_nn_1nn(ct, cq)
    assert torch.equal(dense[1], compact[1])
    assert (dense[0] == compact[0]).float().mean() > 0.999


@pytest.mark.parametrize("query_only", [False, True])
def test_refresh_compact_coords_matches(query_only):
    """Moved coordinates re-scattered into the old layout: the same planes
    as the JAX package's sorted scatter, and at the build's own
    coordinates the planes of the build."""
    xyz = _cloud(3000, 10)
    mask = np.ones(3000, bool)
    mask[::5] = False
    lo, dims = _lattice(xyz, 0.25)
    cj, ct = _build_both(xyz, mask, lo, 0.25, dims, 8, 40, query_only=query_only)
    assert torch.equal(tt.refresh_compact_coords(ct, torch.from_numpy(xyz)).xyz, ct.xyz)
    moved = (xyz + np.float32(0.013)).astype(np.float32)
    rj = jt.refresh_compact_coords(cj, jnp.asarray(moved))
    rt = tt.refresh_compact_coords(ct, torch.from_numpy(moved))
    np.testing.assert_array_equal(rt.xyz.numpy(), np.asarray(rj.xyz))
    for f in ("tile_id", "slot_of_pt", "rank_of", "valid", "idx"):
        assert getattr(rt, f) is getattr(ct, f)


@pytest.mark.parametrize("dims,what", [((2048, 2048, 512), "2\\*\\*31"), ((1024, 1024, 512), "1 GiB")])
def test_check_lattice_dims_raises(dims, what):
    with pytest.raises(ValueError, match=what):
        tt.check_lattice_dims(dims, 0.01)
    with pytest.raises(ValueError):
        jt.check_lattice_dims(dims, 0.01)
    tt.check_lattice_dims((100, 100, 20), 0.1)
