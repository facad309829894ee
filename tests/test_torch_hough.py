"""Port parity: models/hough_segmentation.py and apps/hough_segment.py
against the JAX package.

Both packages draw the same uniforms: ``tests/jax_ref.py::hough_uniforms``
reproduces the JAX key chain, and the port takes them as ``u``.  On
tests/test_hough.py's synthetic tabletop scenes the segments agree:
kinds, size classes, inlier masks and counts equal, centroids and radii
within 1e-5 (1e-4 for the PCA boxes of the rest pass and of
segment_by_voting: their extents follow eigenvectors of 3-D covariances
whose two footprint eigenvalues can lie close, and the packages' f32
eigen-solves differ there by ~2e-5).  Votes (sums of hypothesis inlier counts) and a round's
inlier counts may differ by a point or two: a point within an ulp of a
hypothesis's threshold flips where the two packages round a distance
differently (XLA fuses, the port does not), so they are held within
1e-3 relative, masks within 2 points.  Gates and helpers are held one by
one; the CLI's JSON, marked cloud and sizes table against the JAX CLI's
with the JAX CLI's draws."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import hough_uniforms, one_torch_thread  # noqa: F401 (fixture)
from test_hough import _tabletop_scene

from mapping_private_tpu.core import PointCloud as JCloud
from mapping_private_tpu.models import hough_segmentation as jh
from mapping_private_tpu_torch.core.cloud import PointCloud as TCloud
from mapping_private_tpu_torch.fit.box import OrientedBox as TBox
from mapping_private_tpu_torch.models import hough_segmentation as th

CFG = dict(max_objects=4, min_inliers=80)
H = 512


def _with_table(pts, seed=3):
    """The scene standing on a 1 x 0.7 m table top at z = 0 (3,000 points)."""
    rng = np.random.default_rng(seed)
    top = np.column_stack([rng.uniform(0.1, 1.1, 3000), rng.uniform(0.0, 0.7, 3000), rng.normal(0, 0.001, 3000)])
    return np.concatenate([pts, top]).astype(np.float32)


def _centre(s):
    if s.cylinder is not None:
        return np.array([*np.asarray(s.cylinder[0]), s.cylinder[1], s.cylinder[2], s.cylinder[3]])
    return np.concatenate([np.asarray(s.box.center), np.asarray(s.box.extents)])


def _atol(kind):
    return 1e-4 if kind in ("box", "plane") else 1e-5  # PCA boxes: see the module docstring


def assert_segments_match(segs_t, segs_j, votes_rtol=1e-3):
    assert [(s.kind, s.size_class) for s in segs_t] == [(s.kind, s.size_class) for s in segs_j]
    for st, sj in zip(segs_t, segs_j):
        assert st.num_inliers == sj.num_inliers
        np.testing.assert_array_equal(st.inliers, sj.inliers)
        np.testing.assert_allclose(_centre(st), _centre(sj), rtol=0, atol=_atol(sj.kind))
        assert abs(st.votes - sj.votes) <= votes_rtol * max(sj.votes, 1)


@functools.lru_cache(maxsize=None)
def _jax_segments(seed, key_seed, table=False, **cfg):
    pts, _, _ = _tabletop_scene(seed)
    pts = _with_table(pts) if table else pts
    return jh.hough_segment(JCloud.from_numpy(pts), jax.random.PRNGKey(key_seed), jh.HoughConfig(**cfg))


@pytest.mark.parametrize("seed,key_seed", [(0, 0), (1, 1), (2, 6)])
def test_hough_segment_matches_jax(seed, key_seed):
    pts, _, _ = _tabletop_scene(seed)
    segs_t = th.hough_segment(TCloud.from_numpy(pts, device="cpu"), None, th.HoughConfig(**CFG),
                              u=hough_uniforms(jax.random.PRNGKey(key_seed), CFG["max_objects"], H))
    segs_j = _jax_segments(seed, key_seed, **CFG)
    assert len(segs_j) >= 2
    assert_segments_match(segs_t, segs_j)


def test_significant_plane_and_rest_pass_match_jax():
    """The plane pass draws first; the rest pass's dedup list holds the
    plane's centroid too."""
    cfg = dict(CFG, significant_plane=True)
    pts, _, _ = _tabletop_scene(1)
    segs_t = th.hough_segment(TCloud.from_numpy(_with_table(pts), device="cpu"), None, th.HoughConfig(**cfg),
                              u=hough_uniforms(jax.random.PRNGKey(4), CFG["max_objects"], H, significant_plane=True))
    segs_j = _jax_segments(1, 4, table=True, **cfg)
    assert segs_j[0].kind == "plane"
    assert_segments_match(segs_t, segs_j)


def test_hough_segment_table_z_and_empty_cloud():
    pts, _, _ = _tabletop_scene(0)
    lifted = pts + np.float32([0.0, 0.0, 0.75])
    u = hough_uniforms(jax.random.PRNGKey(0), CFG["max_objects"], H)
    segs = th.hough_segment(TCloud.from_numpy(lifted, device="cpu"), None, th.HoughConfig(**CFG), table_z=0.75, u=u)
    segs_j = _jax_segments(0, 0, **CFG)
    cyl_t = next(s for s in segs if s.kind == "cylinder")
    cyl_j = next(s for s in segs_j if s.kind == "cylinder")
    np.testing.assert_allclose(cyl_t.cylinder[2:], cyl_j.cylinder[2:], rtol=0, atol=1e-5)
    assert th.hough_segment(TCloud.from_numpy(np.zeros((0, 3), np.float32), device="cpu"),
                            torch.Generator().manual_seed(0)) == []
    with pytest.raises(ValueError, match="ran out"):
        th.hough_segment(TCloud.from_numpy(pts, device="cpu"), None, th.HoughConfig(**CFG), u=u[:1])


@pytest.mark.parametrize("seed,key_seed,cfg", [(0, 0, {}), (2, 6, {}), (1, 1, {"allow_lines": False})])
def test_segment_by_voting_matches_jax(seed, key_seed, cfg):
    pts, _, _ = _tabletop_scene(seed)
    segs_t, sizes_t = th.segment_by_voting(TCloud.from_numpy(pts, device="cpu"), None, th.VotingConfig(**cfg),
                                           u=hough_uniforms(jax.random.PRNGKey(key_seed), 8, H))
    segs_j, sizes_j = jh.segment_by_voting(JCloud.from_numpy(pts), jax.random.PRNGKey(key_seed),
                                           jh.VotingConfig(**cfg))
    assert_segments_match(segs_t, segs_j)
    assert [r["kind"] for r in sizes_t] == [r["kind"] for r in sizes_j]
    for rt, rj in zip(sizes_t, sizes_j):
        for k in rj:
            if k != "kind":
                np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=_atol(rj["kind"]))


def _round_inputs(seed):
    pts, _, _ = _tabletop_scene(seed)
    cloud = JCloud.from_numpy(pts)
    mask = np.asarray(cloud.mask).copy()
    mask[::5] = False  # a round after some objects were claimed
    return np.asarray(cloud.padded_xyz())[:, :2], mask


@pytest.mark.parametrize("seed", [0, 2])
def test_hough_round_matches_jax_per_field(seed):
    xy, mask = _round_inputs(seed)
    key = jax.random.PRNGKey(10 + seed)
    cfg_j = jh.HoughConfig(**CFG)
    rj = {k: np.asarray(v) for k, v in jh._hough_round(jnp.asarray(xy), jnp.asarray(mask), key, cfg_j).items()}
    kl, kc = jax.random.split(key)
    u = (np.array(jax.random.uniform(kl, (H, 2))), np.array(jax.random.uniform(kc, (H, 3))))
    rt = {k: v.numpy() for k, v in th._hough_round(torch.tensor(xy), torch.tensor(mask), th.HoughConfig(**CFG),
                                                      u=u).items()}
    assert set(rt) == set(rj)
    for k in ("line_n", "line_rho", "circ_c", "circ_r"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=1e-5, err_msg=k)
    for k in ("line_hyp_frac", "circ_hyp_frac"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=2.0 / H, err_msg=k)
    for k in ("line_votes", "circ_votes", "line_count", "circ_count"):
        assert abs(int(rt[k]) - int(rj[k])) <= 1e-3 * int(rj[k]) + 2, k
    for k in ("line_inl", "circ_inl"):
        assert (rt[k] != rj[k]).sum() <= 2, k
    assert int(rj["circ_votes"]) > 0 and int(rj["line_votes"]) > 0


def test_circle_hash_wraps_in_int32():
    """Centres and radii whose (cx, cy, r) id times 2654435761 overflows
    int32 (ids up to 2^26): the buckets equal the JAX package's, an int32
    numpy product's, and (the mask keeps the low 20 bits) an int64
    product's."""
    rng = np.random.default_rng(0)
    center = rng.uniform(-5.0, 5.3, (4096, 2)).astype(np.float32)
    center[:4] = [[5.23, 5.23], [-5.0, -5.0], [0.0, 0.0], [-4.995, 5.1]]
    radius = rng.uniform(0.0, 0.33, 4096).astype(np.float32)
    cfg = th.HoughConfig()
    got = th._circle_bins(torch.tensor(center), torch.tensor(radius), cfg).numpy()
    c, r = jnp.asarray(center), jnp.asarray(radius)
    cx_id = jnp.clip(((c[:, 0] + 5.0) / cfg.center_bin).astype(jnp.int32), 0, 1023)
    cy_id = jnp.clip(((c[:, 1] + 5.0) / cfg.center_bin).astype(jnp.int32), 0, 1023)
    r_id = jnp.clip((r / cfg.radius_bin).astype(jnp.int32), 0, 63)
    ids = (cx_id * 1024 + cy_id) * 64 + r_id
    want = np.asarray((ids * jnp.int32(-1640531535)) & ((1 << 20) - 1))
    np.testing.assert_array_equal(got, want)
    ids_np = np.asarray(ids)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(got, (ids_np * np.int32(-1640531535)) & ((1 << 20) - 1))
    assert got.dtype == np.int32 and (ids_np.astype(np.int64) * 2654435761 > 2**31).mean() > 0.9
    # the mask keeps the low 20 bits, which an int64 product shares
    np.testing.assert_array_equal((ids_np.astype(np.int64) * 2654435761) & ((1 << 20) - 1), got)


def test_vote_argmax_takes_the_first_maximum():
    bins = torch.tensor([5, 2, 5, 2, 7], dtype=torch.int32)
    w = torch.tensor([3, 4, 1, 0, 4], dtype=torch.int32)
    best, votes = th._vote_argmax(bins, w, 8)
    bj, vj = jh._vote_argmax(jnp.asarray(bins.numpy()), jnp.asarray(w.numpy()), 8)
    assert (int(best), int(votes)) == (int(bj), int(vj)) == (2, 4)


def _gate_inputs():
    pts, _, _ = _tabletop_scene(0)
    cloud = JCloud.from_numpy(pts)
    xyz = np.asarray(cloud.padded_xyz())
    rng = np.random.default_rng(1)
    inl = np.asarray(cloud.mask) & (xyz[:, 0] < 0.6)  # the box, all four walls
    planar = inl & (rng.uniform(size=len(xyz)) < 0.7)
    nxy = rng.normal(size=(len(xyz), 2)).astype(np.float32)
    return xyz, inl, planar, nxy


@pytest.mark.parametrize("want_planar", [True, False])
def test_clustering_gate_matches(want_planar):
    xyz, inl, planar, _ = _gate_inputs()
    kt, nt = th._clustering_gate(torch.tensor(xyz), torch.tensor(inl), torch.tensor(planar), 0.015, want_planar)
    kj, nj = jh._clustering_gate(jnp.asarray(xyz), jnp.asarray(inl), jnp.asarray(planar), jnp.float32(0.015),
                                 want_planar)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert int(nt) == int(nj) > 0


def test_refits_and_normal_gates_match():
    xyz, inl, planar, nxy = _gate_inputs()
    xy_t, xy_j = torch.tensor(xyz[:, :2]), jnp.asarray(xyz[:, :2])
    wall = inl & (np.abs(xyz[:, 1] - 0.2) < 0.01)  # one side of the box
    for fn_t, fn_j, sel in ((th._line_refit, jh._line_refit, wall), (th._circle_refit, jh._circle_refit, inl),
                            (th._circle_refit, jh._circle_refit, np.zeros_like(inl))):
        out_t, out_j = fn_t(xy_t, torch.tensor(sel)), fn_j(xy_j, jnp.asarray(sel))
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    line_n = np.array([0.0, 1.0], np.float32)
    np.testing.assert_array_equal(
        th._normal_gate_line(torch.tensor(nxy), torch.tensor(inl), torch.tensor(line_n), 25.0).numpy(),
        np.asarray(jh._normal_gate_line(jnp.asarray(nxy), jnp.asarray(inl), jnp.asarray(line_n), 25.0)))
    centre = np.array([0.4, 0.26], np.float32)
    np.testing.assert_array_equal(
        th._normal_gate_circle(xy_t, torch.tensor(nxy), torch.tensor(inl), torch.tensor(centre), 30.0).numpy(),
        np.asarray(jh._normal_gate_circle(xy_j, jnp.asarray(nxy), jnp.asarray(inl), jnp.asarray(centre), 30.0)))


def test_point_features_match():
    pts, _, _ = _tabletop_scene(1)
    cfg = dict(normal_search_k=16)
    nt, ct, rt, st = th._point_features(TCloud.from_numpy(pts, device="cpu"), th.HoughConfig(**cfg))
    nj, cj, rj, sj = jh._point_features(JCloud.from_numpy(pts), jh.HoughConfig(**cfg))
    live = np.asarray(JCloud.from_numpy(pts).mask)
    np.testing.assert_allclose(np.abs(nt.numpy()[live]), np.abs(np.asarray(nj)[live]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(ct.numpy()[live], np.asarray(cj)[live], rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt.numpy()[live], np.asarray(rj)[live], rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)


@pytest.mark.parametrize("extents", [(0.2, 0.12, 0.18), (0.1, 0.1, 0.6), (0.3, 0.3, 0.02), (0.1, 0.1, 0.8),
                                     (0.05, 0.05, 0.01), (0.4, 0.2, 0.6)])
def test_classify_size_matches(extents):
    assert th._classify_size(np.array(extents), th.HoughConfig()) == jh._classify_size(np.array(extents),
                                                                                         jh.HoughConfig())


def test_mark_classes_and_sizes_text_match():
    pts, _, _ = _tabletop_scene(2)
    segs_j = _jax_segments(2, 6, **CFG)
    segs_t = th.hough_segment(TCloud.from_numpy(pts, device="cpu"), None, th.HoughConfig(**CFG),
                              u=hough_uniforms(jax.random.PRNGKey(6), CFG["max_objects"], H))
    marks_t = th.hough_mark_classes(TCloud.from_numpy(pts, device="cpu"), segs_t)
    np.testing.assert_array_equal(marks_t, jh.hough_mark_classes(JCloud.from_numpy(pts), segs_j))
    assert set(np.unique(marks_t)) >= {2, 4}
    rows = [{"kind": "cylinder", "radius": 0.04, "height": 0.55, "center": [0.8, 0.5]},
            {"kind": "box", "extents": [0.2, 0.12, 0.18], "height": 0.18}]
    assert th.cylinder_sizes_text(rows) == jh.cylinder_sizes_text(rows)
    assert th.cylinder_sizes_text([]) == jh.cylinder_sizes_text([]) == ""


def test_configs_and_segments_carry_across():
    for jcls, tcls in ((jh.HoughConfig, th.HoughConfig), (jh.VotingConfig, th.VotingConfig)):
        j = jcls(max_objects=3) if jcls is jh.HoughConfig else jcls(allow_lines=False)
        assert dataclasses.asdict(tcls(**dataclasses.asdict(j))) == dataclasses.asdict(j)
        assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())
    for sj in _jax_segments(0, 0, **CFG):
        d = dataclasses.asdict(sj)
        if d["box"] is not None:
            d["box"] = TBox(**{k: torch.tensor(np.asarray(v)) for k, v in d["box"].items()})
        st = th.HoughSegment(**d)
        np.testing.assert_array_equal(_centre(st), _centre(sj))
        assert (st.kind, st.size_class, st.num_inliers, st.votes) == (sj.kind, sj.size_class, sj.num_inliers, sj.votes)


def _cli_draws(monkeypatch, n_files, by_voting):
    """Feed the port's CLI the JAX CLI's draws: PRNGKey(0), one split a file."""
    key, subs = jax.random.PRNGKey(0), []
    for _ in range(n_files):
        key, sub = jax.random.split(key)
        subs.append(hough_uniforms(sub, 8, H))
    draws = iter(subs)
    name = "segment_by_voting" if by_voting else "hough_segment"
    orig = getattr(th, name)
    monkeypatch.setattr(th, name, lambda cloud, gen, cfg: orig(cloud, gen, cfg, u=next(draws)))


@pytest.mark.parametrize("by_voting", [False, True])
def test_cli_matches_the_jax_cli(tmp_path, monkeypatch, capsys, by_voting):
    from mapping_private_tpu.apps import hough_segment as jcli
    from mapping_private_tpu.io.pcd import load_pcd_arrays, save_pcd
    from mapping_private_tpu_torch.apps import hough_segment as tcli

    paths = []
    for seed in (0, 2):
        pts, _, _ = _tabletop_scene(seed)
        paths.append(str(tmp_path / f"scene{seed}.pcd"))
        save_pcd(paths[-1], {"xyz": pts})
    outs = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        extra = ["--marked", str(tmp_path / f"{name}_marked.pcd"), "--out-dir", str(tmp_path / f"{name}_objects")]
        if by_voting:
            extra += ["--by-voting", "--sizes-out", str(tmp_path / f"{name}_sizes.txt")]
        if name == "torch":
            extra += ["--device", "cpu"]
            _cli_draws(monkeypatch, len(paths), by_voting)
        assert cli.main(paths + ["--json", "--max-objects", "4"] + extra) == 0
        outs[name] = json.loads(capsys.readouterr().out)
    for path in paths:
        recs_t, recs_j = outs["torch"][path], outs["jax"][path]
        assert [(r["kind"], r["size_class"], r["num_inliers"]) for r in recs_t] == \
            [(r["kind"], r["size_class"], r["num_inliers"]) for r in recs_j]
        for rt, rj in zip(recs_t, recs_j):
            assert abs(rt["votes"] - rj["votes"]) <= 1e-3 * max(rj["votes"], 1)
            for part in ("box", "cylinder"):
                assert (part in rt) == (part in rj)
                for k, v in rj.get(part, {}).items():
                    np.testing.assert_allclose(rt[part][k], v, rtol=0, atol=_atol(rj["kind"]))
    mt, mj = (load_pcd_arrays(str(tmp_path / f"{n}_marked.pcd")) for n in ("torch", "jax"))
    np.testing.assert_array_equal(mt["intensity"], mj["intensity"])
    np.testing.assert_array_equal(mt["x"], mj["x"])
    objs = sorted(p.name for p in (tmp_path / "jax_objects").iterdir())
    assert objs and sorted(p.name for p in (tmp_path / "torch_objects").iterdir()) == objs
    if by_voting:
        st, sj = ((tmp_path / f"{n}_sizes.txt").read_text().split() for n in ("torch", "jax"))
        assert [w for w in st if w.isalpha()] == [w for w in sj if w.isalpha()]
        np.testing.assert_allclose([float(w) for w in st if not w.isalpha()],
                                   [float(w) for w in sj if not w.isalpha()], rtol=0, atol=1.5e-4)  # 4 decimals


def test_cli_refuses_a_missing_card(tmp_path):
    from mapping_private_tpu_torch.apps import hough_segment as tcli

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([str(tmp_path / "x.pcd")])
