"""Port parity: the sharded steps (parallel/, the sharded pose-graph step)
against the JAX package's, and the multi-rank dry run.

The JAX steps run on the conftest's virtual CPU mesh; the port's on four
gloo ranks spawned on the CPU through ``parallel.dryrun.run_steps`` (one
spawn for every job of this module, a 60 s deadline), and at world size 1
in this process.  The same inputs, the same mesh shapes ((2, 2) and
(4,)); poses within 1e-5, correspondence counts equal.  The data keep
every query's nearest map point clear of the second nearest (random
surfaces), except in the cross-shard tie case, where one map slice sits
in two shards with different normals and the gathered order decides."""
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.parallel import distributed as jd
from mapping_private_tpu.parallel.mesh import make_mesh as jmake_mesh
from mapping_private_tpu.registration.pose_graph import make_sharded_pose_graph_step as jpose_step
from mapping_private_tpu_torch.parallel import distributed as td
from mapping_private_tpu_torch.parallel import dryrun
from mapping_private_tpu_torch.parallel.mesh import make_mesh
from mapping_private_tpu_torch.registration.pose_graph import make_sharded_pose_graph_step as tpose_step

MESHES = {"2x2": ((2, 2), ("dp", "sp")), "4": ((4,), ("mp",))}
DEADLINE = 60.0


def _surface(n, rng, lo=-2.0, hi=2.0):
    xy = rng.uniform(lo, hi, (n, 2))
    z = 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * np.cos(2.5 * xy[:, 1])
    n_ = np.column_stack([-0.6 * np.cos(2.0 * xy[:, 0]), 0.5 * np.sin(2.5 * xy[:, 1]), np.ones(n)])
    return np.column_stack([xy, z]).astype(np.float32), (n_ / np.linalg.norm(n_, axis=1, keepdims=True)).astype(np.float32)


def _pose(xi):
    from mapping_private_tpu_torch.core.se3 import se3_exp
    return se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()


def registration_inputs():
    rng = np.random.default_rng(11)
    B, N = 2, 96
    tgt, nrm = zip(*(_surface(N, rng, -1, 1) for _ in range(B)))
    tgt, nrm = np.stack(tgt), np.stack(nrm)
    src = (tgt + np.array([0.02, -0.01, 0.015], np.float32)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, ::7] = False  # dead rows, source and target
    poses = np.stack([np.eye(4, dtype=np.float32), _pose([0.01, 0.0, -0.01, 0.0, 0.01, 0.0])])
    return src, mask, tgt, mask, nrm, poses


def map_inputs(seed=12, M=512, n_scan=80):
    rng = np.random.default_rng(seed)
    map_xyz, map_nrm = _surface(M, rng)
    mask = np.ones(M, bool)
    mask[5::9] = False
    scan = (map_xyz[rng.choice(M, n_scan, replace=False)] + np.float32(0.01)).astype(np.float32)
    scan_mask = np.ones(n_scan, bool)
    scan_mask[-3:] = False
    return scan, scan_mask, map_xyz, mask, map_nrm, _pose([0.005, -0.004, 0.0, 0.0, 0.0, 0.01])


def tiled_kwargs(args):
    origin, dims, cap, max_tiles = td.size_map_lattice(args[2], args[3], 0.3, scan_xyz=args[0])
    return dict(origin=origin, tile_size=0.3, dims=dims, cap=cap, max_tiles=max_tiles, q_cap=32,
                q_max_tiles=256, sweeps=2)


def tie_inputs():
    """Shard k of 4 holds rows [32k, 32k + 32).  Shards 1 and 2 hold the same
    32 points, with the surface's normals and with other ones; shards 0
    and 3 lie far away.  Every scan point's nearest map point is then an
    exact tie between shards 1 and 2: the (2, 2) mesh gathers over dp,
    then sp, so the gathered order puts shard 2 (dp 1, sp 0) before shard
    1 (dp 0, sp 1), while on a (4,) mesh shard 1 comes first."""
    rng = np.random.default_rng(13)
    pts, nrm = _surface(32, rng, -1.0, 1.0)
    other = rng.normal(0, 0.4, (32, 3)) + [0.0, 0.0, 1.0]
    other = (other / np.linalg.norm(other, axis=1, keepdims=True)).astype(np.float32)
    far = pts + np.float32(50.0)
    map_xyz = np.concatenate([far, pts, pts, far + 1]).astype(np.float32)
    map_nrm = np.concatenate([nrm, nrm, other, nrm]).astype(np.float32)
    scan = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    return scan, np.ones(32, bool), map_xyz, np.ones(128, bool), map_nrm, np.eye(4, dtype=np.float32)


def pose_graph_inputs(n_shards=4):
    kf, edges, meas, w, _, _ = dryrun.loop_closure_graph(24, n_shards)
    return kf, edges, meas, w


def _jobs():
    jobs = {("registration", "2x2"): dryrun.StepJob(td.make_sharded_registration_step, registration_inputs(),
                                                     (2, 2))}
    margs = map_inputs()
    for name, (sizes, names) in MESHES.items():
        jobs[("map", name)] = dryrun.StepJob(td.make_sharded_map_icp_step, margs, sizes, names)
        jobs[("tiled", name)] = dryrun.StepJob(td.make_sharded_map_icp_step_tiled, margs, sizes, names,
                                               tiled_kwargs(margs))
        jobs[("pose_graph", name)] = dryrun.StepJob(tpose_step, pose_graph_inputs(), sizes, names, calls=2, feed=0)
        jobs[("tie", name)] = dryrun.StepJob(td.make_sharded_map_icp_step, tie_inputs(), sizes, names)
    jobs[("map_chunk7", "4")] = dryrun.StepJob(td.make_sharded_map_icp_step, margs, (4,), ("mp",),
                                               dict(scan_chunk=7))
    return jobs


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """{(step, mesh): [per-rank JobResult]} from one 4-rank spawn."""
    jobs = _jobs()
    per_rank = dryrun.run_steps(list(jobs.values()), 4, "gloo", "cpu",
                                store_dir=str(tmp_path_factory.mktemp("store")), timeout=DEADLINE)
    return {key: [r[i] for r in per_rank] for i, key in enumerate(jobs)}


def _jax_run(maker, arrays, mesh_name, **kw):
    sizes, names = MESHES[mesh_name] if mesh_name in MESHES else ((1, 1), ("dp", "sp"))
    mesh = jmake_mesh(sizes, axis_names=names, devices=jax.devices()[: int(np.prod(sizes))])
    step, shardings = maker(mesh, **kw)
    out = step(*[jax.device_put(jnp.asarray(a), s) for a, s in zip(arrays, shardings)])
    return [np.asarray(o) for o in out]


def _jax_step(kind, mesh_name, arrays):
    if kind == "registration":
        return _jax_run(jd.make_sharded_registration_step, arrays, mesh_name)
    if kind in ("map", "tie"):
        return _jax_run(jd.make_sharded_map_icp_step, arrays, mesh_name)
    if kind == "tiled":
        return _jax_run(jd.make_sharded_map_icp_step_tiled, arrays, mesh_name, **tiled_kwargs(arrays))
    raise ValueError(kind)


@pytest.mark.parametrize("kind,mesh_name", [("registration", "2x2"), ("map", "2x2"), ("map", "4"),
                                             ("tiled", "2x2"), ("tiled", "4")])
def test_step_matches_jax(port_runs, kind, mesh_name):
    arrays = registration_inputs() if kind == "registration" else map_inputs()
    T_j, cnt_j = _jax_step(kind, mesh_name, arrays)
    runs = port_runs[(kind, mesh_name)]
    if kind == "registration":
        # each rank returns its dp block; the sp ranks of a block agree
        blocks = [runs[r].outputs for r in (0, 2)]
        for r in (1, 3):
            for a, b in zip(runs[r].outputs, runs[r - 1].outputs):
                np.testing.assert_array_equal(a, b)
        T_t, cnt_t = (np.concatenate(x) for x in zip(*blocks))
    else:
        T_t, cnt_t = runs[0].outputs
        for r in runs[1:]:  # replicated
            np.testing.assert_array_equal(r.outputs[0], T_t)
    if kind in ("registration", "map"):
        assert all(r.launches["nn_matmul"] == 0 for r in runs)  # the CPU runs the plain version
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-5)
    assert np.all(cnt_t > 0)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_pose_graph_step_matches_jax(port_runs, mesh_name):
    sizes, names = MESHES[mesh_name]
    mesh = jmake_mesh(sizes, axis_names=names, devices=jax.devices()[:4])
    step, shardings = jpose_step(mesh)
    args = [jax.device_put(jnp.asarray(a), s) for a, s in zip(pose_graph_inputs(), shardings)]
    errs = []
    for _ in range(2):
        kf, err = step(*args)
        args[0] = jax.device_put(kf, shardings[0])
        errs.append(float(err))
    kf_t, err_t = port_runs[("pose_graph", mesh_name)][0].outputs
    np.testing.assert_allclose(kf_t, np.asarray(kf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(err_t), errs[-1], rtol=1e-3, atol=1e-9)
    assert errs[-1] < 1e-3 * errs[0]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cross_shard_tie_goes_to_the_gathered_order(port_runs, mesh_name):
    arrays = tie_inputs()
    T_j, cnt_j = _jax_step("tie", mesh_name, arrays)
    T_t, cnt_t = port_runs[("tie", mesh_name)][0].outputs
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-5)
    # the test discriminates: with shard 1's normals in shard 2 too, the
    # winner's normals are the surface's and the pose moves elsewhere
    nrm = arrays[4].copy()
    nrm[64:96] = nrm[32:64]
    T_up, _ = _jax_step("tie", mesh_name, arrays[:4] + (nrm, arrays[5]))
    far_from_up = np.abs(T_j - T_up).max() > 1e-3
    assert far_from_up == (mesh_name == "2x2")  # (2, 2): shard 2 wins; (4,): shard 1


def test_scan_chunk_does_not_change_the_result(port_runs):
    T0, c0 = port_runs[("map", "4")][0].outputs
    T7, c7 = port_runs[("map_chunk7", "4")][0].outputs
    np.testing.assert_array_equal(T7, T0)
    np.testing.assert_array_equal(c7, c0)


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=DEADLINE))
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["registration", "map", "tiled"])
def test_world_size_one_runs_the_same_code(one_rank_group, kind):
    arrays = registration_inputs() if kind == "registration" else map_inputs()
    maker = {"registration": td.make_sharded_registration_step, "map": td.make_sharded_map_icp_step,
             "tiled": td.make_sharded_map_icp_step_tiled}[kind]
    kw = tiled_kwargs(arrays) if kind == "tiled" else {}
    T_t, cnt_t = dryrun.run_job(dryrun.StepJob(maker, arrays, (1, 1), kwargs=kw), torch.device("cpu")).outputs
    T_j, cnt_j = _jax_run(getattr(jd, maker.__name__), arrays, "1x1", **kw)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-5)


def test_make_mesh_layout_and_errors(one_rank_group):
    mesh = make_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("dp", "sp") and tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="sizes for"):
        make_mesh((1,), ("dp", "sp"), device_type="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        make_mesh((2, 1), device_type="cpu")


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device_type="cpu")


def test_size_map_lattice_and_balance_match_jax():
    scan, _, map_xyz, mask, _, _ = map_inputs(M=4096)
    padded_scan = np.concatenate([scan, np.full((4, 3), 1e8, np.float32)])
    for kw in (dict(), dict(scan_xyz=padded_scan), dict(tile_margin=3.0)):
        assert td.size_map_lattice(map_xyz, mask, 0.25, **kw) == jd.size_map_lattice(map_xyz, mask, 0.25, **kw)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        td.size_map_lattice(map_xyz * np.float32(1e4), mask, 0.001)
    for n in (1, 3, 4):
        np.testing.assert_array_equal(td.balance_map_shards(map_xyz, mask, 0.3, n),
                                      jd.balance_map_shards(map_xyz, mask, 0.3, n))
    none = np.zeros_like(mask)
    np.testing.assert_array_equal(td.balance_map_shards(map_xyz, none, 0.3, 4), np.arange(len(map_xyz)))


def test_dryrun_small_on_four_gloo_ranks(tmp_path):
    out = dryrun.dryrun_multichip(4, "gloo", "cpu", small=True, store_dir=str(tmp_path), timeout=DEADLINE)
    assert (out["dp"], out["sp"], out["keyframes"], out["edges"], out["loop_closures"]) == (2, 2, 64, 67, 4)
    assert out["corr"] == 2 * 512  # every source point of both pairs lies 2.4 cm from its target
    assert 0 < out["map_corr"] <= 256 and out["tiled_map_corr"] == out["map_corr"]
    assert out["pose_graph_err"] < 1e-6


def test_a_failing_rank_fails_the_call(tmp_path):
    bad = dryrun.StepJob(td.make_sharded_registration_step, registration_inputs(), (3, 1))  # B = 2 on 3 ranks
    with pytest.raises(RuntimeError, match="equal blocks"):
        dryrun.run_steps([bad], 3, "gloo", "cpu", store_dir=str(tmp_path), timeout=DEADLINE)
