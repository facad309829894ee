"""Run the sharded steps on several ranks, and the multi-rank dry run.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``.  ``run_steps`` spawns one process per rank
(``torch.multiprocessing``, start method ``spawn``), each of which
initialises the default process group (a ``FileStore`` in a temporary
directory, never a fixed port), runs a list of ``StepJob``s and sends
back its outputs.  The spawned processes import torch and this package
only.  Collectives time out after ``timeout`` seconds, and the parent
kills every rank and raises when a rank fails or the deadline passes:
a rank that hangs fails the call, it does not hang the caller.

With ``backend="gloo"`` and ``device="cuda"`` every rank computes on
card ``rank % device_count`` and the collectives' payloads go through
host memory (``parallel.mesh``); that runs several ranks on one card,
which NCCL refuses.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mapping_private_tpu_torch.core.se3 import se3_exp
from mapping_private_tpu_torch.parallel import distributed as pd
from mapping_private_tpu_torch.parallel.mesh import make_mesh
from mapping_private_tpu_torch.registration.pose_graph import make_sharded_pose_graph_step
from mapping_private_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class StepJob:
    """One sharded step to run on every rank.

    ``maker(mesh, **kwargs)`` returns (step_fn, shard_fn) (a module-level
    function: it is sent to the ranks by name); ``arrays`` are the global
    inputs (numpy).  The step runs ``calls`` times, timed, after one
    untimed call when ``warmup``; with ``feed`` set, output 0 of each call
    replaces input ``feed`` of the next (GN passes)."""

    maker: Callable
    arrays: Tuple[Any, ...]
    axis_sizes: Optional[Tuple[int, ...]] = None
    axis_names: Tuple[str, ...] = ("dp", "sp")
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    calls: int = 1
    feed: Optional[int] = None
    warmup: bool = False


class JobResult(NamedTuple):
    outputs: Tuple[np.ndarray, ...]  # of the last call
    walls: List[float]  # ms of each timed call, host clock ending in a sync
    launches: Dict[str, int]  # kernel launches of the job on this rank, by kernel


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernel_launches() -> Dict[str, int]:
    from mapping_private_tpu_torch.ops import nn_argmin, nn_gather, nn_matmul

    return {"nn_argmin": nn_argmin.launches, "nn_gather": nn_gather.launches, "nn_matmul": nn_matmul.launches}


def run_job(job: StepJob, device: torch.device) -> Optional[JobResult]:
    """Run ``job`` on this rank of the initialised default process group;
    None on a rank outside the job's mesh."""
    mesh = make_mesh(job.axis_sizes, job.axis_names, device.type)
    if mesh.get_coordinate() is None:
        return None
    before = _kernel_launches()
    step, shard = job.maker(mesh, **job.kwargs)
    args = list(shard(*job.arrays))
    if job.warmup:
        step(*args)
    walls, out = [], None
    for _ in range(job.calls):
        _sync(device)
        t0 = time.perf_counter()
        out = step(*args)
        _sync(device)
        walls.append(1e3 * (time.perf_counter() - t0))
        if job.feed is not None:
            args[job.feed] = out[0]
    launches = {k: v - before[k] for k, v in _kernel_launches().items()}
    return JobResult(tuple(o.cpu().numpy() for o in out), walls, launches)


def _rank_main(rank, world, backend, device, store, jobs, results, timeout, threads):
    """A spawned rank: set up, run every job, report (rank, ok, payload)."""
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = [run_job(job, dev) for job in jobs]
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # the process boundary: report, the parent raises
        results.put((rank, False, traceback.format_exc()))


def run_steps(
    jobs: Sequence[StepJob],
    n_ranks: int,
    backend: str = "nccl",
    device: str = "cuda",
    store_dir: Optional[str] = None,
    timeout: float = 600.0,
) -> List[list]:
    """Spawn ``n_ranks`` ranks that each run ``jobs``; returns, for each
    rank in order, the list of ``run_job`` results.  Raises when a rank
    fails or exits without a result, or when ``timeout`` seconds pass;
    every rank is stopped before it returns or raises."""
    resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: Dict[int, list] = {}
    with tempfile.TemporaryDirectory(dir=store_dir) as td:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n_ranks, backend, device, os.path.join(td, "store"), list(jobs), results,
                                   timeout, torch.get_num_threads()))
                 for r in range(n_ranks)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while len(got) < n_ranks:  # drain the queue before any join
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{n_ranks} ranks: no result from ranks "
                                       f"{sorted(set(range(n_ranks)) - set(got))} within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    gone = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                    if gone:
                        raise RuntimeError(f"rank {gone[0]} exited with code {procs[gone[0]].exitcode} "
                                           f"and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n{payload}")
                got[rank] = payload
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            if any(p.is_alive() for p in procs):
                raise TimeoutError(f"{n_ranks} ranks did not exit within {timeout} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join(10)
    return [got[r] for r in range(n_ranks)]


def _surface_scans(B: int, N: int, rng):
    """The dry run's B target scans of N points (z = 0.3 sin 2.5x + 0.2 cos 3y
    on [-1, 1]²) and the sources, each shifted by (0.01, -0.01, 0.02)."""
    xy = rng.uniform(-1, 1, (B, N, 2))
    z = 0.3 * np.sin(2.5 * xy[..., 0]) + 0.2 * np.cos(3.0 * xy[..., 1])
    tgt = np.concatenate([xy, z[..., None]], axis=-1).astype(np.float32)
    return tgt + np.array([0.01, -0.01, 0.02], np.float32), tgt


def loop_closure_graph(K: int, n_shards: int, seed: int = 7):
    """A drifting circular trajectory of K keyframes: odometry edges and a
    loop closure from every 8th of the first half to its opposite, padded
    with weight-0 self-edges to a multiple of ``n_shards``.  Returns
    (perturbed start poses (K,4,4), edges (E,2) int32, measurements
    (E,4,4), weights (E,), the number of real edges, the loop closures)."""
    odo = [(k, k + 1) for k in range(K - 1)]
    loops = [(k, k + K // 2) for k in range(0, K // 2, 8)]
    n_e = len(odo) + len(loops)
    E = -(-n_e // n_shards) * n_shards
    rng = np.random.default_rng(seed)
    edges = np.zeros((E, 2), np.int32)
    meas = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    w = np.zeros((E,), np.float32)
    ang = 2 * np.pi * np.arange(K) / K
    true_xi = np.stack([np.cos(ang), np.sin(ang), 0.1 * ang, np.zeros(K), np.zeros(K), ang], axis=1)
    exp = lambda x: se3_exp(torch.as_tensor(x, dtype=torch.float32)).numpy()  # noqa: E731
    T_true = [exp(x) for x in true_xi]
    for e, (i, j) in enumerate(odo + loops):
        edges[e] = (i, j)
        meas[e] = np.linalg.inv(T_true[i]) @ T_true[j]
        w[e] = 1.0
    kf = np.stack([T @ exp(rng.normal(0, 0.02, 6)) for T in T_true]).astype(np.float32)
    return kf, edges, meas, w, n_e, len(loops)


def dryrun_jobs(n_ranks: int, small: bool = False):
    """The dry run's jobs: (jobs, facts for its report).

    At full size they are the JAX dry run's shapes: the registration step
    on a (dp, sp) mesh (sp = 2 for an even rank count) with B = dp pairs of
    2,048·sp points; the brute map step (scan_chunk 256) and the tiled one
    (tile 0.3, 2 sweeps) on a flat mesh, a 1,024-point scan against
    16,384 map points a rank; three pose-graph passes at K = 1,024
    keyframes, E = 1,087 edges (64 loop closures).  ``small`` cuts the
    points a scan to 256·sp (1/8), the map to 2,048 a rank (1/8), the scan
    of the map steps to 256 (1/4), with as many scan tiles (``q_max_tiles``
    1,024 → 256), and the graph to K = 64 (E = 67, 4 loop closures)."""
    sp = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    dp = n_ranks // sp
    B, N = dp, (256 if small else 2048) * sp
    rng = np.random.default_rng(0)
    src, tgt = _surface_scans(B, N, rng)
    normals = np.tile(np.array([0, 0, 1.0], np.float32), (B, N, 1))
    mask = np.ones((B, N), bool)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))

    M = (2048 if small else 16384) * n_ranks
    n_scan = 256 if small else 1024
    mxy = rng.uniform(-4, 4, (M, 2))
    mz = 0.3 * np.sin(2.0 * mxy[:, 0]) + 0.2 * np.cos(2.5 * mxy[:, 1])
    map_xyz = np.column_stack([mxy, mz]).astype(np.float32)
    map_nrm = np.tile(np.array([0, 0, 1.0], np.float32), (M, 1))
    scan = map_xyz[rng.choice(M, n_scan, replace=False)] + np.float32(0.01)
    map_args = (scan, np.ones((n_scan,), bool), map_xyz, np.ones((M,), bool), map_nrm, np.eye(4, dtype=np.float32))
    origin, dims, cap, max_tiles = pd.size_map_lattice(map_xyz, np.ones((M,), bool), 0.3, scan_xyz=scan)

    K = 64 if small else 1024
    kf, edges, meas, w, n_e, n_loops = loop_closure_graph(K, n_ranks)
    flat = dict(axis_sizes=(n_ranks,), axis_names=("mp",))
    jobs = [
        StepJob(pd.make_sharded_registration_step, (src, mask, tgt, mask, normals, poses), (dp, sp)),
        StepJob(pd.make_sharded_map_icp_step, map_args, kwargs=dict(scan_chunk=256), **flat),
        StepJob(pd.make_sharded_map_icp_step_tiled, map_args,
                kwargs=dict(origin=origin, tile_size=0.3, dims=dims, cap=cap, max_tiles=max_tiles,
                            q_cap=32, q_max_tiles=n_scan, sweeps=2), **flat),
        StepJob(make_sharded_pose_graph_step, (kf, edges, meas, w), (dp, sp), calls=3, feed=0),
    ]
    return jobs, dict(dp=dp, sp=sp, map_points=M, keyframes=K, edges=n_e, loop_closures=n_loops)


def dryrun_multichip(
    n_ranks: int,
    backend: str = "nccl",
    device: str = "cuda",
    small: bool = False,
    store_dir: Optional[str] = None,
    timeout: float = 600.0,
) -> dict:
    """Run the dry run's sharded steps (``dryrun_jobs``) on ``n_ranks``
    spawned ranks and check them as the JAX dry run does (poses of the
    right shape, correspondences found).  Returns what the JAX dry run
    prints: the mesh, the registration, brute-map and tiled-map
    correspondence counts, the graph's size and its error after the third
    pose-graph pass."""
    jobs, facts = dryrun_jobs(n_ranks, small)
    per_rank = run_steps(jobs, n_ranks, backend, device, store_dir, timeout)
    sp = facts["sp"]
    reg = [r[0].outputs for rank, r in enumerate(per_rank) if rank % sp == 0]  # one rank of each dp block
    corr = sum(int(cnt.sum()) for _, cnt in reg)
    T_map, map_cnt = per_rank[0][1].outputs
    T_tiled, tiled_cnt = per_rank[0][2].outputs
    new_kf, err = per_rank[0][3].outputs
    if sum(poses.shape[0] for poses, _ in reg) != facts["dp"]:
        raise RuntimeError("the registration step returned the wrong number of poses")
    if new_kf.shape != (facts["keyframes"], 4, 4) or T_map.shape != (4, 4) or T_tiled.shape != (4, 4):
        raise RuntimeError("a sharded step returned the wrong shape")
    if corr <= 0 or int(map_cnt) <= 0 or int(tiled_cnt) <= 0:
        raise RuntimeError(f"no correspondences: registration {corr}, map {int(map_cnt)}, tiled {int(tiled_cnt)}")
    return dict(facts, ranks=n_ranks, backend=backend, device=device, corr=corr, map_corr=int(map_cnt),
                tiled_map_corr=int(tiled_cnt), pose_graph_err=float(err))
