#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mapping_private_tpu_torch).

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Card and build: the card's name and power limit from nvidia-smi, then
   all three kernels (nn_argmin, nn_matmul, nn_gather) built from csrc/
   with nvcc, one process per source, started together (time and ptxas
   report for each: registers, shared memory, spills).
2. Each kernel against its plain PyTorch version on the card: 20,000 x
   20,000 (bench.py's surface; for nn_gather the aux rows are the
   target's estimated normals), sizes that are no multiple of any block,
   1 x 5, dead queries/refs, duplicated refs (with different aux rows,
   inside one 512-ref tie window and across two), lattice midpoints
   (exact ties) and refs duplicated on both sides of every boundary
   between the stretches that the kernels split the refs into (each
   boundary inside a tie window of nn_gather's, whose copies there are
   averaged); for nn_gather also every ref dead with fewer than 512 of
   them (vpu mode: the padding of the last window ties).  Indices must be
   identical and squared distances bit for
   bit equal (kernel and plain version round the same f32 operations in
   the same order, unfused); gathered rows must be identical for single
   winners and within 8 ulp of the largest value for tie averages (the
   plain version sums tied rows in the library's order).  The nn_argmin
   tie cases are also held against a numpy lowest-index oracle, the
   nn_gather tie cases against the averages worked out by hand.  Kernel
   and plain times at 20k x 20k (CUDA events, alternating turns), beside
   the least time the card could take (the larger of FP32 issue slots
   over 132 SMs x 128 lanes x the SM clock, and bytes over 3.35 TB/s),
   and the number of ref stretches the launch made.
   nn_argmin also at the main path's other shapes, 20,000 x 65,536 (a
   tracker sweep against the map, a quarter of it dead rows) and 200,000 x
   200,000 (nn_1nn's brute engine): first held against the plain version
   there (indices equal, d2 bit for bit), then its kernel time, bound and
   the number of ref stretches that the launch made.
3. The registration path: a chain of 4 synthetic 20,000-point scans
   (bench.py's surface and step sizes) written as PCD files and registered
   with ``mapping_private_tpu_torch.apps.icp_register.main([... "--device",
   "cuda"])``.  Every pairwise transform must be within 0.05 (Frobenius) of
   the truth, the trajectory finite, and the kernel launched at least
   pairs x sweeps times by that run.  Then per-pair wall times (normals +
   ICP), and the same small pair registered on the CPU (plain version) and
   on the card (kernel), which must agree within 1e-4.
4. The NN layer's other entry points, as a caller uses them: on the
   20k pair, ``nn_matmul`` and ``nn_gather`` in each distance mode give
   the point-to-plane residuals of one ICP sweep; ``nn_gather(dist="vpu")``
   must equal what the registration path gathers from ``nn_argmin``'s
   indices (sq, target row, normal row) exactly; the RMS residual of
   ``nn_matmul`` and ``dist="mxu"`` must agree with it within 1e-3
   (relative); ``dist="mxu_fast"`` selects approximately, so its gathered
   point must lie within the bf16 bound 2^-5 |q| |r| of the nearest.
5. The front door at full width: ``nn_1nn`` at bench.py's 200k shape
   (N = 200,000 on [0,5]^2, radius 0.1) with engine "compact" and engine
   "brute": the same squared distances bit for bit, the same indices
   wherever the distance is untied, -1 beyond the radius; both wall times.
   Then ``icp_point_to_plane_tiled`` on that pair moved by a known small
   twist (with the surface's analytic normals), 6 sweeps, tile 0.1, 128
   per cell: transform within 0.01 of the
   truth, more than 0.9 N correspondences, RMSE falling.
6. The mapping loop: 12 synthetic 20,000-point scans of the world surface
   seen from a known trajectory, written as PCD files and mapped with
   ``mapping_private_tpu_torch.apps.build_map.main([... "--json",
   "--relax", "--device", "cuda"])`` at the CLI's defaults.  Final
   translation error below 0.02, at least 2 keyframes, more than 20,000
   map points, and the nn_argmin kernel launched at least (scans - 1) x
   icp-iters times by that run.  Then per-scan wall times (normals +
   track), warm.
7. The tabletop slice (no NN kernel lies on it): a synthetic tabletop
   frame of 307,200 points (one Kinect VGA frame) made from ``--seed``: a
   1.2 x 0.8 m table at z = 0.75 with 2 mm noise, two boxes and two
   cylinders standing on it, the floor and a wall, the points of each
   surface in proportion to its area.  ``detect_table`` at the default
   ``TableDetectorConfig()`` (8,192 downsampled rows, 256 hypotheses, 4
   candidates, 16 objects): the table found, its plane within 0.02 m of
   z = 0.75, 4 objects, each centre within 0.05 m of the centroid of its
   object's points; then its warm wall time per call.  The
   ``table_pipeline`` CLI on 3 such frames (each shifted a little) written
   as PCD, with ``--box`` and ``--checkpoint``: one table, 4 objects with
   the same names in every frame, each typed as placed (box or cylinder);
   then the wall time of each of its stages on a warm frame (load, box
   filter, denoise, detect, memory update).  The ``clean_table`` CLI on one
   frame: 4 grasps, each above a placed object.

``python3 chip_smoke.py --profile`` builds the kernels and then, instead
of phases 2-7, profiles with torch.profiler one warm pair of phase 3
(normals + 20 ICP sweeps), one warm tracker step of phase 6, phase 5's
tiled ICP call, and phase 7's denoise of a frame and ``detect_table``
call (device time by kernel, launches, the device's idle share); it
prints no result line.  ``--seed N`` (default 0) makes phase 7's frames.

Every launch count is set to 0 just before a path is driven and read just
after.  Prints, before the last line, one JSON line {"kernels": [...]}
with each kernel's launches on the paths, its largest |sq| disagreement
with the plain version, its time, the plain version's and the bound; the
last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it fails: nothing runs on the CPU instead.
"""
import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_POINTS = 20_000  # bench.py's scan size; the CLIs match the full cloud
N_SCANS = 4  # registration chain (phase 3)
ICP_ITERS = 20  # icp_register's default sweep count
T_TOL = 0.05  # |T - T_true|_F, the bound of bench.py's convergence check
SMALL_TOL = 1e-4  # CPU plain vs card kernel on a small pair
N_BIG = 200_000  # bench.py's big-cloud shape (phase 5)
BIG_RADIUS = 0.1
N_MAP_SCANS = 12  # mapping loop (phase 6)
MAP_ICP_ITERS = 10  # build_map's default sweep count
MAP_T_TOL = 0.02  # final translation error, tests/test_scan_to_map.py's bound
TIE_WINDOW = 512
EPS = float(np.finfo(np.float32).eps)
N_TABLE = 307_200  # one Kinect VGA frame, 640 x 480 (phase 7)
TABLE_FRAMES = 3
TABLE_Z = 0.75
TABLE_HALF = (0.6, 0.4)  # the 1.2 x 0.8 m table top, centred on the origin
TABLE_BOX = (-1.5, -1.5, 0.3, 1.5, 1.5, 1.6)  # the pipeline's --box: drops the floor
# standing on the table: (kind, centre x, centre y, size); a box's size is
# (dx, dy, height) and it shows its top and four sides, a cylinder's is
# (radius, height) and it shows its side
TABLE_OBJECTS = (("box", 0.30, 0.15, (0.12, 0.08, 0.18)),
                 ("box", -0.30, 0.20, (0.16, 0.10, 0.14)),
                 ("cylinder", 0.25, -0.20, (0.045, 0.24)),
                 ("cylinder", -0.25, -0.18, (0.05, 0.20)))
TABLE_SHIFT = (0.01, -0.005)  # frame k of the pipeline is moved by k times this

# H100 SXM: SMs x FP32 lanes; bytes/s of HBM3 (NVIDIA's data sheet)
SM_LANES = 132 * 128
HBM_BYTES_PER_S = 3.35e12
# FP32 issue slots per query-ref pair that the function itself needs: the
# distance (direct differences: 3 sub + 3 mul + 2 add; expansion form: 3 mul
# + 3 add + 1 fma) and one min, since the least of N numbers takes N - 1 of
# them.  The index, the ties and the gather are per query, not per pair.
SLOTS_PER_PAIR = {"nn_argmin": 9, "nn_matmul": 8, "nn_gather:vpu": 9,
                  "nn_gather:mxu": 8, "nn_gather:mxu_fast": 8}
# Until the kernels' redesign the bound counted a compare and a select per
# pair in place of the min (what the first loops issued); shares by that
# count are printed in brackets beside the new ones, to compare with
# earlier records.
SLOTS_PER_PAIR_BEFORE = {name: n + 1 for name, n in SLOTS_PER_PAIR.items()}
KERNEL_FILES = {
    "nn_argmin": ("mapping_private_tpu_torch/csrc/nn_argmin.cu", "mapping_private_tpu/ops/pallas_nn.py:245"),
    "nn_matmul": ("mapping_private_tpu_torch/csrc/nn_matmul.cu", "mapping_private_tpu/ops/pallas_nn.py:38"),
    "nn_gather": ("mapping_private_tpu_torch/csrc/nn_gather.cu", "mapping_private_tpu/ops/pallas_nn.py:110"),
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def surface(n: int, seed: int) -> np.ndarray:
    """bench.py's synthetic scene: z = 0.4 sin(1.8x) + 0.3 cos(2.2y)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.4 * np.sin(1.8 * xy[:, 0]) + 0.3 * np.cos(2.2 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def lowest_index_oracle(q: np.ndarray, r: np.ndarray):
    """numpy 1-NN in the kernel's summation order; first minimum wins."""
    idx = np.empty(len(q), np.int64)
    sq = np.empty(len(q), np.float32)
    for s in range(0, len(q), 256):
        d = q[s : s + 256, None, :] - r[None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        idx[s : s + 256] = d2.argmin(1)
        sq[s : s + 256] = d2.min(1)
    return idx, sq


def nn_cases(pad: float, full: bool, boundaries):
    """(name, queries, refs, check against the numpy oracle too, has exact
    ties).  ``full`` adds the two large cases of the nn_argmin check.
    ``boundaries(nq, nr)`` gives the first ref of every stretch but the
    first that the kernels split nr refs into for nq queries."""
    rng = np.random.default_rng(123)
    uni = lambda n: rng.uniform(-2, 2, (n, 3)).astype(np.float32)  # noqa: E731
    dead_q, dead_r = surface(N_POINTS, 21), surface(N_POINTS, 22)
    dead_q[rng.uniform(size=N_POINTS) < 0.1] = -pad
    dead_r[rng.uniform(size=N_POINTS) < 0.1] = pad
    base = surface(5000, 31)
    dup_r = np.concatenate([base, base, base])[rng.permutation(15000)]
    dup_q = np.concatenate([surface(2000, 32), dup_r[:500]])
    g = np.stack(np.meshgrid(*[np.arange(40)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lat_r = g[rng.permutation(len(g))].astype(np.float32)
    cells = g[(g < 39).all(1)][rng.permutation(39**3)[:1000]].astype(np.float32)
    lat_q = np.concatenate([cells + [0.5, 0.5, 0.5], cells + [0.5, 0.0, 0.5], cells + [0.0, 0.5, 0.0]])
    # 20 refs before each stretch boundary repeated right after it, queries on
    # them: the copy in the earlier stretch has the lower index and must win
    split_q, split_r = uni(3000), uni(N_POINTS)
    for k, b in enumerate(boundaries(len(split_q), len(split_r))):
        split_r[b : b + 20] = split_r[b - 20 : b]
        split_q[20 * k : 20 * k + 20] = split_r[b - 20 : b]
    cases = [("main_path_20000x20000", surface(N_POINTS, 1), surface(N_POINTS, 0), False, False)]
    if full:
        cases.append(("100000x100000", surface(100_000, 2), surface(100_000, 3), False, False))
    cases += [("ragged_20011x19997", uni(20011), uni(19997), False, False),
              ("1x5", uni(1), uni(5), True, False)]
    if full:
        cases.append(("3x70001", uni(3), uni(70001), True, False))
    cases += [
        ("dead_queries_and_refs_20000x20000", dead_q, dead_r, False, False),
        ("duplicated_refs_2500x15000", dup_q, dup_r, True, True),
        ("lattice_midpoints_3000x64000", lat_q.astype(np.float32), lat_r, True, True),
        ("ties_across_stretch_boundaries_3000x20000", split_q, split_r, True, True),
    ]
    return cases


def tie_case():
    """Duplicated refs with DIFFERENT aux rows: 100 pairs inside tie window
    0, 100 pairs split across windows 0|1; the first 200 queries sit on
    them.  Returns (q, r, aux, expected aux rows of those 200 queries)."""
    rng = np.random.default_rng(77)
    q, r = surface(2000, 41), surface(4 * TIE_WINDOW - 37, 42)
    aux = rng.normal(size=r.shape).astype(np.float32)
    r[20:120] = r[300:400]  # both in window 0: averaged
    r[TIE_WINDOW + 40 : TIE_WINDOW + 140] = r[150:250]  # windows 0 | 1: the first wins
    q[:100], q[100:200] = r[300:400], r[150:250]
    want = np.concatenate([(aux[20:120] + aux[300:400]) / 2, aux[150:250]])
    return q, r, aux, want


def event_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call over ``reps`` back-to-back calls."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_turns(torch, kernel_fn, plain_fn):
    """(kernel ms, plain ms, kernel turns, plain turns): medians of three
    alternating turns each."""
    kern, plain = [], []
    for turn in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        if turn == "kernel":
            kern.append(event_ms(torch, kernel_fn, 50))
        else:
            plain.append(event_ms(torch, plain_fn, 5))
    return statistics.median(kern), statistics.median(plain), kern, plain


def bound_ms(name: str, nq: int, nr: int, bytes_moved: int, sm_clock_hz: float):
    """The least time the card could take: (ms, 'operations' or 'bytes',
    ms by the earlier count of slots per pair)."""
    ops_ms = 1e3 * SLOTS_PER_PAIR[name] * nq * nr / (SM_LANES * sm_clock_hz)
    bytes_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    before_ms = max(ops_ms * SLOTS_PER_PAIR_BEFORE[name] / SLOTS_PER_PAIR[name], bytes_ms)
    return (ops_ms, "operations", before_ms) if ops_ms >= bytes_ms else (bytes_ms, "bytes", before_ms)


def make_chain(se3_exp, torch):
    """bench.py make_chain at N_SCANS scans: each scan is the previous one
    seen from a pose moved by a random small step."""
    rng = np.random.default_rng(1)
    scans, steps = [surface(N_POINTS, 0)], []
    for _ in range(N_SCANS - 1):
        xi = rng.uniform(-1, 1, 6).astype(np.float32) * np.array(
            [0.05, 0.04, 0.03, 0.02, 0.02, 0.03], np.float32)
        T = se3_exp(torch.from_numpy(xi)).numpy()
        scans.append(((scans[-1] - T[:3, 3]) @ T[:3, :3]).astype(np.float32))
        steps.append(T)
    return scans, np.stack(steps)


def big_pair():
    """bench.py's big-cloud shape: N_BIG points on [0,5]^2, a noisy copy as
    the source, and the surface's analytic unit normals (with them all six
    degrees of a twist are observable).  Returns (tgt, src, normals)."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 5.0, (N_BIG, 2))
    z = 0.3 * np.sin(xy[:, 0] * 2) + 0.2 * np.cos(xy[:, 1] * 3) + rng.normal(0, 0.005, N_BIG)
    tgt = np.column_stack([xy, z]).astype(np.float32)
    src = (tgt + rng.normal(0, 0.01, tgt.shape)).astype(np.float32)
    nrm = np.column_stack([-0.6 * np.cos(2 * xy[:, 0]), 0.6 * np.sin(3 * xy[:, 1]), np.ones(N_BIG)])
    return tgt, src, (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)


def map_scan(k: int, se3_exp, torch):
    """Scan k of the mapping loop: (sensor pose, a fresh 20,000-point
    sampling of the world surface seen from it)."""
    T = se3_exp(torch.tensor([0.05 * k, 0.01 * k, 0.0, 0.0, 0.0, 0.02 * k])).numpy().astype(np.float64)
    world = surface(N_POINTS, 100 + k).astype(np.float64)
    return T, ((world - T[:3, 3]) @ T[:3, :3]).astype(np.float32)


def tabletop_frame(seed: int, shift=(0.0, 0.0)):
    """Phase 7's frame: N_TABLE points on the table top (2 mm noise), the
    objects of TABLE_OBJECTS, the floor (3 x 3 m at z = 0) and a wall (x =
    1.4, 3 m wide, 2 m high), each surface's share of the points in
    proportion to its area, all moved by ``shift`` in x, y.  Returns (xyz
    (N_TABLE, 3) float32 shuffled, [(kind, centroid of the object's
    points)])."""
    rng = np.random.default_rng(seed)
    sides = lambda dx, dy, h: (dx + dy) * 2 * h  # noqa: E731
    areas = [4 * TABLE_HALF[0] * TABLE_HALF[1]]
    for kind, _, _, size in TABLE_OBJECTS:
        areas.append(size[0] * size[1] + sides(*size) if kind == "box" else 2 * np.pi * size[0] * size[1])
    areas += [9.0, 6.0]  # floor, wall
    counts = np.floor(N_TABLE * np.asarray(areas) / sum(areas)).astype(int)
    counts[-1] += N_TABLE - counts.sum()
    n_top = counts[0]
    top = np.column_stack([rng.uniform(-1, 1, (n_top, 2)) * TABLE_HALF,
                           TABLE_Z + rng.normal(0, 0.002, n_top)])
    parts, truth = [top], []
    for (kind, cx, cy, size), n in zip(TABLE_OBJECTS, counts[1:]):
        if kind == "box":
            dx, dy, h = size
            # a face by area, then a uniform point on it: top, -x, +x, -y, +y
            face = rng.choice(5, n, p=np.array([dx * dy, dy * h, dy * h, dx * h, dx * h]) / (dx * dy + sides(*size)))
            p = rng.uniform(-0.5, 0.5, (n, 3)) * [dx, dy, h] + [0.0, 0.0, 0.5 * h]
            p[face == 0, 2] = h
            for f, (ax, v) in enumerate([(0, -dx / 2), (0, dx / 2), (1, -dy / 2), (1, dy / 2)], start=1):
                p[face == f, ax] = v
        else:
            r, h = size
            th = rng.uniform(0, 2 * np.pi, n)
            p = np.column_stack([r * np.cos(th), r * np.sin(th), rng.uniform(0, h, n)])
        p += [cx, cy, TABLE_Z]
        parts.append(p)
        truth.append((kind, p.mean(0) + [shift[0], shift[1], 0.0]))
    n_floor, n_wall = counts[-2], counts[-1]
    parts.append(np.column_stack([rng.uniform(-1.5, 1.5, (n_floor, 2)), np.zeros(n_floor)]))
    parts.append(np.column_stack([np.full(n_wall, 1.4), rng.uniform(-1.5, 1.5, n_wall), rng.uniform(0, 2, n_wall)]))
    xyz = np.concatenate(parts) + [shift[0], shift[1], 0.0]
    return xyz[rng.permutation(N_TABLE)].astype(np.float32), truth


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.int32)


def profile_call(torch, name: str, fn, smi: str):
    """One warm call of ``fn`` under torch.profiler: its wall time
    unprofiled (host clock ending in a sync), the sum of device kernel
    time, the device's idle share (1 - device time / wall time), the number
    of kernel launches and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t, c = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (t + ev.device_time_total / 1e3, c + 1)  # us -> ms
    dev_ms = sum(t for t, _ in kernels.values())
    n_launch = sum(c for _, c in kernels.values())
    wall = statistics.median(walls)
    print(f"== {name} [{smi}]")
    print(f"wall (unprofiled, median of {[round(w, 2) for w in walls]}): {wall:.2f} ms; device kernel time "
          f"{dev_ms:.2f} ms in {n_launch} launches; device idle share {1 - dev_ms / wall:.3f}")
    if dev_ms == 0.0:
        fail("the profiler recorded no device time")
    for kname, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t:9.3f} ms {100 * t / dev_ms:5.1f}% {c:6d} x  {kname[:100]}")


def profile_paths(torch, dev, smi: str, seed: int):
    """--profile: where the time goes in a pair of phase 3 (scan 1 onto scan
    0), in a tracker step of phase 6 (scan 4 against the map of scans 0-3),
    in phase 5's tiled ICP call, and in phase 7's denoise of a box-filtered
    frame and its detect_table call."""
    from mapping_private_tpu_torch.core.cloud import PointCloud
    from mapping_private_tpu_torch.core.se3 import se3_exp
    from mapping_private_tpu_torch.ops.normals import estimate_normals
    from mapping_private_tpu_torch.registration.icp import icp_point_to_plane, icp_point_to_plane_tiled
    from mapping_private_tpu_torch.registration.scan_to_map import ScanToMapTracker, TrackerConfig

    scans, _ = make_chain(se3_exp, torch)
    tgt_c, src_c = (PointCloud.from_numpy(a, device=dev) for a in scans[:2])

    def pair():
        tgt_n = estimate_normals(tgt_c, k=12)
        icp_point_to_plane(src_c.padded_xyz(), src_c.mask, tgt_n.padded_xyz(), tgt_n.mask,
                           tgt_n.channel("normal"), iters=ICP_ITERS)

    profile_call(torch, f"pair: normals k=12 + icp_point_to_plane ({ICP_ITERS} sweeps), {N_POINTS}-point scans", pair, smi)

    clouds = [PointCloud.from_numpy(map_scan(k, se3_exp, torch)[1], device=dev) for k in range(5)]
    tracker = ScanToMapTracker(TrackerConfig(icp_iters=MAP_ICP_ITERS), device=dev)
    for cloud in clouds[:4]:
        c = estimate_normals(cloud, k=12)
        tracker.track(c.padded_xyz(), c.channel("normal"), c.mask)
    state = (tracker.map, tracker.pose, list(tracker.keyframe_poses), list(tracker.edges))

    def step():
        tracker.map, tracker.pose = state[0], state[1]
        tracker.keyframe_poses, tracker.edges = list(state[2]), list(state[3])
        c = estimate_normals(clouds[4], k=12)
        tracker.track(c.padded_xyz(), c.channel("normal"), c.mask)

    profile_call(torch, f"tracker step: normals k=12 + track ({MAP_ICP_ITERS} sweeps), {N_POINTS}-point scan, "
                 f"map of {int(tracker.map.count())} points", step, smi)

    tgt, src, nrm = (torch.from_numpy(a).to(dev) for a in big_pair())
    ones = torch.ones(N_BIG, dtype=torch.bool, device=dev)
    profile_call(torch, f"icp_point_to_plane_tiled: {N_BIG} points, 6 sweeps, tile {BIG_RADIUS}",
                 lambda: icp_point_to_plane_tiled(src, ones, tgt, ones, nrm, tile_size=BIG_RADIUS,
                                                  cap_per_cell=128, iters=6), smi)

    from mapping_private_tpu_torch.models.table_detector import TableDetectorConfig, detect_table
    from mapping_private_tpu_torch.ops.filters import box_filter, remove_statistical_outliers

    frame, _ = tabletop_frame(seed)
    boxed = box_filter(PointCloud.from_numpy(frame, device=dev), TABLE_BOX[:3], TABLE_BOX[3:])
    denoise = lambda: remove_statistical_outliers(boxed, k=20, alpha=2.0, min_nr_pts=100)  # noqa: E731
    profile_call(torch, f"denoise: remove_statistical_outliers(k=20) over a {N_TABLE}-row frame "
                 f"({int(boxed.count())} live after the box filter)", denoise, smi)
    cloud, _ = denoise()
    gen = torch.Generator(device=dev).manual_seed(seed)
    profile_call(torch, f"detect_table at the default config, that frame denoised ({int(cloud.count())} points)",
                 lambda: detect_table(cloud, gen, TableDetectorConfig()), smi)


def check_detection(det, truth, label: str):
    """Phase 7's checks of one detect_table result against the frame's
    placed objects; returns a line to print."""
    import torch

    plane = det.plane.cpu().numpy().astype(np.float64)
    sizes, centres = det.object_sizes.cpu().numpy(), det.object_centers.cpu().numpy()
    found_c = centres[sizes > 0]
    z0 = -plane[3] / plane[2] if plane[2] else np.inf
    want = np.stack([c for _, c in truth])
    dist = np.linalg.norm(found_c[:, None, :] - want[None, :, :], axis=-1) if len(found_c) else np.zeros((0, len(want)))
    nearest = dist.argmin(1) if len(found_c) else np.zeros(0, int)
    msg = (f"{label}: found {bool(det.found)}, plane height {z0:.4f} (|dz| bound 0.02), objects "
           f"{len(found_c)} of sizes {sizes[sizes > 0].tolist()}, centre errors "
           f"{[float(f'{d:.3g}') for d in dist.min(1)] if len(found_c) else []} m (bound 0.05)")
    if not bool(det.found) or abs(z0 - TABLE_Z) >= 0.02 or len(found_c) != len(truth):
        fail(msg)
    if sorted(nearest.tolist()) != list(range(len(truth))) or dist.min(1).max() >= 0.05:
        fail(msg)
    if not all(bool(torch.isfinite(t).all()) for t in (det.plane, det.object_centers, det.hull.radii)):
        fail(f"{label}: non-finite output")
    return msg


def phase_tabletop(torch, dev, smi: str, seed: int):
    """Phase 7: detect_table on a frame, the table_pipeline CLI on
    TABLE_FRAMES frames and the clean_table CLI on one."""
    from mapping_private_tpu_torch.apps import clean_table, table_pipeline
    from mapping_private_tpu_torch.core.cloud import PointCloud
    from mapping_private_tpu_torch.io.pcd import load_pcd, save_pcd
    from mapping_private_tpu_torch.models.table_detector import TableDetectorConfig, detect_table
    from mapping_private_tpu_torch.models.table_memory import TableMemory
    from mapping_private_tpu_torch.ops.filters import box_filter, remove_statistical_outliers

    cfg = TableDetectorConfig()
    frame, truth = tabletop_frame(seed)
    cloud = PointCloud.from_numpy(frame, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    det, _ = detect_table(cloud, gen, cfg)
    print(check_detection(det, truth, f"detect_table on a {N_TABLE}-point frame (first call "
                                      f"{1e3 * (time.perf_counter() - t0):.2f} ms)"), flush=True)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det, _ = detect_table(cloud, gen, cfg)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    print(check_detection(det, truth, "detect_table, a later draw"))
    print(f"detect_table {N_TABLE} points, down_capacity {cfg.down_capacity}, {cfg.sac_hypotheses} hypotheses: "
          f"{statistics.median(walls):.2f} ms warm wall per call (turns {[round(w, 2) for w in walls]}, host clock "
          f"ending in a sync) [{smi}]", flush=True)

    box_args = ["--box", *(str(v) for v in TABLE_BOX)]
    with tempfile.TemporaryDirectory() as td:
        paths, truths = [], []
        for k in range(TABLE_FRAMES):
            xyz, tr = tabletop_frame(seed + k, (k * TABLE_SHIFT[0], k * TABLE_SHIFT[1]))
            paths.append(f"{td}/frame{k}.pcd")
            save_pcd(paths[-1], {"xyz": xyz})
            truths.append(tr)
        ckpt = f"{td}/memory.npz"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = table_pipeline.main(paths + box_args + ["--checkpoint", ckpt, "--json", "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        belief = json.loads(buf.getvalue())
        mem = TableMemory.restore(ckpt, device=dev)
        print(f"table_pipeline main(): rc {rc}, {cli_s:.3f} s wall for {TABLE_FRAMES} frames of {N_TABLE} points "
              f"(first call); belief state {belief}")
        if rc != 0 or list(belief) != ["table_0"] or len(mem.tables) != 1:
            fail(f"table_pipeline: rc {rc}, tables {list(belief)}")
        insts = mem.tables[0].instances
        named = []  # per frame: {placed object index: (name, type)}
        for k, inst in enumerate(insts):
            want = np.stack([c for _, c in truths[k]])
            got = {}
            for o in inst.objects:
                d = np.linalg.norm(want - o.center, axis=1)
                got[int(d.argmin())] = (o.name, o.object_type, float(d.min()))
            named.append(got)
            print(f"frame {k}: " + ", ".join(f"{truths[k][i][0]} {i}: {n} typed {t} (centre off {d:.3g} m)"
                                           for i, (n, t, d) in sorted(got.items())))
        kinds = {i: kind for i, (kind, _, _, _) in enumerate(TABLE_OBJECTS)}
        ok = (len(insts) == TABLE_FRAMES and all(len(i.objects) == len(TABLE_OBJECTS) for i in insts)
              and all(set(g) == set(kinds) for g in named)
              and all(g[i][:2] == named[0][i][:2] and g[i][1] == kinds[i] and g[i][2] < 0.05
                      for g in named for i in kinds))
        if not ok:
            fail("table_pipeline: not one table with 4 objects named alike in every frame and typed as placed")

        # the stages of a warm frame, each ending in a sync: the CLI's body
        stage_mem, stage_gen = TableMemory(device=dev), torch.Generator(device=dev).manual_seed(seed)
        for turn in range(2):
            t = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = load_pcd(paths[0], device=dev)
            torch.cuda.synchronize()
            t["load"] = time.perf_counter()
            c = box_filter(c, TABLE_BOX[:3], TABLE_BOX[3:])
            torch.cuda.synchronize()
            t["box filter"] = time.perf_counter()
            c, valid = remove_statistical_outliers(c, k=20, alpha=2.0, min_nr_pts=100)
            valid = bool(valid)
            t["denoise"] = time.perf_counter()
            d, down = detect_table(c, stage_gen, cfg)
            found = bool(d.found)
            t["detect"] = time.perf_counter()
            xyz = down.xyz.cpu().numpy()
            masks, sizes = d.object_masks.cpu().numpy(), d.object_sizes.cpu().numpy()
            stage_mem.update(xyz[d.table_inliers.cpu().numpy()][:, :2], float(d.table_min[2]),
                             [xyz[m] for m, n in zip(masks, sizes) if n > 0], generator=stage_gen)
            torch.cuda.synchronize()
            t["memory update"] = time.perf_counter()
            if not (valid and found):
                fail(f"table_pipeline stages: denoise valid {valid}, table found {found}")
        ms, prev = {}, t0
        for name, tt in t.items():
            ms[name], prev = 1e3 * (tt - prev), tt
        print(f"table_pipeline stages, warm frame of {N_TABLE} points ({int(c.count())} after denoise): "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
              + f"; total {sum(ms.values()):.2f} ms [{smi}]", flush=True)

        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = clean_table.main([paths[0], "--device", "cuda"])
        plan = json.loads(buf.getvalue())
    want = np.stack([c for _, c in truths[0]])
    grasp_xy = np.asarray([g["position"][:2] for g in plan["grasps"]]).reshape(-1, 2)
    d = np.linalg.norm(grasp_xy[:, None, :] - want[None, :, :2], axis=-1)
    print(f"clean_table main(): rc {rc}, {time.perf_counter() - t0:.3f} s wall (first call), table found "
          f"{plan['table_found']}, {len(plan['grasps'])} grasps, xy off the placed objects "
          f"{[float(f'{v:.3g}') for v in d.min(1)]} m")
    if rc != 0 or not plan["table_found"] or len(plan["grasps"]) != len(TABLE_OBJECTS):
        fail("clean_table: not 4 grasps")
    if sorted(d.argmin(1).tolist()) != list(range(len(TABLE_OBJECTS))) or d.min(1).max() >= 0.05:
        fail("clean_table: the grasps are not one above each placed object")


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description="On-card smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--profile", action="store_true", help="profile the paths instead of checking them")
    ap.add_argument("--seed", type=int, default=0, help="seed of phase 7's tabletop frames")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")

    def smi_query(fields: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]

    smi = smi_query("name,power.limit")
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    clocks = smi_query("clocks.sm,clocks.max.sm")
    sm_clock_hz = 1e6 * float(clocks.split(",")[1].split()[0])
    print(f"SM clock now, max: {clocks}; bounds use the max", flush=True)
    try:
        from mapping_private_tpu_torch import _build
    except ImportError as e:
        fail(f"the port is not importable (run from the repository root): {e}")
    from mapping_private_tpu_torch.apps import build_map, icp_register
    from mapping_private_tpu_torch.core.cloud import PAD_COORD, PointCloud
    from mapping_private_tpu_torch.core.se3 import se3_exp
    from mapping_private_tpu_torch.io.pcd import load_pcd, save_pcd
    from mapping_private_tpu_torch.ops import nn_argmin, nn_gather, nn_matmul, nn_search
    from mapping_private_tpu_torch.ops.nn_dispatch import nn_1nn
    from mapping_private_tpu_torch.ops.normals import estimate_normals
    from mapping_private_tpu_torch.registration.icp import (
        icp_point_to_plane, icp_point_to_plane_tiled)
    from mapping_private_tpu_torch.registration.scan_to_map import ScanToMapTracker, TrackerConfig

    dev = torch.device("cuda")
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    wrappers = {"nn_argmin": nn_argmin, "nn_matmul": nn_matmul, "nn_gather": nn_gather}

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def boundaries(nq, nr):
        splits = nn_search.split_count(nq, nr, sms)
        step = nn_search.stretch_len(nr, splits)
        return [k * step for k in range(1, nn_search.stretch_count(nr, splits))]

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    built = _build.compile_libraries()
    for name in built:
        _build.load_library(name)
    print(f"build: {len(built)} kernels, build+load {time.perf_counter() - t0:.2f} s")
    for name, (lib_path, log, nvcc_s) in built.items():
        print(f"  {name}: {lib_path.name} nvcc {nvcc_s:.2f} s")
        for line in log.splitlines():
            if ("ptxas info" in line and ("Used" in line or "Compiling" in line)) or "spill" in line:
                print(f"    {line.strip()}")

    if args.profile:
        profile_paths(torch, dev, smi, args.seed)
        return 0

    # -- phase 2: kernels vs plain on the card -------------------------------
    results = {}  # kernel name -> dict(max_abs_err, ms, plain_ms, bound_ms, bound_by)
    max_abs_err = 0.0
    bs = boundaries(3000, N_POINTS)
    n_split = len(bs) + 1
    print(f"the tie case's 20,000 refs are split into {n_split} stretches for its 3,000 queries ({sms} SMs); "
          f"boundaries at {bs}")
    if n_split < 2:
        fail("the stretch-boundary case has no boundary")
    if not any(b % TIE_WINDOW and (b - 20) // TIE_WINDOW == (b + 19) // TIE_WINDOW for b in bs):
        fail("no stretch boundary of the tie case falls inside a tie window with both copies")
    for name, q_np, r_np, with_oracle, _ in nn_cases(PAD_COORD, True, boundaries):
        q = to_dev(q_np)
        prep = nn_argmin.prepare_nn_ref_argmin(to_dev(r_np))
        idx_k, sq_k = nn_argmin.nn_argmin_prepared(q, prep)
        torch.cuda.synchronize()
        if name.startswith("ties_across") and nn_search.last_stretches != n_split:
            fail(f"{name}: built for {n_split} stretches, the launch made {nn_search.last_stretches}")
        idx_p, sq_p = nn_argmin.nn_argmin_plain(q, prep)
        idx_k, sq_k, idx_p, sq_p = (t.cpu().numpy() for t in (idx_k, sq_k, idx_p, sq_p))
        n_idx = int((idx_k != idx_p).sum())
        err = float(np.abs(sq_k.astype(np.float64) - sq_p).max())
        n_bits = int((bits(sq_k) != bits(sq_p)).sum())
        max_abs_err = max(max_abs_err, err)
        msg = f"nn_argmin {name}: idx mismatches {n_idx}, sq bit mismatches {n_bits}, max|dsq| {err:.3g}"
        if with_oracle:
            idx_o, sq_o = lowest_index_oracle(q_np, r_np)
            n_o = int((idx_k != idx_o).sum()) + int((sq_k != sq_o).sum())
            msg += f", vs numpy lowest-index oracle {n_o}"
            if n_o:
                fail(msg)
        print(msg, flush=True)
        if n_idx or n_bits or not np.isfinite(sq_k).all():
            fail(msg)
    results["nn_argmin"] = {"max_abs_err": max_abs_err}

    small_cases = nn_cases(PAD_COORD, False, boundaries)
    max_abs_err = 0.0
    for name, q_np, r_np, _, _ in small_cases:
        q, r = to_dev(q_np), to_dev(r_np)
        idx_k, sq_k = nn_matmul.nn_matmul(q, r)
        torch.cuda.synchronize()
        idx_p, sq_p = nn_matmul.nn_matmul_plain(q, r)
        idx_k, sq_k, idx_p, sq_p = (t.cpu().numpy() for t in (idx_k, sq_k, idx_p, sq_p))
        n_idx = int((idx_k != idx_p).sum())
        err = float(np.abs(sq_k.astype(np.float64) - sq_p).max())
        n_bits = int((bits(sq_k) != bits(sq_p)).sum())
        max_abs_err = max(max_abs_err, err)
        live_r = r_np[:, 0] < 0.5 * PAD_COORD
        dead_won = int((~live_r[idx_k]).sum()) if live_r.any() else 0
        msg = (f"nn_matmul {name}: idx mismatches {n_idx}, sq bit mismatches {n_bits}, "
               f"max|dsq| {err:.3g}, dead refs chosen {dead_won}")
        print(msg, flush=True)
        if n_idx or n_bits or dead_won or not np.isfinite(sq_k).all():
            fail(msg)
    results["nn_matmul"] = {"max_abs_err": max_abs_err}

    # the main 20k pair: aux rows are the target's estimated normals
    src_np, tgt_np = surface(N_POINTS, 1), surface(N_POINTS, 0)
    tgt_cloud = estimate_normals(PointCloud.from_numpy(tgt_np, device=dev), k=12)
    tgt_xyz, tgt_nrm = tgt_cloud.padded_xyz()[:N_POINTS], tgt_cloud.channel("normal")[:N_POINTS]
    rng = np.random.default_rng(5)
    tq, tr, taux, twant = tie_case()
    dq, dr = rng.uniform(-2, 2, (300, 3)).astype(np.float32), np.full((100, 3), PAD_COORD, np.float32)
    daux = rng.normal(size=dr.shape).astype(np.float32)
    for dist in nn_gather.DIST_MODES:
        max_abs_err = 0.0
        cases = [(n, q, r, None if n.startswith("main_path") else rng.normal(size=r.shape).astype(np.float32), ties)
                 for n, q, r, _, ties in small_cases]
        cases.append(("ties_in_and_across_windows_2000x2011", tq, tr, taux, True))
        cases.append(("all_refs_dead_300x100", dq, dr, daux, True))
        for name, q_np, r_np, aux_np, ties in cases:
            q = to_dev(q_np)
            if aux_np is None:
                rt, nt = nn_gather.prepare_nn_ref(tgt_xyz, tgt_nrm)
            else:
                rt, nt = nn_gather.prepare_nn_ref(to_dev(r_np), to_dev(aux_np))
            out_k = nn_gather.nn_gather_prepared(q, rt, nt, dist=dist)
            torch.cuda.synchronize()
            if name.startswith("ties_across") and nn_search.last_stretches != n_split:
                fail(f"nn_gather[{dist}] {name}: built for {n_split} stretches, the launch made "
                     f"{nn_search.last_stretches}")
            out_p = nn_gather.nn_gather_plain(q, rt, nt, dist)
            sq_k, qs_k, ns_k, sq_p, qs_p, ns_p = (t.cpu().numpy() for t in (*out_k, *out_p))
            n_bits = int((bits(sq_k) != bits(sq_p)).sum())
            err = float(np.abs(sq_k.astype(np.float64) - sq_p).max())
            max_abs_err = max(max_abs_err, err)
            # a dead query (-PAD_COORD) is ~1e8 from every live ref, where f32
            # d2 steps by ~2e9: it ties with many refs, like a duplicate
            live_q = q_np[:, 0] > -0.5 * PAD_COORD
            n_rows = int(((qs_k != qs_p) | (ns_k != ns_p)).any(1)[live_q].sum())
            tol_q = 8 * EPS * max(1.0, float(np.abs(qs_p).max()))
            tol_n = 8 * EPS * max(1.0, float(np.abs(ns_p).max()))
            d_q, d_n = float(np.abs(qs_k - qs_p).max()), float(np.abs(ns_k - ns_p).max())
            msg = (f"nn_gather[{dist}] {name}: sq bit mismatches {n_bits}, max|dsq| {err:.3g}, live rows with "
                   f"unequal gathered values {n_rows}, max|dq_sel| {d_q:.3g} (tol {tol_q:.3g}), "
                   f"max|dn_sel| {d_n:.3g} (tol {tol_n:.3g})")
            if name.startswith("ties_in") and dist != "mxu_fast":
                d_hand = float(np.abs(ns_k[:200] - twant).max())
                msg += f", vs tie averages by hand {d_hand:.3g}"
                if d_hand > tol_n or (qs_k[:200] != q_np[:200]).any():
                    fail(msg)
            if name.startswith("ties_across") and dist != "mxu_fast":
                # query 20 k + m sits on ref b - 20 + m, copied to b + m across
                # boundary k, in the same tie window: their aux rows averaged
                n_on = 20 * len(bs)
                want = np.concatenate([(aux_np[b - 20 : b] + aux_np[b : b + 20]) / 2 for b in bs])
                d_hand = float(np.abs(ns_k[:n_on] - want).max())
                msg += f", vs tie averages across {len(bs)} stretch boundaries by hand {d_hand:.3g}"
                if d_hand > tol_n or (qs_k[:n_on] != q_np[:n_on]).any():
                    fail(msg)
            if name.startswith("all_refs_dead"):
                # 100 dead refs tie; in vpu mode the 412 padding refs of the
                # window too, with aux 0 (the JAX package's padding)
                want = aux_np.sum(0) / (TIE_WINDOW if dist == "vpu" else len(r_np))
                d_hand = float(np.abs(ns_k - want).max())
                msg += f", vs the dead refs' average by hand {d_hand:.3g}"
                if d_hand > tol_n or float(np.abs(qs_k - PAD_COORD).max()) > tol_q:
                    fail(msg)
            print(msg, flush=True)
            if n_bits or d_q > tol_q or d_n > tol_n or (n_rows and not ties) or not np.isfinite(sq_k).all():
                fail(msg)
        results[f"nn_gather:{dist}"] = {"max_abs_err": max_abs_err}

    # times at 20k x 20k, alternating turns, and the bounds
    q = to_dev(src_np)
    prep = nn_argmin.prepare_nn_ref_argmin(tgt_xyz)
    rt, nt = nn_gather.prepare_nn_ref(tgt_xyz, tgt_nrm)
    timed = {
        "nn_argmin": (lambda: nn_argmin.nn_argmin_prepared(q, prep),
                      lambda: nn_argmin.nn_argmin_plain(q, prep), 4 * (3 + 3 + 2) * N_POINTS),
        "nn_matmul": (lambda: nn_matmul.nn_matmul(q, tgt_xyz),
                      lambda: nn_matmul.nn_matmul_plain(q, tgt_xyz), 4 * (3 + 3 + 2) * N_POINTS),
    }
    for dist in nn_gather.DIST_MODES:
        timed[f"nn_gather:{dist}"] = (
            lambda d=dist: nn_gather.nn_gather_prepared(q, rt, nt, dist=d),
            lambda d=dist: nn_gather.nn_gather_plain(q, rt, nt, d), 4 * (3 + 6 + 7) * N_POINTS)
    for name, (kernel_fn, plain_fn, bytes_moved) in timed.items():
        ms, p_ms, kern, plain = time_turns(torch, kernel_fn, plain_fn)  # the last turn is the kernel's
        b_ms, b_by, before_ms = bound_ms(name, N_POINTS, N_POINTS, bytes_moved, sm_clock_hz)
        results[name].update(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                             stretches=nn_search.last_stretches)
        stretches = f"{nn_search.last_stretches} ref stretches, "
        print(f"{name} 20000x20000: {stretches}kernel {ms:.4f} ms (turns {[round(x, 4) for x in kern]}), "
              f"plain {p_ms:.4f} ms (turns {[round(x, 4) for x in plain]}), bound {b_ms:.4f} ms by {b_by} "
              f"({b_ms / ms:.3f} of the kernel's time [{before_ms / ms:.3f} by the earlier count of "
              f"{SLOTS_PER_PAIR_BEFORE[name]} slots a pair]; bytes alone "
              f"{1e3 * bytes_moved / HBM_BYTES_PER_S:.5f} ms) [{smi}]", flush=True)

    # nn_argmin at the main path's other shapes, where the launch geometry
    # differs: a tracker sweep against a full-capacity map, a quarter of it
    # dead rows (stretches that are no multiple of the ref tile), and nn_1nn's
    # brute engine.  Held against the plain version first, then timed alone.
    map_np = surface(65_536, 7)
    map_np[49_152:] = PAD_COORD
    big_tgt_np, big_src_np, big_nrm_np = big_pair()
    results["nn_argmin"]["shapes"] = {}
    for label, q_np, r_np, reps in (("20000x65536", src_np, map_np, 50), (f"{N_BIG}x{N_BIG}", big_src_np, big_tgt_np, 5)):
        qs, preps = to_dev(q_np), nn_argmin.prepare_nn_ref_argmin(to_dev(r_np))
        idx_k, sq_k = nn_argmin.nn_argmin_prepared(qs, preps)
        n_str = nn_search.last_stretches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx_p, sq_p = nn_argmin.nn_argmin_plain(qs, preps)
        n_idx, n_bits = int((idx_k != idx_p).sum()), int((sq_k.view(torch.int32) != sq_p.view(torch.int32)).sum())
        err = float((sq_k.double() - sq_p.double()).abs().max())
        plain_s = time.perf_counter() - t0
        results["nn_argmin"]["max_abs_err"] = max(results["nn_argmin"]["max_abs_err"], err)
        msg = (f"nn_argmin {label}: idx mismatches {n_idx}, sq bit mismatches {n_bits}, max|dsq| {err:.3g} "
               f"(plain version once: {plain_s:.2f} s wall)")
        print(msg, flush=True)
        if n_idx or n_bits or not bool(torch.isfinite(sq_k).all()):
            fail(msg)
        del idx_p, sq_p
        turns = [event_ms(torch, lambda: nn_argmin.nn_argmin_prepared(qs, preps), reps) for _ in range(3)]
        ms = statistics.median(turns)
        b_ms, b_by, before_ms = bound_ms("nn_argmin", len(q_np), len(r_np),
                                         4 * (3 * len(q_np) + 3 * len(r_np) + 2 * len(q_np)), sm_clock_hz)
        if nn_search.last_stretches != n_str:
            fail(f"nn_argmin {label}: {n_str} stretches when checked, {nn_search.last_stretches} when timed")
        results["nn_argmin"]["shapes"][label] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, stretches=n_str)
        print(f"nn_argmin {label}: {n_str} ref stretches, kernel {ms:.4f} ms (turns {[round(x, 4) for x in turns]}), "
              f"bound {b_ms:.4f} ms by {b_by} ({b_ms / ms:.3f} of the kernel's time [{before_ms / ms:.3f} by the "
              f"earlier count of {SLOTS_PER_PAIR_BEFORE['nn_argmin']} slots a pair]) [{smi}]", flush=True)

    launches = {name: {} for name in results}  # kernel -> {path: count}

    # -- phase 3: the registration path ----------------------------------------
    scans, steps = make_chain(se3_exp, torch)
    with tempfile.TemporaryDirectory() as td:
        paths = [f"{td}/scan{k}.pcd" for k in range(N_SCANS)]
        for p, s in zip(paths, scans):
            save_pcd(p, {"xyz": s})
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = icp_register.main(paths + ["--json", "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        n_launch = launches["nn_argmin"]["icp_register"] = nn_argmin.launches
        clouds = [load_pcd(p, device=dev) for p in paths]
    out = json.loads(buf.getvalue())
    pairs = N_SCANS - 1
    Ts = np.asarray(out["pairwise"], np.float64)
    traj = np.asarray(out["trajectory"], np.float64)
    errs = np.linalg.norm(Ts - steps, axis=(1, 2))
    print(f"icp_register main(): rc {rc}, {cli_s:.3f} s wall for {N_SCANS} scans "
          f"(load + {pairs} pairs + pose graph, first call), kernel launches {n_launch}")
    print(f"pairwise |T - T_true|_F: {[float(f'{e:.3g}') for e in errs]} (bound {T_TOL})")
    if rc != 0:
        fail(f"icp_register returned {rc}")
    if Ts.shape != (pairs, 4, 4) or traj.shape != (N_SCANS, 4, 4) or not np.isfinite(traj).all():
        fail(f"bad output: pairwise {Ts.shape}, trajectory {traj.shape}, finite {np.isfinite(traj).all()}")
    if errs.max() >= T_TOL:
        fail(f"ICP did not converge: max |T - T_true|_F = {errs.max()}")
    if n_launch < pairs * ICP_ITERS:
        fail(f"icp_register launched the kernel {n_launch} times, expected >= {pairs * ICP_ITERS}")

    # per-pair wall time, warm: host clock around work that ends in a sync
    for k in range(pairs):
        src, tgt = clouds[k + 1], clouds[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tgt_n = estimate_normals(tgt, k=12)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = icp_point_to_plane(src.padded_xyz(), src.mask, tgt.padded_xyz(), tgt.mask,
                                 tgt_n.channel("normal"), iters=ICP_ITERS)
        res.transform.cpu()
        t2 = time.perf_counter()
        print(f"pair {k}: {1e3 * (t2 - t0):.2f} ms wall (normals k=12 {1e3 * (t1 - t0):.2f} ms, "
              f"ICP {ICP_ITERS} sweeps {1e3 * (t2 - t1):.2f} ms) [{smi}]")

    # a small pair on the CPU (plain version) and on the card (kernel)
    small_tgt, small_src = scans[0][:2000], scans[1][:2000]
    Tsmall = []
    for d in ("cpu", "cuda"):
        tgt = estimate_normals(PointCloud.from_numpy(small_tgt, device=d), k=12)
        res = icp_point_to_plane(
            torch.from_numpy(small_src).to(d), torch.ones(len(small_src), dtype=torch.bool, device=d),
            tgt.padded_xyz(), tgt.mask, tgt.channel("normal"), iters=ICP_ITERS)
        Tsmall.append(res.transform.cpu().numpy())
    d_small = float(np.abs(Tsmall[0] - Tsmall[1]).max())
    print(f"small pair (2000 points): max |T_cpu - T_cuda| = {d_small:.3g} (bound {SMALL_TOL})")
    if d_small >= SMALL_TOL:
        fail(f"CPU and card disagree on a small pair: {d_small}")

    # -- phase 4: the NN layer's other entry points ------------------------------
    # one ICP sweep's correspondences on the 20k pair, as a caller asks for
    # them; nn_argmin + two gathers is what the registration path does
    def residual_rms(p, q_sel, n_sel):
        return float(torch.sqrt(torch.mean(torch.sum(n_sel * (p - q_sel), dim=-1) ** 2)))

    reset_counts()
    idx_a, sq_a = nn_argmin.nn_argmin_prepared(q, nn_argmin.prepare_nn_ref_argmin(tgt_xyz))
    q_a, n_a = tgt_xyz[idx_a.long()], tgt_nrm[idx_a.long()]
    rms = {"nn_argmin": residual_rms(q, q_a, n_a)}
    idx_m, _ = nn_matmul.nn_matmul(q, tgt_xyz)
    launches["nn_matmul"]["ops.nn_matmul"] = nn_matmul.launches
    rms["nn_matmul"] = residual_rms(q, tgt_xyz[idx_m.long()], tgt_nrm[idx_m.long()])
    for dist in nn_gather.DIST_MODES:
        before = nn_gather.launches
        sq_g, q_g, n_g = nn_gather.nn_gather(q, tgt_xyz, tgt_nrm, dist=dist)
        launches[f"nn_gather:{dist}"]["ops.nn_gather"] = nn_gather.launches - before
        rms[f"nn_gather:{dist}"] = residual_rms(q, q_g, n_g)
        if dist == "vpu":
            n_bad = int((sq_g != sq_a).sum() + (q_g != q_a).any(1).sum() + (n_g != n_a).any(1).sum())
            print(f"nn_gather[vpu] vs nn_argmin + gathers on the 20k pair: {n_bad} unequal rows")
            if n_bad:
                fail("nn_gather(dist='vpu') disagrees with what the registration path gathers")
    torch.cuda.synchronize()
    launches["nn_argmin"]["ops cross-check"] = nn_argmin.launches
    print(f"one sweep's point-to-plane RMS residual by entry point: "
          f"{ {k: float(f'{v:.6g}') for k, v in rms.items()} }")
    for k, v in rms.items():
        exact = k != "nn_gather:mxu_fast"
        if not np.isfinite(v) or (exact and abs(v - rms["nn_argmin"]) > 1e-3 * rms["nn_argmin"]):
            fail(f"{k}: RMS residual {v} against {rms['nn_argmin']} from the exact path")
    # q_g is mxu_fast's gathered point here, the last mode of the loop
    excess = torch.sum((q - q_g) ** 2, dim=-1) - sq_a
    bf16_bound = 2.0 ** -5 * torch.linalg.norm(q, dim=-1) * torch.linalg.norm(q_g, dim=-1) + 1e-5
    worst = float((excess / bf16_bound).max())
    print(f"nn_gather[mxu_fast]: largest excess squared distance over the bf16 bound: {worst:.3g} (must be <= 1)")
    if not worst <= 1.0:
        fail("nn_gather(dist='mxu_fast') picked a point beyond the bf16 bound")
    for name in ("nn_matmul", *(f"nn_gather:{d}" for d in nn_gather.DIST_MODES)):
        if sum(launches[name].values()) < 1:
            fail(f"{name}: its entry point did not launch the kernel")

    # -- phase 5: the front door and tiled ICP at 200k ----------------------------
    big_tgt, big_src, big_nrm = to_dev(big_tgt_np), to_dev(big_src_np), to_dev(big_nrm_np)
    ones = torch.ones(N_BIG, dtype=torch.bool, device=dev)
    reset_counts()
    walls, nn_out = {}, {}
    for engine in ("compact", "brute", "compact", "brute"):  # second turn of each is warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        i_e, s_e = nn_1nn(big_src, ones, big_tgt, ones, radius=BIG_RADIUS, engine=engine)
        torch.cuda.synchronize()
        walls.setdefault(engine, []).append(1e3 * (time.perf_counter() - t0))
        nn_out[engine] = (i_e.cpu().numpy(), s_e.cpu().numpy())
    launches["nn_argmin"]["nn_1nn brute 200k"] = nn_argmin.launches
    (i_c, s_c), (i_b, s_b) = nn_out["compact"], nn_out["brute"]
    n_sq = int((bits(s_c) != bits(s_b)).sum())
    differ = i_c != i_b
    # rows whose indices differ must be exact ties: both engines report the
    # same d², and each index's own distance is that d²
    d_c = ((big_src_np[differ] - big_tgt_np[i_c[differ]]) ** 2).sum(1)
    d_b = ((big_src_np[differ] - big_tgt_np[i_b[differ]]) ** 2).sum(1)
    n_untied = int((np.abs(d_c - d_b) > 1e-9).sum()) if differ.any() else 0
    found = int((i_b >= 0).sum())
    beyond_ok = bool(np.isinf(s_b[i_b < 0]).all() and (s_b[i_b >= 0] <= np.float32(BIG_RADIUS) ** 2).all())
    print(f"nn_1nn {N_BIG}x{N_BIG} radius {BIG_RADIUS}: compact {walls['compact'][1]:.2f} ms warm "
          f"({walls['compact'][0]:.2f} first), brute {walls['brute'][1]:.2f} ms warm ({walls['brute'][0]:.2f} "
          f"first), wall with sync; sq bit mismatches {n_sq}, index differences {int(differ.sum())} of which "
          f"untied {n_untied}, matched {found} [{smi}]", flush=True)
    if n_sq or n_untied or not beyond_ok or found < 0.99 * N_BIG:
        fail("nn_1nn: the compact and brute engines disagree at 200k")

    xi_big = torch.tensor([0.02, -0.015, 0.01, 0.004, -0.003, 0.005])
    T_big = se3_exp(xi_big).numpy().astype(np.float64)
    moved = ((big_src_np.astype(np.float64) - T_big[:3, 3]) @ T_big[:3, :3]).astype(np.float32)
    moved_d = to_dev(moved)
    icp_walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = icp_point_to_plane_tiled(moved_d, ones, big_tgt, ones, big_nrm, tile_size=BIG_RADIUS,
                                       cap_per_cell=128, iters=6)
        T_got = res.transform.cpu().numpy()
        icp_walls.append(1e3 * (time.perf_counter() - t0))
    per_iter = res.per_iter_rmse.cpu().numpy()
    err_big = float(np.linalg.norm(T_got - T_big))
    n_corr = int(res.num_corr)
    print(f"icp_point_to_plane_tiled {N_BIG} points, 6 sweeps, tile {BIG_RADIUS}: {icp_walls[1]:.2f} ms warm "
          f"({icp_walls[0]:.2f} first), |T - T_true|_F {err_big:.3g}, num_corr {n_corr}, "
          f"per-sweep RMSE {[float(f'{v:.4g}') for v in per_iter]} [{smi}]", flush=True)
    if not np.isfinite(T_got).all() or err_big >= 0.01 or n_corr <= 0.9 * N_BIG or not per_iter[-1] < per_iter[0]:
        fail("tiled ICP at 200k did not converge")

    # -- phase 6: the mapping loop ---------------------------------------------
    poses, map_scans = zip(*(map_scan(k, se3_exp, torch) for k in range(N_MAP_SCANS)))
    with tempfile.TemporaryDirectory() as td:
        paths = [f"{td}/scan{k}.pcd" for k in range(N_MAP_SCANS)]
        for p, scan in zip(paths, map_scans):
            save_pcd(p, {"xyz": scan})
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = build_map.main(paths + ["--json", "--relax", "--device", "cuda"])
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
        n_launch = launches["nn_argmin"]["build_map"] = nn_argmin.launches
        clouds = [load_pcd(p, capacity_bucket=2048, device=dev) for p in paths]
    out = json.loads(buf.getvalue())
    traj = np.asarray(out["trajectory"], np.float64)
    t_errs = np.linalg.norm(traj[:, :3, 3] - np.stack(poses)[:, :3, 3], axis=1)
    print(f"build_map main(): rc {rc}, {map_s:.3f} s wall for {N_MAP_SCANS} scans (load + normals + track + "
          f"relax, first call), keyframes {out['keyframes']}, map_points {out['map_points']}, "
          f"nn_argmin launches {n_launch}")
    print(f"translation error per scan: {[float(f'{e:.3g}') for e in t_errs]} (final bound {MAP_T_TOL})")
    if rc != 0:
        fail(f"build_map returned {rc}")
    if traj.shape != (N_MAP_SCANS, 4, 4) or not np.isfinite(traj).all():
        fail(f"bad trajectory: {traj.shape}")
    if t_errs[-1] >= MAP_T_TOL or out["keyframes"] < 2 or out["map_points"] <= 20_000:
        fail(f"mapping loop off: final error {t_errs[-1]}, keyframes {out['keyframes']}, "
             f"map_points {out['map_points']}")
    if n_launch < (N_MAP_SCANS - 1) * MAP_ICP_ITERS:
        fail(f"build_map launched nn_argmin {n_launch} times, expected >= {(N_MAP_SCANS - 1) * MAP_ICP_ITERS}")

    # per-scan wall time, warm (the CLI's configuration)
    tracker = ScanToMapTracker(TrackerConfig(icp_iters=MAP_ICP_ITERS), device=dev)
    for k, cloud in enumerate(clouds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cloud = estimate_normals(cloud, k=12)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, kf = tracker.track(cloud.padded_xyz(), cloud.channel("normal"), cloud.mask)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"scan {k}: {1e3 * (t2 - t0):.2f} ms wall (normals k=12 {1e3 * (t1 - t0):.2f} ms, track "
              f"{1e3 * (t2 - t1):.2f} ms{', keyframe' if kf else ''}) [{smi}]")

    # -- phase 7: the tabletop slice -------------------------------------------
    phase_tabletop(torch, dev, smi, args.seed)

    kernels = []
    for name, r in results.items():
        source, replaces = KERNEL_FILES[name.split(":")[0]]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(launches[name].values()), launches_by_path=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None, stretches=r["stretches"],
            **({"shapes": r["shapes"]} if "shapes" in r else {})))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
