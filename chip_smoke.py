#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mapping_private_tpu_torch).

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Card and build: the card's name and power limit from nvidia-smi, then
   all five kernels (nn_argmin, nn_matmul, nn_gather, knn_kbest, icp_gn) built from csrc/
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
   knn_kbest (the denoise's k smallest distances) against its plain
   version bit for bit: phase 7's frame through the pipeline's box (~97,200
   live of 307,200 rows) at k = 20, 1 and K_MAX, and ragged sizes at every
   edge of its buckets, n at or below k included; then its time and the
   plain version's at the frame, k = 20, beside the bound (9 FP32 slots a
   pair: the distance and one compare against the k-th best).
3. The registration path: a chain of 4 synthetic 20,000-point scans
   (bench.py's surface and step sizes) written as PCD files and registered
   with ``mapping_private_tpu_torch.apps.icp_register.main([... "--device",
   "cuda"])``.  Every pairwise transform must be within 0.05 (Frobenius) of
   the truth, the trajectory finite, the kernel launched at least
   pairs x sweeps times by that run and ICP's GN kernel taken in every
   sweep.  Then per-pair wall times (normals + ICP), and the same small
   pair registered on the CPU (plain version) and on the card (kernel),
   which must agree within 1e-4.  Then ICP's GN kernel (csrc/icp_gn.cu)
   against its plain version, both on the card, at scans 1 and 2 of the
   scan20k ring: transforms within 2e-6 (Frobenius) after 20 sweeps, the
   count equal, the per-sweep RMSE within 1e-5 relative, one
   ``icp_gn.launches`` a sweep; then one sweep's apply, partial sums and
   solve timed alone (us) beside nn_argmin and the plain GN sweep.
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
   truth, more than 0.9 N correspondences, RMSE falling.  Then the dense
   lattice: ``nn_1nn(engine="lattice")`` against the compact engine (d² bit
   for bit, indices equal where untied; both wall times and the lattice
   call's peak memory), and two more ICP modes held against that compact
   run (transform within 1e-5, the same correspondence count; wall times):
   ``icp_point_to_plane(nn_backend="tiled", max_tiles=0)`` on the lattice
   ``size_tiled_lattice`` sizes, and ``icp_point_to_plane_tiled(...,
   rebucket_sweeps=2)``.
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
8. The structural scenes, synthetic from ``--seed``, each with its wall
   time.  A 400,000-point scan of a 6 x 4 m room (floor, a ceiling at 2.8
   m, four walls, a 1.2 x 0.8 m table top at 0.75 m and a 0.5 x 0.4 x 1.8
   m cabinet against a wall; 2 mm noise; points in proportion to area)
   written as PCD and run through ``python -m
   mapping_private_tpu_torch.apps.room_segment`` with ``--out-labeled``
   and ``--out-filtered``: floor and ceiling counts equal to the points
   below 0.1 m and above 2.7 m, 4 walls each within 2 degrees and 0.02 m,
   the filtered cloud keeps the table top and the cabinet's front.  The
   room voxel-downsampled (0.042 m, under 65,536 rows), normals (k=12),
   ``fit_orientation_ransac`` (within 2 degrees of the room's axes) and
   ``region_grow`` (radius 0.05, 10 degree normal gate; the 6 largest
   regions 6 surfaces, each at least 95% on one).
   ``layered_reconstruction`` of a 100,000-point wall and cylinder (the box
   and the cylinder found, as tests/test_layered.py asserts).
   ``detect_table_sr`` and ``split_table_detection`` on a 176 x 144
   organized frame (tests/test_table_detector_sr.py's box on a table):
   the table found within 0.02 m of its height, the box as one object.
   ``triangulate_depth_image`` on that frame and a 640 x 480 one (no
   valid edge beyond 0.05 m).  ``fit_rotational_ransac`` on a 20,000-point
   vase.  ``apps.cloud_ops`` transform (and back, within 1e-5), crop (the
   band's rows exactly), denoise (the 1,000 injected outliers dropped),
   project and concat (rows add up) on phase 7's frame.

9. Object recognition and classification (no NN kernel lies on it),
   synthetic from ``--seed``.  Phase 7's frame coloured by surface (the
   table top brown, the floor and the wall greys, box 1 red, box 2 green,
   the cylinders blue and yellow, +-10 of integer noise a channel) goes
   through ``python -m mapping_private_tpu_torch.apps.detect_object`` at
   the CLI's 1 cm voxels (a grid of some 17.6 million voxels): the
   learn-threshold, learn-scene (two frames of other seeds, 4 cm blocks)
   and learn-object (box 1's points cropped from five frames of other
   seeds, two turned 90 degrees about z) subcommands through the CLI's
   ``main``, then ``detect`` with ``--block-size 4``, ``--ranges`` box
   1's extent in the scene's 4 cm subdivisions (how many its points span)
   and ``--exist-threshold`` 0.8 of box 1's occupied voxels (at the
   default of 10 any sub-box of red voxels near-ties with the whole box),
   with and without ``--scene-pca``: the top box must contain box 1's
   centroid in both; the same commands with
   ``--device cpu`` (run alongside, on CPU_RUN_THREADS threads) must rank
   the same 5 boxes with scores within 1e-4.  Then the warm wall time of
   voxelize, colorchlac117_subdiv, build_scene_data and search_object and
   the peak device memory of a detect call.  On the committed 63-object
   corpus features (``tests/data_corpus_features_gr.npz``, 1,512 views):
   ``leave_one_out_subspace`` for r (rate above 0.85) and g (between 0.25
   and 0.75) and ``crossval_svm(n_folds=4)`` for r (above 0.80), the
   gates of tests/test_evaluation.py, each count beside the JAX
   package's (EVALUATION.md) with its wall time and whether the SVM
   trainer warned of max_iter.  Last, ``python -m
   mapping_private_tpu_torch.apps.classify rate --leave-one-out --feature
   r`` on a synthetic corpus written as PCD files (8 objects of distinct
   shape and colour, 24 views each of 2,000 points): a rate of at least
   0.9 on the card, and the CPU run's within one view of it.
10. The sharded steps (``mapping_private_tpu_torch.parallel``), synthetic
   from ``--seed``: the registration step on 16 pairs of 20,000 points
   (bench.py's batch), the brute and tiled map steps (tile 0.3, 2 sweeps)
   on a 20,000-point scan against a 1,048,576-point map of bench.py's
   surface, and 1,024-keyframe pose-graph passes (1,087 edges, 64 loop
   closures).  First one shard's search at the map step's shape,
   20,000 x 1,048,576, through nn_matmul bit for bit against its plain
   version, and its kernel time beside the bound.  Then each step twice,
   each timed over three warm calls: (a) over NCCL at one rank a card (in
   this process at world size 1), (b) on two gloo ranks spawned on cuda:0
   (NCCL refuses two ranks on one card; gloo's payloads go through host
   memory).  (b) must equal (a): correspondence counts equal, poses within
   1e-5.  The map steps within 1e-4 of an f64 reference (the same GN
   sweeps with a global brute NN, plain torch float64 on the card), the
   pose graph's err after the third pass below 1e-6 (printed beside the
   JAX dry run's 4.472e-09), nn_matmul launched by both runs.  Then
   ``dryrun_multichip(2, "gloo", "cuda")`` once (its err below 1e-6 too).
11. Hough segmentation: the points of phase 7's four objects (labels 1-4
   of its frame, about 5,700), table-relative.  ``hough_segment`` (the
   CLI's settings) and ``segment_by_voting`` on the card and on the CPU
   with the same uniforms (numpy, from the seed): the segments match one
   to one by kind, centroids within 1 cm; on the card
   ``hough_eval.match_scene`` against the four true objects matches at
   least as many, and as many with the right kind, as the JAX package
   does on the same cloud (``scripts/hough_reference_count.py``).  Then
   ``python -m mapping_private_tpu_torch.apps.hough_segment --json
   --marked --by-voting --sizes-out`` on the card and with ``--device
   cpu`` (alongside): the same segments, a marked cloud and a sizes
   table.  Wall times of each call, each round and the CLI.
12. The robot self-filter path (``mapping_private_tpu_torch.realtime``;
   no NN kernel lies on it) on one Kinect VGA frame, 640 x 480 at fx = fy
   = 525, synthetic from ``--seed``: a wall, the floor and phase 7's
   table top as box slabs with phase 7's boxes and cylinders as meshes,
   seen by a camera 1.3 m from the table, rendered with
   ``render_depth_mesh`` (within 1e-4 relative of a float64 ray cast of
   the same mesh at every pixel farther than 1 px from an edge, and
   ``io.mesh.virtual_view_depth`` equal); a 9-link arm (prismatic,
   revolute and fixed joints; box and cylinder primitives and a binary
   STL finger written here and read back by ``load_stl``, 10,192
   triangles) parsed by ``parse_urdf`` and rendered by
   ``render_robot_depth`` reaching over the table in the lower part of
   the view (card against the port on the CPU: hit masks differ on at
   most 0.01% of pixels, depth within 1e-5 relative); the measured
   frame, the nearer surface quantised to 1/8 px of disparity;
   ``background_subtract`` (every pixel where the robot is the visible
   surface cut, every cut pixel inside its silhouette);
   ``smooth_depth_image`` (5 iterations, every pixel inside its clamp
   interval, card within 1e-6 of the CPU), ``depth_to_cloud``,
   ``fast_normals_image``; ``multi_plane_ransac`` over all 307,200 rows
   (1,024 hypotheses, 6 planes, a 1 cm band, uniforms from numpy): the
   wall, floor and table top each matched by a plane within 2 degrees,
   its offset from the camera within 0.02 m, and its distance from the
   true surface, at the centroid of that surface's pixels among its
   inliers, within 5 mm; the CPU's planes
   within 1e-4, labels equal on 99.9%; ``segment_normal_image`` (card
   and CPU labels equal on 99.9%, the card's equal to scipy's exact
   components of the same "normals agree" graph, components and rounds
   printed);
   ``boxlist_ray_intersection`` at 640 x 480 against the 50 boxes of a
   100-entity semantic map written here (ids equal to the CPU's, depth
   within 1e-6; the empty list misses everywhere); VTK and DXF round trips
   of the robot mesh, ``sample_mesh_points`` on the finger (within 1e-5 m
   of its surface), a ``Pipeline`` of voxel grid, normals and box fit
   against the direct calls (within 1e-5 m: the voxel sums are atomic
   adds on the card), ``cluster_objects_on_racks`` card == CPU,
   a jlo round trip, and ``load_pcd`` of phase 7's ASCII frame through
   the native parser (within 1 ulp of numpy's parse, both parse times).
   First and warm wall times of each call, and the phase's stage times
   through ``utils.metrics.Metrics``.

``python3 chip_smoke.py --profile`` builds the kernels and then, instead
of phases 2-12, profiles with torch.profiler one warm pair of phase 3
(normals + 20 ICP sweeps), one warm tracker step of phase 6, phase 5's
tiled ICP call, phase 7's denoise of a frame and ``detect_table`` call,
phase 8's ``segment_room`` and ``detect_table_sr`` calls, and phase 9's
``detect`` of box 1 in the coloured frame and ``leave_one_out_subspace``
of the corpus's r features, phase 10's brute map step at world size 1
phase 11's ``hough_segment`` and phase 12's ``render_robot_depth``,
``multi_plane_ransac`` and ``segment_normal_image`` (device time by
kernel, launches, the device's idle share); it prints no result line.
``--seed N`` (default 0) makes the scenes of phases 7-12.

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
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO_ROOT = pathlib.Path(__file__).resolve().parent

N_POINTS = 20_000  # bench.py's scan size; the CLIs match the full cloud
N_SCANS = 4  # registration chain (phase 3)
ICP_ITERS = 20  # icp_register's default sweep count
T_TOL = 0.05  # |T - T_true|_F, the bound of bench.py's convergence check
SMALL_TOL = 1e-4  # CPU plain vs card kernel on a small pair
GN_T_TOL = 2e-6  # |T_kernel - T_plain|_F after 20 sweeps, ICP's GN kernel against its plain version on the card
GN_RMSE_RTOL = 1e-5  # per-sweep RMSE of the same two runs, relative
GN_SEED = 3190000001  # the scan20k ring whose scans 1 and 2 make the GN check's pair
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

N_ROOM = 400_000  # a room scan (phase 8)
ROOM = (6.0, 4.0, 2.8)  # x, y extent and ceiling height; walls at x = 0, 6 and y = 0, 4
ROOM_NOISE = 0.002
ROOM_TABLE = ((2.4, 3.6), (1.6, 2.4), 0.75)  # the 1.2 x 0.8 m table top: x range, y range, height
ROOM_CABINET = ((1.0, 1.5), (3.6, 4.0), 1.8)  # 0.5 x 0.4 x 1.8 m, its back against the wall y = 4
ROOM_VOXEL = 0.042  # room downsample for orientation and region growing (< 65,536 voxels)
ROOM_DOWN_CAP = 65_536
N_LAYERED = 100_000  # tests/test_layered.py's wall and cylinder, more points
N_VASE = 20_000  # tests/test_fit_models.py's vase, more points
SR_SHAPE = (144, 176)  # a SwissRanger frame, rows x columns (table_object_detector_sr.cpp:72-73)
VGA_SHAPE = (480, 640)
SR_VIEW = (-0.7, 0.0, 1.7)  # tests/test_table_detector_sr.py's oblique viewpoint
SR_BOX = ((0.05, -0.20, 0.75), (0.45, 0.20, 0.95))  # the 20 cm box on the table at z = 0.75
N_OUTLIERS = 1_000  # injected into phase 7's frame for the cloud_ops denoise
N_REG_PAIRS = 16  # bench.py's BATCH_PAIRS: the sharded registration step's pairs (phase 10)
N_MAP = 1 << 20  # the sharded map steps' map (the JAX docstring's 64k-1M points a device)
MAP_TILE = 0.3  # the tiled map step's tile, as in the JAX dry run
MAP_SWEEPS = 2  # the tiled map step's GN sweeps, as in the JAX dry run
PG_KEYFRAMES = 1024  # the pose graph of the JAX dry run: E = 1,087 edges, 64 loop closures
JAX_DRYRUN_PG_ERR = 4.472e-09  # MULTICHIP_r05.json: the JAX dry run's err after 3 passes (a CPU virtual mesh)
SHARDED_TOL = 1e-5  # phase 10: the two-rank run against the NCCL run
F64_TOL = 1e-4  # phase 10: the map steps against the f64 reference
HOUGH_DRAWS = 8  # phase 11: (line, circle) uniform pairs drawn, more than any run uses
# The JAX package's matches on phase 11's cloud (seed 0), of 4 true objects:
# JAX_PLATFORMS=cpu python3 scripts/hough_reference_count.py --seed 0
JAX_HOUGH_MATCHES = {"hough_segment": {"detected": 4, "kind_correct": 2},
                     "segment_by_voting": {"detected": 4, "kind_correct": 2}}

# H100 SXM: SMs x FP32 lanes; bytes/s of HBM3 (NVIDIA's data sheet)
SM_LANES = 132 * 128
HBM_BYTES_PER_S = 3.35e12
# FP32 issue slots per query-ref pair that the function itself needs: the
# distance (direct differences: 3 sub + 3 mul + 2 add; expansion form: 3 mul
# + 3 add + 1 fma) and one min, since the least of N numbers takes N - 1 of
# them.  The index, the ties and the gather are per query, not per pair.
SLOTS_PER_PAIR = {"nn_argmin": 9, "nn_matmul": 8, "nn_gather:vpu": 9,
                  "nn_gather:mxu": 8, "nn_gather:mxu_fast": 8, "knn_kbest": 9}
# Until the kernels' redesign the bound counted a compare and a select per
# pair in place of the min (what the first loops issued); shares by that
# count are printed in brackets beside the new ones, to compare with
# earlier records.
SLOTS_PER_PAIR_BEFORE = {name: n + 1 for name, n in SLOTS_PER_PAIR.items()}
KERNEL_FILES = {
    "icp_gn": ("mapping_private_tpu_torch/csrc/icp_gn.cu",
               "none: the sweep's GN work, which XLA fuses (mapping_private_tpu/registration/icp.py::_gn_from_corr)"),
    "nn_argmin": ("mapping_private_tpu_torch/csrc/nn_argmin.cu", "mapping_private_tpu/ops/pallas_nn.py:245"),
    "nn_matmul": ("mapping_private_tpu_torch/csrc/nn_matmul.cu", "mapping_private_tpu/ops/pallas_nn.py:38"),
    "nn_gather": ("mapping_private_tpu_torch/csrc/nn_gather.cu", "mapping_private_tpu/ops/pallas_nn.py:110"),
    "knn_kbest": ("mapping_private_tpu_torch/csrc/knn_kbest.cu",
                  "none: the denoise's dense top_k (mapping_private_tpu/ops/neighbors.py::knn_bruteforce)"),
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


def tabletop_frame(seed: int, shift=(0.0, 0.0), labels: bool = False):
    """Phase 7's frame: N_TABLE points on the table top (2 mm noise), the
    objects of TABLE_OBJECTS, the floor (3 x 3 m at z = 0) and a wall (x =
    1.4, 3 m wide, 2 m high), each surface's share of the points in
    proportion to its area, all moved by ``shift`` in x, y.  Returns (xyz
    (N_TABLE, 3) float32 shuffled, [(kind, centroid of the object's
    points)]), and with ``labels`` each point's surface as a third item
    (0 the table top, 1-4 the objects in TABLE_OBJECTS' order, 5 the
    floor, 6 the wall)."""
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
    order = rng.permutation(N_TABLE)
    if labels:
        return xyz[order].astype(np.float32), truth, np.repeat(np.arange(len(counts)), counts)[order]
    return xyz[order].astype(np.float32), truth


HOUGH_CFG = dict(max_objects=5, min_inliers=80)  # the hough_segment CLI's defaults (phase 11)


def hough_cloud(seed: int):
    """Phase 11's cloud: the points of phase 7's four objects (labels 1-4 of
    ``tabletop_frame(seed)``), table-relative (z - TABLE_Z), and the four
    true objects as ``hough_eval.GroundTruthObject`` fields (kind, the
    centroid of the object's points, size, the short size class of all
    four)."""
    xyz, truth, lab = tabletop_frame(seed, labels=True)
    keep = (lab >= 1) & (lab <= 4)
    rel = (xyz[keep] - np.float32([0.0, 0.0, TABLE_Z])).astype(np.float32)
    gts = []
    for k, ((kind, cx, cy, size), (_, centroid)) in enumerate(zip(TABLE_OBJECTS, truth)):
        c = np.asarray(centroid, np.float64) - [0.0, 0.0, TABLE_Z]
        if kind == "box":
            gts.append(dict(name=f"box{k}", kind="cuboid", centroid=c, size_class="short",
                            extents=np.asarray(size, np.float64), height=size[2]))
        else:
            gts.append(dict(name=f"cylinder{k}", kind="cylinder", centroid=c, size_class="short",
                            radius=size[0], height=size[1]))
    return rel, gts


def room_surfaces():
    """The room of phase 8 as named lists of axis-aligned rectangles
    (fixed axis, its value, (axis, lo, hi), (axis, lo, hi)): floor,
    ceiling, four walls, the table top and the cabinet's front, sides and
    top.  The floor under the cabinet and the wall behind it are hidden."""
    X, Y, Z = ROOM
    (tx0, tx1), (ty0, ty1), tz = ROOM_TABLE
    (cx0, cx1), (cy0, cy1), cz = ROOM_CABINET
    return {
        "floor": [(2, 0.0, (0, 0, X), (1, 0, cy0)), (2, 0.0, (0, 0, cx0), (1, cy0, Y)),
                  (2, 0.0, (0, cx1, X), (1, cy0, Y))],
        "ceiling": [(2, Z, (0, 0, X), (1, 0, Y))],
        "wall x=0": [(0, 0.0, (1, 0, Y), (2, 0, Z))],
        "wall x=6": [(0, X, (1, 0, Y), (2, 0, Z))],
        "wall y=0": [(1, 0.0, (0, 0, X), (2, 0, Z))],
        "wall y=4": [(1, Y, (0, 0, cx0), (2, 0, Z)), (1, Y, (0, cx1, X), (2, 0, Z)),
                     (1, Y, (0, cx0, cx1), (2, cz, Z))],
        "table top": [(2, tz, (0, tx0, tx1), (1, ty0, ty1))],
        "cabinet front": [(1, cy0, (0, cx0, cx1), (2, 0, cz))],
        "cabinet side x=1.0": [(0, cx0, (1, cy0, cy1), (2, 0, cz))],
        "cabinet side x=1.5": [(0, cx1, (1, cy0, cy1), (2, 0, cz))],
        "cabinet top": [(2, cz, (0, cx0, cx1), (1, cy0, cy1))],
    }


def _rect_area(r):
    return (r[2][2] - r[2][1]) * (r[3][2] - r[3][1])


def room_scan(seed: int):
    """N_ROOM points on the room's surfaces, each surface's share in
    proportion to its area, ROOM_NOISE along its normal.  Returns (xyz
    (N_ROOM, 3) float32 shuffled, surface index per point)."""
    rng = np.random.default_rng(seed)
    rects = [(i, r) for i, rs in enumerate(room_surfaces().values()) for r in rs]
    areas = np.array([_rect_area(r) for _, r in rects])
    counts = np.floor(N_ROOM * areas / areas.sum()).astype(int)
    counts[0] += N_ROOM - counts.sum()
    parts, labels = [], []
    for (i, (ax, v, (ua, u0, u1), (va, v0, v1))), n in zip(rects, counts):
        p = np.empty((n, 3))
        p[:, ax] = v + rng.normal(0, ROOM_NOISE, n)
        p[:, ua] = rng.uniform(u0, u1, n)
        p[:, va] = rng.uniform(v0, v1, n)
        parts.append(p)
        labels.append(np.full(n, i))
    perm = rng.permutation(N_ROOM)
    return np.concatenate(parts)[perm].astype(np.float32), np.concatenate(labels)[perm]


def room_surface_of(xyz: np.ndarray) -> np.ndarray:
    """The surface index of the room rectangle nearest each point (an
    oracle of the scene, independent of the code under test)."""
    best = np.full(len(xyz), np.inf)
    out = np.zeros(len(xyz), int)
    for i, rs in enumerate(room_surfaces().values()):
        for ax, v, (ua, u0, u1), (va, v0, v1) in rs:
            du = np.maximum(0, np.maximum(u0 - xyz[:, ua], xyz[:, ua] - u1))
            dv = np.maximum(0, np.maximum(v0 - xyz[:, va], xyz[:, va] - v1))
            d = (xyz[:, ax] - v) ** 2 + du**2 + dv**2
            out = np.where(d < best, i, out)
            best = np.minimum(best, d)
    return out


def sr_frame(shape, seed: int = 0):
    """tests/test_table_detector_sr.py's organized scene at ``shape`` (rows,
    columns): pinhole rays from SR_VIEW through a grid, the nearest hit of
    the axis-aligned box SR_BOX or the table plane, 0.5 mm noise.  Returns
    (points (H, W, 3) float32, in_box (H, W))."""
    h, w = shape
    vp = np.asarray(SR_VIEW)
    lo, hi = (np.asarray(c) for c in SR_BOX)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    look = np.array([0.25, 0.0, TABLE_Z]) - vp
    look /= np.linalg.norm(look)
    right = np.cross(look, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, look)
    d = look + ((xs - w / 2) / (w * 1.6))[..., None] * right + ((ys - h / 2) / (h * 1.6))[..., None] * up
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_tab = (TABLE_Z - vp[2]) / d[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t1, t2 = (lo - vp) / d, (hi - vp) / d
    tmin, tmax = np.minimum(t1, t2).max(-1), np.maximum(t1, t2).min(-1)
    t_box = np.where((tmax >= tmin) & (tmin > 0), tmin, np.inf)
    in_box = t_box < t_tab
    pts = vp + np.where(in_box, t_box, t_tab)[..., None] * d
    pts += np.random.default_rng(seed).normal(0, 5e-4, pts.shape)
    return pts.astype(np.float32), in_box


def layered_scene(seed: int) -> np.ndarray:
    """tests/test_layered.py's scene at N_LAYERED points: a 1.2 m wall at
    y = 0.4 (z 0..0.6) and an r = 0.1 cylinder at (2.0, 1.5) (z 0..0.5),
    2 mm xy noise."""
    rng = np.random.default_rng(seed)
    n_wall = N_LAYERED * 1800 // 3300
    n_cyl = N_LAYERED - n_wall
    wall = np.column_stack([rng.uniform(0, 1.2, n_wall), np.full(n_wall, 0.4), rng.uniform(0, 0.6, n_wall)])
    ang = rng.uniform(0, 2 * np.pi, n_cyl)
    cyl = np.column_stack([2.0 + 0.1 * np.cos(ang), 1.5 + 0.1 * np.sin(ang), rng.uniform(0, 0.5, n_cyl)])
    pts = np.vstack([wall, cyl]).astype(np.float32)
    pts[:, :2] += rng.normal(0, 0.002, (len(pts), 2))
    return pts


def vase(seed: int):
    """tests/test_fit_models.py's vase at N_VASE points: r(z) = 0.08 +
    0.03 sin 6z about the z axis, with its exact normals."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-0.2, 0.2, N_VASE)
    r = 0.08 + 0.03 * np.sin(6 * z)
    ang = rng.uniform(0, 2 * np.pi, N_VASE)
    pts = np.column_stack([r * np.cos(ang), r * np.sin(ang), z]).astype(np.float32)
    nr = np.column_stack([np.cos(ang), np.sin(ang), -0.18 * np.cos(6 * z)])
    return pts, (nr / np.linalg.norm(nr, axis=1, keepdims=True)).astype(np.float32)


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
    in phase 5's tiled ICP call, in phase 7's denoise of a box-filtered
    frame and its detect_table call, in phase 8's segment_room of the
    room scan and detect_table_sr of the SwissRanger frame, and in phase
    9's detect of box 1 and leave-one-out protocol on the corpus's r
    features, phase 10's brute map step at world size 1, phase 11's
    hough_segment call and phase 12's render_robot_depth,
    multi_plane_ransac and segment_normal_image calls."""
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

    from mapping_private_tpu_torch.models.room_segmentation import segment_room
    from mapping_private_tpu_torch.models.table_detector_sr import detect_table_sr

    room = PointCloud.from_numpy(room_scan(seed)[0], device=dev)
    profile_call(torch, f"segment_room at the default config, a {N_ROOM}-point room scan",
                 lambda: segment_room(room, gen), smi)
    pts = torch.from_numpy(sr_frame(SR_SHAPE, seed)[0]).to(dev)
    valid = torch.ones(SR_SHAPE, dtype=torch.bool, device=dev)
    vp = torch.tensor(SR_VIEW, device=dev)
    profile_call(torch, f"detect_table_sr at the default config, a {SR_SHAPE[1]} x {SR_SHAPE[0]} frame",
                 lambda: detect_table_sr(pts, valid, vp, gen), smi)

    from mapping_private_tpu_torch.apps.detect_object import detect, learn_object
    from mapping_private_tpu_torch.classify.evaluate import leave_one_out_subspace
    from mapping_private_tpu_torch.io.pcd import save_pcd

    with tempfile.TemporaryDirectory() as td:
        scene_path, obj_pca = f"{td}/scene.pcd", f"{td}/box1.pca"
        scene, _, lab = coloured_frame(seed)
        save_pcd(scene_path, scene)
        views = [f"{td}/box1_view{k}.pcd" for k in range(5)]
        for k, path in enumerate(views):
            save_pcd(path, box_view(seed + 10 + k, turn=k >= 3))
        learn_object(views, obj_pca, 5, device=dev)
        ranges, exist_thr, _ = detect_settings(scene, lab, views, dev)
        profile_call(torch, f"detect_object.detect of box 1 in the coloured {N_TABLE}-point frame (PCD load "
                     f"included), 1 cm voxels, block {DETECT_BLOCK}, ranges {ranges}",
                     lambda: detect(scene_path, obj_pca, ranges, DETECT_BLOCK, 50, 5,
                                    exist_threshold=exist_thr, device=dev), smi)
    z = np.load(CORPUS_NPZ, allow_pickle=True)
    profile_call(torch, "leave_one_out_subspace r on the committed corpus features (63 objects x 24 views)",
                 lambda: leave_one_out_subspace(z["features_r"], z["labels"], list(z["names"]), "r", device=dev),
                 smi)

    import torch.distributed as dist

    from mapping_private_tpu_torch.models.hough_segmentation import HoughConfig, hough_segment
    from mapping_private_tpu_torch.parallel.distributed import make_sharded_map_icp_step
    from mapping_private_tpu_torch.parallel.mesh import make_mesh

    _, maps, _ = sharded_data(seed, se3_exp, torch)
    with tempfile.TemporaryDirectory() as td:
        dist.init_process_group("nccl", init_method=f"file://{td}/store", world_size=1, rank=0)
        try:
            step, shard = make_sharded_map_icp_step(make_mesh((1,), ("mp",)))
            args = shard(*maps)
            profile_call(torch, f"brute map step at world size 1 (nccl): a {N_POINTS}-point scan against "
                         f"{N_MAP} map points", lambda: step(*args), smi)
        finally:
            dist.destroy_process_group()
    xyz, _ = hough_cloud(seed)
    cloud = PointCloud.from_numpy(xyz, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    profile_call(torch, f"hough_segment (the CLI's settings) on phase 11's {len(xyz)}-point cloud",
                 lambda: hough_segment(cloud, gen, HoughConfig(**HOUGH_CFG)), smi)
    profile_selffilter(torch, dev, smi, seed)


def profile_selffilter(torch, dev, smi: str, seed: int):
    """--profile of phase 12: one warm render_robot_depth, multi_plane_ransac
    and segment_normal_image on the phase's frame."""
    from mapping_private_tpu_torch.realtime import depth as rd, render as rr, segmentation as rs, urdf

    h, w = VGA_SHAPE
    cam = look_at(*SF_CAMERA)
    with tempfile.TemporaryDirectory() as td:
        robot, cam_root, _ = selffilter_robot(td, cam)
        render = lambda: urdf.render_robot_depth(robot, cam_root, (h, w), fx=KINECT_F, fy=KINECT_F,  # noqa: E731
                                                 joint_values=SF_JOINTS, device=dev)
        profile_call(torch, f"render_robot_depth: phase 12's robot at {w} x {h}", render, smi)
        robot_d = render()
    sv, st, _ = selffilter_scene()
    scene = rr.render_depth_mesh(torch.from_numpy(sv).to(dev), torch.from_numpy(st).to(dev), (h, w), fx=KINECT_F,
                                 fy=KINECT_F, pose=torch.from_numpy(cam.astype(np.float32)).to(dev))
    meas = torch.from_numpy(measured_frame(robot_d, scene.cpu().numpy())[0]).to(dev)
    keep = rd.background_subtract(meas, torch.from_numpy(robot_d).to(dev), threshold=0.05)
    pts, valid = rd.depth_to_cloud(rd.smooth_depth_image(torch.where(keep, meas, 0.0)), fx=KINECT_F, fy=KINECT_F)
    nimg = rs.fast_normals_image(pts, valid)
    mask = valid & (torch.linalg.vector_norm(nimg, dim=-1) > 0.5)
    u = torch.from_numpy(np.random.default_rng(seed).random((SF_PLANES, SF_HYPOTHESES), dtype=np.float32)).to(dev)
    profile_call(torch, f"multi_plane_ransac: {h * w} rows, {SF_HYPOTHESES} hypotheses, {SF_PLANES} planes",
                 lambda: rs.multi_plane_ransac(pts.reshape(-1, 3), nimg.reshape(-1, 3), mask.reshape(-1), None,
                                               num_hypotheses=SF_HYPOTHESES, max_planes=SF_PLANES,
                                               threshold=SF_THRESHOLD, u=u), smi)
    profile_call(torch, f"segment_normal_image: {w} x {h}", lambda: rs.segment_normal_image(nimg, mask), smi)


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


def _wall(fn, torch, turns: int = 3):
    """(median warm wall ms over ``turns`` calls ending in a sync, last result)."""
    walls, out = [], None
    for _ in range(turns):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls), out


def phase_room(torch, dev, smi: str, seed: int, td: str):
    """Phase 8, the room: the room_segment CLI as a user runs it, then the
    room downsampled for fit_orientation_ransac and region_grow."""
    import math

    from mapping_private_tpu_torch.core.cloud import PointCloud
    from mapping_private_tpu_torch.fit.orientation import fit_orientation_ransac
    from mapping_private_tpu_torch.io.pcd import load_pcd_arrays, save_pcd
    from mapping_private_tpu_torch.ops.normals import estimate_normals
    from mapping_private_tpu_torch.ops.region_growing import region_grow
    from mapping_private_tpu_torch.ops.voxel import voxel_downsample_dense

    names = list(room_surfaces())
    xyz, label = room_scan(seed)
    path, lab_path, filt_path = f"{td}/room.pcd", f"{td}/room_labeled.pcd", f"{td}/room_filtered.pcd"
    save_pcd(path, {"xyz": xyz})
    a = load_pcd_arrays(path)
    z = a["z"]
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "mapping_private_tpu_torch.apps.room_segment", path,
         "--out-labeled", lab_path, "--out-filtered", filt_path],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"room_segment: rc {out.returncode}: {out.stderr[-2000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    counts, planes = res["counts"], np.asarray(res["wall_planes"], np.float64).reshape(-1, 4)
    want = {"floor": int((z < 0.1).sum()), "ceiling": int((z > 2.7).sum())}
    # the four walls as (unit normal, offset): n·p + d = 0
    walls = {"wall x=0": ((1, 0, 0), 0.0), "wall x=6": ((1, 0, 0), -ROOM[0]),
             "wall y=0": ((0, 1, 0), 0.0), "wall y=4": ((0, 1, 0), -ROOM[1])}
    matched = {}
    for pl in planes:
        best = None
        for wname, (n_true, d_true) in walls.items():
            sgn = 1.0 if pl[:3] @ n_true >= 0 else -1.0
            ang = math.degrees(math.acos(min(1.0, abs(float(pl[:3] @ n_true)))))
            off = abs(sgn * pl[3] - d_true)
            if best is None or (ang, off) < best[1:]:
                best = (wname, ang, off)
        matched[best[0]] = best[1:]
    filt = load_pcd_arrays(filt_path)
    fx = np.stack([filt["x"], filt["y"], filt["z"]], 1)
    (tx0, tx1), (ty0, ty1), tz = ROOM_TABLE
    (cx0, cx1), (cy0, cy1), cz = ROOM_CABINET

    def on_table(p):
        return (np.abs(p[:, 2] - tz) < 0.01) & (p[:, 0] > tx0) & (p[:, 0] < tx1) & (p[:, 1] > ty0) & (p[:, 1] < ty1)

    def on_front(p):
        return (np.abs(p[:, 1] - cy0) < 0.01) & (p[:, 0] > cx0) & (p[:, 0] < cx1) & (p[:, 2] > 0.1) & (p[:, 2] < cz)

    keep_table = on_table(fx).sum() / max(on_table(xyz).sum(), 1)
    keep_front = on_front(fx).sum() / max(on_front(xyz).sum(), 1)
    print(f"room_segment CLI (python -m, {N_ROOM} points, a {ROOM[0]:g} x {ROOM[1]:g} m room): {cli_s:.2f} s wall "
          f"(process start, load, segment, wall_filter, writes); counts {counts} (floor/ceiling truth {want}); "
          f"walls {{name: (normal error deg, offset error m)}} "
          f"{ {k: (round(float(v[0]), 3), round(float(v[1]), 4)) for k, v in matched.items()} }; the filtered cloud "
          f"({len(fx)} points) keeps {keep_table:.4f} of the table top and {keep_front:.4f} of the cabinet front",
          flush=True)
    if (counts["floor"], counts["ceiling"]) != (want["floor"], want["ceiling"]):
        fail("room_segment: floor or ceiling count off the truth")
    if len(planes) != 4 or len(matched) != 4 or max(max(v[0] for v in matched.values()) / 2.0,
                                                     max(v[1] for v in matched.values()) / 0.02) >= 1:
        fail("room_segment: not the 4 walls within 2 degrees and 0.02 m")
    if keep_table < 0.99 or keep_front < 0.99:
        fail("room_segment: the wall filter dropped the table or the cabinet front")
    lab = load_pcd_arrays(lab_path)["segment"]
    if len(lab) != N_ROOM or int((lab >= 3).sum()) != counts["walls"]:
        fail("room_segment: the labeled PCD disagrees with the counts")

    # orientation and region growing on the downsampled room
    cloud = PointCloud.from_numpy(xyz, device=dev)
    t0 = time.perf_counter()
    # a lattice offset by half a voxel, so the planes x, y, z = 0 run
    # through cell middles, not along cell faces
    origin = (-ROOM_VOXEL / 2,) * 3
    dims = tuple(int(np.ceil((e + ROOM_VOXEL) / ROOM_VOXEL)) for e in ROOM)
    down = voxel_downsample_dense(cloud, ROOM_VOXEL, origin, dims, ROOM_DOWN_CAP)
    n_down = int(down.count())
    if n_down >= ROOM_DOWN_CAP:
        fail(f"room downsample spilled: {n_down} voxels")
    down = estimate_normals(down, k=12)
    nrm = down.channel("normal")
    gen = torch.Generator(device=dev).manual_seed(seed)
    direction, inl = fit_orientation_ransac(nrm, down.mask, gen)
    d = direction.cpu().numpy()
    ang = math.degrees(math.atan2(float(d[1]), float(d[0]))) % 90.0
    ang_err = min(ang, 90.0 - ang)
    labels = region_grow(down.padded_xyz(), down.mask, 0.05, normals=nrm, angle_threshold=math.radians(10))
    labels = labels.cpu().numpy()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    live = down.mask.cpu().numpy()
    truth = room_surface_of(down.xyz.cpu().numpy()[live])
    regions, sizes = np.unique(labels[live], return_counts=True)
    top = regions[np.argsort(-sizes, kind="stable")[:6]]
    purity = []
    for r in top:
        t = truth[labels[live] == r]
        k = np.bincount(t, minlength=len(names))
        purity.append((names[int(k.argmax())], int(k.sum()), float(k.max() / k.sum())))
    print(f"room downsampled at {ROOM_VOXEL} m to {n_down} rows, normals k=12, fit_orientation_ransac and "
          f"region_grow (radius 0.05, 10 degree gate): {1e3 * wall_s:.2f} ms wall (first call); direction "
          f"{np.round(d, 5).tolist()} ({ang_err:.3f} deg off the room's axes, bound 2), {int(inl.sum())} inliers; "
          f"{len(regions)} regions, the 6 largest (surface, size, share on it): {purity}", flush=True)
    if ang_err >= 2.0:
        fail("fit_orientation_ransac: the direction is not the room's")
    if len(purity) < 6 or min(p[2] for p in purity) < 0.95 or len({p[0] for p in purity}) != 6:
        fail("region_grow: the 6 largest regions are not 6 surfaces, each 95% on one")
    return cloud


def phase_structural(torch, dev, smi: str, seed: int):
    """Phase 8: the structural scenes (room, layered reconstruction, the
    SwissRanger frame, triangulation, the rotational fit, cloud_ops)."""
    from mapping_private_tpu_torch.core.cloud import PointCloud
    from mapping_private_tpu_torch.fit.rotational import fit_rotational_ransac, rotational_distance
    from mapping_private_tpu_torch.models.layered_reconstruction import LayeredConfig, layered_reconstruction
    from mapping_private_tpu_torch.models.table_detector_sr import detect_table_sr, split_table_detection
    from mapping_private_tpu_torch.ops.triangulation import compact_mesh, triangulate_depth_image

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        phase_room(torch, dev, smi, seed, td)

        # layered reconstruction: the wall becomes a box, the cylinder a cylinder
        cloud = PointCloud.from_numpy(layered_scene(seed), device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        t0 = time.perf_counter()
        solids = layered_reconstruction(cloud, gen, LayeredConfig(layer_height=0.1, min_inliers=40))
        lay_ms = 1e3 * (time.perf_counter() - t0)
        cyl = next((s for s in solids if s.kind == "cylinder"), None)
        box = next((s for s in solids if s.kind == "box"), None)
        print(f"layered_reconstruction {N_LAYERED} points: {lay_ms:.2f} ms wall (first call); solids "
              f"{[(s.kind, s.layers) for s in solids]}; cylinder {cyl and cyl.params}; box {box and box.params}",
              flush=True)
        if cyl is None or box is None:
            fail("layered_reconstruction: no box and cylinder")
        e0, e1 = np.asarray(box.params["endpoints"])
        if (np.abs(np.asarray(cyl.params["center"]) - [2.0, 1.5]).max() >= 0.02 or abs(cyl.params["radius"] - 0.1) >= 0.01
                or cyl.z_hi - cyl.z_lo < 0.3 or np.linalg.norm(e1 - e0) <= 0.8):
            fail("layered_reconstruction: the solids are off")

        # the SwissRanger frame: detect_table_sr and split_table_detection
        pts_np, in_box = sr_frame(SR_SHAPE, seed)
        pts = torch.from_numpy(pts_np).to(dev)
        valid = torch.ones(SR_SHAPE, dtype=torch.bool, device=dev)
        vp = torch.tensor(SR_VIEW, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        sr_ms, det = _wall(lambda: detect_table_sr(pts, valid, vp, gen), torch)
        plane = det.plane.cpu().numpy().astype(np.float64)
        z0 = -plane[3] / plane[2] if plane[2] else np.inf
        sizes = det.object_sizes.cpu().numpy()
        masks = det.object_masks.cpu().numpy()
        poly, objs = split_table_detection(det, pts)
        one = masks[np.argmax(sizes)].reshape(SR_SHAPE)
        print(f"detect_table_sr {SR_SHAPE[1]} x {SR_SHAPE[0]} frame: {sr_ms:.2f} ms warm wall per call [{smi}]; "
              f"found {bool(det.found)}, plane height {z0:.4f} (|dz| bound 0.02), objects of sizes "
              f"{sizes[sizes > 0].tolist()} ({int(one[in_box].sum())} of the largest on box pixels); "
              f"split: polygon of {len(poly)} vertices, {len(objs)} object clouds", flush=True)
        if not bool(det.found) or abs(z0 - TABLE_Z) >= 0.02 or (sizes > 0).sum() != 1:
            fail("detect_table_sr: not the table and one object")
        if one[in_box].sum() != one.sum() or len(objs) != 1 or len(poly) < 3:
            fail("detect_table_sr: the object is not the box alone")

        # triangulation of that frame and of a VGA frame of the same scene
        for shape in (SR_SHAPE, VGA_SHAPE):
            p_np, _ = sr_frame(shape, seed)
            p = torch.from_numpy(p_np).to(dev)
            ok_img = torch.ones(shape, dtype=torch.bool, device=dev)
            tri_ms, (tris, ok) = _wall(lambda: triangulate_depth_image(p, ok_img), torch)
            tris, ok = tris.cpu().numpy(), ok.cpu().numpy()
            flat = p_np.reshape(-1, 3)
            vt = tris[ok]
            longest = float(np.linalg.norm(flat[vt] - flat[np.roll(vt, 1, axis=1)], axis=-1).max()) if len(vt) else 0.0
            verts, faces = compact_mesh(p_np, tris, ok)
            print(f"triangulate_depth_image {shape[1]} x {shape[0]}: {tri_ms:.2f} ms warm wall [{smi}]; "
                  f"{int(ok.sum())} of {len(ok)} triangles valid, longest valid edge {longest:.4f} m (bound 0.05); "
                  f"compact mesh {len(verts)} vertices, {len(faces)} faces", flush=True)
            if not 0.9 < ok.mean() < 1.0 or longest > 0.05 or len(faces) != ok.sum():
                fail("triangulate_depth_image: the mesh is off")

        # the rotational fit on a vase
        v_np, vn_np = vase(seed)
        vx, vn = torch.from_numpy(v_np).to(dev), torch.from_numpy(vn_np).to(dev)
        ones = torch.ones(N_VASE, dtype=torch.bool, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        rot_ms, (surf, inl) = _wall(lambda: fit_rotational_ransac(vx, vn, ones, gen, threshold=0.01), torch)
        frac = float(inl.float().mean())
        ax = surf.axis.cpu().numpy()
        med = float(rotational_distance(surf, vx).median())
        print(f"fit_rotational_ransac {N_VASE}-point vase: {rot_ms:.2f} ms warm wall [{smi}]; inliers {frac:.4f} "
              f"(bound 0.7), axis {np.round(ax, 5).tolist()}, median residual {med:.2e} m (bound 0.01)", flush=True)
        if frac <= 0.7 or abs(ax[2]) <= 0.95 or med >= 0.01:
            fail("fit_rotational_ransac: the vase is not recovered")

        phase_cloud_ops(seed, td)
    print(f"phase 8: {time.perf_counter() - t_phase:.2f} s wall", flush=True)


def phase_cloud_ops(seed: int, td: str):
    """cloud_ops' five subcommands on phase 7's frame with N_OUTLIERS
    points injected above the table."""
    from mapping_private_tpu_torch.apps import cloud_ops
    from mapping_private_tpu_torch.io.pcd import load_pcd_arrays, save_pcd

    frame, _ = tabletop_frame(seed)
    rng = np.random.default_rng(seed + 1)
    outl = rng.uniform([-1.3, -1.4, 1.2], [1.3, 1.4, 2.6], (N_OUTLIERS, 3)).astype(np.float32)
    xyz = np.concatenate([frame, outl])
    src = f"{td}/frame.pcd"
    save_pcd(src, {"xyz": xyz})
    orig = load_pcd_arrays(src)
    orig = np.stack([orig["x"], orig["y"], orig["z"]], 1)

    def run(args):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cloud_ops.main(args)
        if rc != 0:
            fail(f"cloud_ops {args[0]}: rc {rc}")
        return 1e3 * (time.perf_counter() - t0)

    def read(path):
        a = load_pcd_arrays(path)
        return np.stack([a["x"], a["y"], a["z"]], 1)

    yaw, t = 0.7, np.array([0.3, -0.1, 0.2])
    t_inv = -(cloud_ops._euler_matrix(0, 0, -yaw) @ t)
    ms = {}
    ms["transform"] = run(["transform", "--yaw", repr(yaw), *sum(([f"--{a}", repr(float(v))] for a, v in zip("xyz", t)), []),
                           "--out-dir", f"{td}/tf", src])
    ms["transform back"] = run(["transform", "--yaw", repr(-yaw),
                                *sum(([f"--{a}", repr(float(v))] for a, v in zip("xyz", t_inv)), []),
                                "--out-dir", f"{td}/back", f"{td}/tf/frame_tf.pcd"])
    back_err = float(np.abs(read(f"{td}/back/frame_tf_tf.pcd") - orig).max())
    ms["crop"] = run(["crop", "--axis", "z", "--min", "0.7", "--max", "0.8", "--out-dir", f"{td}/crop", src])
    cropped = read(f"{td}/crop/frame_crop_z.pcd")
    band = orig[(orig[:, 2] >= np.float32(0.7)) & (orig[:, 2] <= np.float32(0.8))]
    ms["denoise"] = run(["denoise", "--out-dir", f"{td}/dn", src])
    den = read(f"{td}/dn/frame_denoised.pcd")
    outlier_rows = {tuple(r) for r in orig[len(frame):].tolist()}
    n_out_left = sum(tuple(r) in outlier_rows for r in den.tolist())
    ms["project"] = run(["project", "--out-dir", f"{td}/pj", src])
    proj = read(f"{td}/pj/frame_proj.pcd")
    ms["concat"] = run(["concat", "--out", f"{td}/cat.pcd", src, f"{td}/tf/frame_tf.pcd"])
    n_cat = len(read(f"{td}/cat.pcd"))
    print(f"cloud_ops on a {len(xyz)}-point frame ({N_OUTLIERS} injected outliers), ms wall per subcommand "
          f"(load, device work, write): { {k: round(v, 2) for k, v in ms.items()} }; transform and back max error "
          f"{back_err:.2e} (bound 1e-5); crop kept {len(cropped)} rows (band {len(band)}); denoise kept "
          f"{len(den)} rows, {n_out_left} of them outliers; project max |z| {float(np.abs(proj[:, 2]).max())}; "
          f"concat {n_cat} rows", flush=True)
    if not back_err <= 1e-5:
        fail("cloud_ops: transform and its inverse do not return the points")
    if len(cropped) != len(band) or not np.array_equal(np.sort(cropped, axis=0), np.sort(band, axis=0)):
        fail("cloud_ops: crop did not keep exactly the band")
    if n_out_left > 0.01 * N_OUTLIERS or len(den) < 0.5 * len(frame):
        fail("cloud_ops: denoise did not drop the injected outliers")
    if np.abs(proj[:, 2]).max() != 0 or not np.array_equal(proj[:, :2], orig[:, :2]):
        fail("cloud_ops: project is off")
    if n_cat != 2 * len(xyz):
        fail("cloud_ops: concat row count is not the sum of its inputs")


# -- phase 9: object recognition and classification ---------------------------
DETECT_BLOCK = 4  # --block-size: 4 cm subdivisions of the CLI's 1 cm voxels
# colours by surface of tabletop_frame's labels: the table top brown, box 1
# red, box 2 green, the cylinders blue and yellow, the floor grey, the wall
# a light grey-brown; RGB_NOISE of uniform integer noise on each channel
SURFACE_RGB = ((150, 110, 70), (200, 30, 30), (40, 170, 60), (40, 60, 200), (210, 200, 40),
               (105, 105, 100), (185, 180, 170))
RGB_NOISE = 10
CORPUS_NPZ = REPO_ROOT / "tests" / "data_corpus_features_gr.npz"  # the committed 63-object g/r features
JAX_CORPUS_CORRECT = {"r": 1379, "g": 452, "svm r": 1264}  # the JAX package's counts of 1,512 (EVALUATION.md)
# the synthetic classify corpus: (shape, size in m, colour) of each object
SYN_OBJECTS = (("box", (0.08, 0.08, 0.08), (200, 30, 30)),
               ("cylinder", (0.03, 0.10), (40, 170, 60)),
               ("sphere", (0.035,), (40, 60, 200)),
               ("box", (0.12, 0.12, 0.01), (210, 200, 40)),
               ("box", (0.05, 0.05, 0.12), (40, 190, 190)),
               ("cylinder", (0.05, 0.04), (190, 40, 170)),
               ("sphere", (0.06,), (200, 200, 200)),
               ("box", (0.10, 0.06, 0.03), (230, 130, 30)))
N_SYN_VIEWS = 24  # views per object, as in the reference's corpus
N_SYN_POINTS = 2000  # points per view


def coloured_frame(seed: int):
    """Phase 7's frame (``tabletop_frame``) coloured by surface: the PCD
    arrays (xyz, r, g, b with integer colours), the objects' truth and each
    point's surface label."""
    xyz, truth, lab = tabletop_frame(seed, labels=True)
    rng = np.random.default_rng(seed + 7919)
    rgb = np.clip(np.asarray(SURFACE_RGB)[lab] + rng.integers(-RGB_NOISE, RGB_NOISE + 1, (len(lab), 3)), 0, 255)
    rgb = rgb.astype(np.float32)
    return {"xyz": xyz, "r": rgb[:, 0], "g": rgb[:, 1], "b": rgb[:, 2]}, truth, lab


def box_view(seed: int, turn: bool):
    """Box 1's points cropped from the coloured frame of ``seed``;
    ``turn`` turns them 90 degrees about z around the box's centre."""
    arrays, _, lab = coloured_frame(seed)
    out = {k: v[lab == 1] for k, v in arrays.items()}
    if turn:
        _, cx, cy, _ = TABLE_OBJECTS[0]
        rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        out["xyz"] = ((out["xyz"] - [cx, cy, 0.0]) @ rz.T + [cx, cy, 0.0]).astype(np.float32)
    return out


def syn_surface(shape: str, size, rng, n: int):
    """n points on an object's whole surface and their outward normals."""
    idx = np.arange(n)
    if shape == "box":
        ext = np.asarray(size)
        areas = np.repeat([ext[1] * ext[2], ext[0] * ext[2], ext[0] * ext[1]], 2)
        face = rng.choice(6, n, p=areas / areas.sum())
        ax, sgn = face // 2, np.where(face % 2, 1.0, -1.0)
        p = rng.uniform(-0.5, 0.5, (n, 3)) * ext
        p[idx, ax] = sgn * ext[ax] / 2
        nrm = np.zeros((n, 3))
        nrm[idx, ax] = sgn
    elif shape == "cylinder":
        r, h = size
        side = rng.uniform(size=n) < 2 * np.pi * r * h / (2 * np.pi * r * h + 2 * np.pi * r * r)
        th = rng.uniform(0, 2 * np.pi, n)
        rad = np.where(side, r, r * np.sqrt(rng.uniform(size=n)))
        cap = np.where(rng.uniform(size=n) < 0.5, -h / 2, h / 2)
        p = np.column_stack([rad * np.cos(th), rad * np.sin(th), np.where(side, rng.uniform(-h / 2, h / 2, n), cap)])
        nrm = np.where(side[:, None], np.column_stack([np.cos(th), np.sin(th), np.zeros(n)]),
                       np.column_stack([np.zeros(n), np.zeros(n), np.sign(cap)]))
    else:
        nrm = rng.normal(size=(n, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        p = size[0] * nrm
    return p, nrm


def syn_view(k: int, rng):
    """One view of SYN_OBJECTS[k]: the side seen from a random viewpoint
    above it, N_SYN_POINTS points with 0.5 mm noise, integer colours."""
    shape, size, col = SYN_OBJECTS[k]
    p, nrm = syn_surface(shape, size, rng, 4 * N_SYN_POINTS)
    az, el = rng.uniform(0, 2 * np.pi), rng.uniform(0.2, 1.2)
    view = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
    p = p[nrm @ view > 0.05][:N_SYN_POINTS]
    p = (p + rng.normal(0, 0.0005, p.shape)).astype(np.float32)
    rgb = np.clip(np.asarray(col) + rng.integers(-RGB_NOISE, RGB_NOISE + 1, (len(p), 3)), 0, 255).astype(np.float32)
    return {"xyz": p, "r": rgb[:, 0], "g": rgb[:, 1], "b": rgb[:, 2]}


def write_syn_corpus(root: str, seed: int) -> str:
    """SYN_OBJECTS x N_SYN_VIEWS views as PCD files, one obj* directory an
    object (the reference corpus's layout)."""
    from mapping_private_tpu_torch.io.pcd import save_pcd

    rng = np.random.default_rng(seed + 4243)
    for k in range(len(SYN_OBJECTS)):
        d = pathlib.Path(root) / f"obj{k:02d}"
        d.mkdir(parents=True)
        for v in range(N_SYN_VIEWS):
            save_pcd(str(d / f"view{v:02d}.pcd"), syn_view(k, rng))
    return root


CPU_RUN_THREADS = 6  # the CPU comparisons' threads: two of the host's 8 cores stay with the card's process


def detect_settings(scene, lab, views, dev):
    """(--ranges, --exist-threshold) of phase 9's detection of box 1: its
    extent in the scene's 4 cm subdivisions (how many of them its points
    span in the CLI's grid), and 0.8 of its occupied voxels (the median
    over its views).  At the default threshold of 10 voxels any box of red
    voxels scores within ~1e-6 of 1, a sub-box above the table beats the
    whole box by rounding, and the top box may miss the centroid (PERF.md
    §6)."""
    from mapping_private_tpu_torch.apps import detect_object
    from mapping_private_tpu_torch.io.pcd import load_pcd

    vs = detect_object.VOXEL_SIZE
    block_m = DETECT_BLOCK * vs
    origin = np.floor(scene["xyz"].min(0) / vs) * vs
    pts = scene["xyz"][lab == 1]
    span = np.floor((pts.max(0) - origin) / block_m) - np.floor((pts.min(0) - origin) / block_m) + 1
    voxels = [int((detect_object._grid(load_pcd(v, device=dev))[0].count > 0).sum()) for v in views]
    return [int(v) for v in span], 0.8 * float(np.median(voxels)), voxels


def _cpu_runs(cmds, results):
    """Run each command (the phase's comparisons on the CPU) in turn, on
    CPU_RUN_THREADS threads; keep (returncode, stdout, stderr, seconds)
    under its key."""
    env = dict(os.environ, OMP_NUM_THREADS=str(CPU_RUN_THREADS))
    for key, cmd in cmds:
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True, timeout=900, env=env)
        results[key] = (out.returncode, out.stdout, out.stderr, time.perf_counter() - t0)


def _score_at(sdata, axis_q, det, origin, exist_threshold):
    """The similarity that search_object gives the box of detection ``det``
    (its mode's extent, its origin in the scene's subdivisions)."""
    import torch

    from mapping_private_tpu_torch.apps.detect_object import VOXEL_SIZE
    from mapping_private_tpu_torch.recognition.search import _mode_scores

    block_m = DETECT_BLOCK * VOXEL_SIZE
    lo, hi = np.asarray(det["box_min"]), np.asarray(det["box_max"])
    r = [int(v) for v in np.round((hi - lo) / block_m)]
    at = tuple(int(v) for v in np.round((lo - origin) / block_m))
    aq = torch.as_tensor(axis_q, dtype=torch.float32, device=sdata.int_feat.device)
    return float(_mode_scores(sdata.int_feat, sdata.int_exist, *r, aq, exist_threshold)[at])


def _box_key(d):
    return (d["mode"], tuple(round(v, 6) for v in d["box_min"]), tuple(round(v, 6) for v in d["box_max"]))


def phase_recognition(torch, dev, smi: str, seed: int):
    """Phase 9: the detect_object CLI on phase 7's frame at 1 cm voxels, the
    classification protocols on the committed corpus features, and the
    classify CLI on a synthetic corpus; the CPU comparisons run alongside."""
    import threading
    import warnings

    from mapping_private_tpu_torch.apps import detect_object
    from mapping_private_tpu_torch.classify.evaluate import crossval_svm, leave_one_out_subspace
    from mapping_private_tpu_torch.features import colorchlac117_subdiv, occupied_count_subdiv
    from mapping_private_tpu_torch.io.pcd import load_pcd, save_pcd
    from mapping_private_tpu_torch.recognition import build_scene_data, read_pca, search_object, subspace_axis

    t_phase = time.perf_counter()
    module = [sys.executable, "-m"]
    with tempfile.TemporaryDirectory() as td:
        scene, truth, lab = coloured_frame(seed)
        paths = {"scene": f"{td}/scene.pcd"}
        save_pcd(paths["scene"], scene)
        for k in (1, 2):
            paths[f"env{k}"] = f"{td}/env{k}.pcd"
            save_pcd(paths[f"env{k}"], coloured_frame(seed + k)[0])
        views, view_rows = [f"{td}/box1_view{k}.pcd" for k in range(5)], []
        for k, path in enumerate(views):
            view = box_view(seed + 10 + k, turn=k >= 3)
            save_pcd(path, view)
            view_rows.append(len(view["xyz"]))
        corpus = write_syn_corpus(f"{td}/corpus", seed)
        thr, scene_pca, obj_pca = f"{td}/color_threshold.txt", f"{td}/scene.pca", f"{td}/box1.pca"
        span, exist_thr, obj_voxels = detect_settings(scene, lab, views, dev)
        ranges = [str(v) for v in span]
        centroid = np.asarray(truth[0][1])
        print(f"phase 9 files: a {N_TABLE}-point coloured frame, 2 more for the scene PCA, 5 views of box 1 "
              f"({view_rows} points), a corpus of {len(SYN_OBJECTS)} objects x "
              f"{N_SYN_VIEWS} views of {N_SYN_POINTS} points; written in {time.perf_counter() - t_phase:.2f} s",
              flush=True)

        # learning, on the card through the CLI's entry point
        for argv in (["learn-threshold", paths["scene"], "--out", thr],
                     ["learn-scene", paths["env1"], paths["env2"], "--out", scene_pca, "--block-size",
                      str(DETECT_BLOCK), "--color-threshold", thr],
                     ["learn-object", *views, "--out", obj_pca, "--color-threshold", thr]):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = detect_object.main(argv + ["--device", "cuda"])
            print(f"detect_object {argv[0]}: rc {rc}, {time.perf_counter() - t0:.2f} s wall; "
                  f"{buf.getvalue().strip()}", flush=True)
            if rc != 0:
                fail(f"detect_object {argv[0]} returned {rc}")

        def detect_cmd(with_pca: bool, device: str):
            return module + ["mapping_private_tpu_torch.apps.detect_object", "detect", paths["scene"], "--object-pca",
                             obj_pca, "--ranges", *ranges, "--block-size", str(DETECT_BLOCK), "--color-threshold",
                             thr, "--exist-threshold", str(exist_thr)] + (
                                 ["--scene-pca", scene_pca] if with_pca else []) + ["--device", device]

        classify_cmd = module + ["mapping_private_tpu_torch.apps.classify", "rate", "--data-dir", corpus,
                                 "--feature", "r", "--leave-one-out", "--json", "--device"]
        cpu = {}
        cpu_thread = threading.Thread(target=_cpu_runs, args=(
            [("detect", detect_cmd(False, "cpu")), ("detect+scene-pca", detect_cmd(True, "cpu")),
             ("classify", classify_cmd + ["cpu"])], cpu))
        cpu_thread.start()

        card = {}
        for with_pca in (False, True):
            key = "detect+scene-pca" if with_pca else "detect"
            t0 = time.perf_counter()
            out = subprocess.run(detect_cmd(with_pca, "cuda"), cwd=REPO_ROOT, capture_output=True, text=True,
                                 timeout=900)
            cli_s = time.perf_counter() - t0
            if out.returncode != 0:
                fail(f"{key}: rc {out.returncode}: {out.stderr[-2000:]}")
            dets = card[key] = json.loads(out.stdout.strip().splitlines()[-1])
            top = dets[0] if dets else None
            inside = top is not None and bool(np.all(np.asarray(top["box_min"]) <= centroid)
                                               and np.all(centroid <= np.asarray(top["box_max"])))
            print(f"detect_object {key} (python -m, --device cuda, ranges {ranges}, block {DETECT_BLOCK}, exist "
                  f"threshold {exist_thr:.1f} = 0.8 x the median of box 1's views' {obj_voxels} voxels): "
                  f"{cli_s:.2f} s wall (process start included) [{smi}]; top-5 scores "
                  f"{[round(d['score'], 7) for d in dets]}; top box {top and top['box_min']} - "
                  f"{top and top['box_max']} (mode {top and top['mode']}); box 1's centroid "
                  f"{np.round(centroid, 4).tolist()} inside: {inside}", flush=True)
            if not inside:
                fail(f"{key}: the top detection's box does not contain the red box's centroid")

        # warm stage times and peak memory of the detect path, in process
        cloud = load_pcd(paths["scene"], device=dev)
        colour_thr = detect_object.read_color_threshold(thr)
        grid_ms, (grid, origin, dims) = _wall(lambda: detect_object._grid(cloud), torch)
        feat_ms, sub = _wall(lambda: colorchlac117_subdiv(grid, DETECT_BLOCK, thresholds=colour_thr), torch)
        exist = occupied_count_subdiv(grid, DETECT_BLOCK)
        axis = subspace_axis(read_pca(scene_pca), 50)
        sat_ms, sdata = _wall(lambda: build_scene_data(sub, exist, scene_axis=axis), torch)
        aq_raw = subspace_axis(read_pca(obj_pca), 5)
        aq = aq_raw @ axis.T
        aq = aq / np.maximum(np.linalg.norm(aq, axis=1, keepdims=True), 1e-12)
        search_ms, _ = _wall(lambda: search_object(sdata, aq, [int(r) for r in ranges], exist_threshold=exist_thr),
                             torch)
        if not (sub.device.type == sdata.int_feat.device.type == dev.type):
            fail("the detect path left the card")
        # each run's scene tables and subspace, to score any box on the card
        scored = {"detect": (build_scene_data(sub, exist), aq_raw), "detect+scene-pca": (sdata, aq)}
        del sub
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        det_ms, _ = _wall(lambda: detect_object.detect(paths["scene"], obj_pca, [int(r) for r in ranges],
                                                       DETECT_BLOCK, 50, 5, scene_pca, exist_threshold=exist_thr,
                                                       color_threshold=thr, device=dev), torch, turns=2)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        print(f"detect path, warm wall [{smi}]: voxelize (the CLI's grid, {dims[0]} x {dims[1]} x {dims[2]} = "
              f"{int(np.prod(dims))} voxels) {grid_ms:.2f} ms, colorchlac117_subdiv ({tuple(exist.shape)} blocks) "
              f"{feat_ms:.2f} ms, build_scene_data (scene axis 50) {sat_ms:.2f} ms, search_object {search_ms:.2f} "
              f"ms; detect() whole with the PCD load {det_ms:.2f} ms; peak device memory {peak:.1f} MiB above the "
              f"{base / 2**20:.1f} MiB before", flush=True)

        # classification on the committed corpus features, on the card
        z = np.load(CORPUS_NPZ, allow_pickle=True)
        L, names = z["labels"], list(z["names"])
        for ft, gate in (("r", lambda r: r > 0.85), ("g", lambda r: 0.25 < r < 0.75)):
            t0 = time.perf_counter()
            res = leave_one_out_subspace(z[f"features_{ft}"], L, names, ft, device=dev)
            torch.cuda.synchronize()
            print(f"leave_one_out_subspace {ft}: {res.n_correct}/{res.n_total} = {res.rate:.4f} (JAX package "
                  f"{JAX_CORPUS_CORRECT[ft]}/1512, EVALUATION.md); {time.perf_counter() - t0:.2f} s wall "
                  f"(first call) [{smi}]", flush=True)
            if not gate(res.rate):
                fail(f"leave_one_out_subspace {ft}: rate {res.rate} outside tests/test_evaluation.py's gate")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = crossval_svm(z["features_r"], L, names, n_folds=4, device=dev)
            svm_s = time.perf_counter() - t0
        hit = [str(w.message) for w in caught if "max_iter" in str(w.message)]
        print(f"crossval_svm r, 4 folds: {res.n_correct}/{res.n_total} = {res.rate:.4f} (JAX package "
              f"{JAX_CORPUS_CORRECT['svm r']}/1512, EVALUATION.md); {svm_s:.2f} s wall "
              f"[{smi}]; train_svc_ovo warned of max_iter: {bool(hit)}{(' - ' + hit[0]) if hit else ''}", flush=True)
        if not res.rate > 0.80:
            fail(f"crossval_svm r: rate {res.rate} <= 0.80")

        # the classify CLI on the synthetic corpus, on the card
        t0 = time.perf_counter()
        out = subprocess.run(classify_cmd + ["cuda"], cwd=REPO_ROOT, capture_output=True, text=True, timeout=900)
        cls_s = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"classify rate: rc {out.returncode}: {out.stderr[-2000:]}")
        rate_card = json.loads(out.stdout.strip().splitlines()[-1])["rate"]
        n_views = len(SYN_OBJECTS) * N_SYN_VIEWS
        print(f"classify rate --leave-one-out --feature r --device cuda (python -m), {len(SYN_OBJECTS)} objects x "
              f"{N_SYN_VIEWS} views: rate {rate_card:.4f} ({round(rate_card * n_views)}/{n_views}); {cls_s:.2f} s "
              f"wall [{smi}]", flush=True)
        if rate_card < 0.9:
            fail(f"classify rate {rate_card} < 0.9")

        t0 = time.perf_counter()
        cpu_thread.join()
        waited = time.perf_counter() - t0
        for key in ("detect", "detect+scene-pca", "classify"):
            if key not in cpu or cpu[key][0] != 0:
                fail(f"the CPU run of {key} failed: {cpu.get(key, (None, '', 'not run'))[2][-2000:]}")
        for key in ("detect", "detect+scene-pca"):
            mine = json.loads(cpu[key][1].strip().splitlines()[-1])
            diff = [abs(a["score"] - b["score"]) for a, b in zip(card[key], mine)]
            ties = []
            for rank, (a, b) in enumerate(zip(card[key], mine)):
                if _box_key(a) != _box_key(b):
                    # an exact tie: two boxes that hold the same occupied
                    # voxels (they differ by empty space), scored alike on
                    # the card and ranked by the last bits
                    alt = _score_at(*scored[key], b, origin, exist_thr)
                    ties.append((rank + 1, a["score"], alt))
            same = len(mine) == len(card[key]) and max(diff, default=0.0) < 1e-4 and all(
                abs(s0 - s1) < 1e-4 for _, s0, s1 in ties)
            print(f"{key} --device cpu: {cpu[key][3]:.2f} s wall; the same top-{len(mine)} boxes as the card: {same} "
                  f"(max |score difference| {max(diff, default=float('nan')):.3g}; ranks that hold another box of "
                  f"a tied score, with the card's scores of both: {ties})", flush=True)
            if not same:
                fail(f"{key}: the CPU run's top-5 boxes or scores differ from the card's: {mine} vs {card[key]}")
        rate_cpu = json.loads(cpu["classify"][1].strip().splitlines()[-1])["rate"]
        print(f"classify rate --device cpu: rate {rate_cpu:.4f}, {cpu['classify'][3]:.2f} s wall; |card - cpu| "
              f"{abs(rate_card - rate_cpu) * n_views:.0f} views (bound 1); waited {waited:.2f} s for the CPU runs",
              flush=True)
        if abs(rate_card - rate_cpu) * n_views > 1 + 1e-9:
            fail("classify: the CPU run's rate is more than one view from the card's")
    print(f"phase 9: {time.perf_counter() - t_phase:.2f} s wall", flush=True)


def surface_normals(xyz: np.ndarray) -> np.ndarray:
    """Unit normals of bench.py's surface z = 0.4 sin(1.8x) + 0.3 cos(2.2y) at xyz."""
    x, y = xyz[..., 0].astype(np.float64), xyz[..., 1].astype(np.float64)
    n = np.stack([-0.72 * np.cos(1.8 * x), 0.66 * np.sin(2.2 * y), np.ones_like(x)], axis=-1)
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


def sharded_data(seed: int, se3_exp, torch):
    """Phase 10's inputs, from ``seed``: N_REG_PAIRS pairs of N_POINTS points
    on bench.py's surface (each source the target seen from a pose moved by
    a random small step, bench.py's step sizes), and a N_POINTS scan of the
    surface seen from a known small pose against an N_MAP-point map of it.
    Returns (registration arrays, map-step arrays, the scan's true pose)."""
    rng = np.random.default_rng(seed + 500)
    tgt = np.stack([surface(N_POINTS, seed + 600 + b) for b in range(N_REG_PAIRS)])
    src = np.empty_like(tgt)
    for b in range(N_REG_PAIRS):
        xi = rng.uniform(-1, 1, 6) * np.array([0.05, 0.04, 0.03, 0.02, 0.02, 0.03])
        T = se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy().astype(np.float64)
        src[b] = ((tgt[b] - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    ones = np.ones((N_REG_PAIRS, N_POINTS), bool)
    eye = np.tile(np.eye(4, dtype=np.float32), (N_REG_PAIRS, 1, 1))
    reg = (src, ones, tgt, ones, surface_normals(tgt), eye)
    map_xyz = surface(N_MAP, seed + 700)
    T_true = se3_exp(torch.tensor([0.03, -0.02, 0.01, 0.005, -0.004, 0.01])).numpy().astype(np.float64)
    scan = ((surface(N_POINTS, seed + 701) - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)
    maps = (scan, np.ones(N_POINTS, bool), map_xyz, np.ones(N_MAP, bool), surface_normals(map_xyz),
            np.eye(4, dtype=np.float32))
    return reg, maps, T_true


def sharded_jobs(reg, maps, world: int, calls: int = 3):
    """Phase 10's four steps for ``world`` ranks, each timed over ``calls``
    warm calls: the registration step on a (dp, sp) mesh (sp = 2 for an
    even rank count, as in the dry run), the brute and tiled map steps on a
    flat mesh, and PG_KEYFRAMES-keyframe pose-graph passes (feeding each
    pass's poses to the next)."""
    from mapping_private_tpu_torch.parallel import distributed as pd
    from mapping_private_tpu_torch.parallel.dryrun import StepJob, loop_closure_graph
    from mapping_private_tpu_torch.registration.pose_graph import make_sharded_pose_graph_step

    sp = 2 if world % 2 == 0 else 1
    origin, dims, cap, max_tiles = pd.size_map_lattice(maps[2], maps[3], MAP_TILE, scan_xyz=maps[0])
    # the scan's own occupancy sizes its buckets, so no scan point spills
    cell = np.floor((maps[0] - np.asarray(origin)) / MAP_TILE).astype(np.int64)
    _, per_cell = np.unique((cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2], return_counts=True)
    q_cap = max(128, -(-int(per_cell.max()) // 128) * 128)
    q_max_tiles = 1 << int(np.ceil(np.log2(len(per_cell))))
    flat = dict(axis_sizes=(world,), axis_names=("mp",), calls=calls, warmup=True)
    kf, edges, meas, w, _, _ = loop_closure_graph(PG_KEYFRAMES, world)
    return {
        "registration": StepJob(pd.make_sharded_registration_step, reg, (world // sp, sp), calls=calls, warmup=True),
        "brute map": StepJob(pd.make_sharded_map_icp_step, maps, **flat),
        "tiled map": StepJob(pd.make_sharded_map_icp_step_tiled, maps, kwargs=dict(
            origin=origin, tile_size=MAP_TILE, dims=dims, cap=cap, max_tiles=max_tiles, q_cap=q_cap,
            q_max_tiles=q_max_tiles, sweeps=MAP_SWEEPS), **flat),
        "pose graph": StepJob(make_sharded_pose_graph_step, (kf, edges, meas, w), feed=0, **flat),
    }


def f64_map_steps(torch, dev, scan, map_xyz, map_nrm, sweeps: int, max_corr_dist=0.3, huber_delta=0.05,
                  damping=1e-6):
    """The map steps' GN sweeps from the identity in plain torch float64 on
    the card, each with a global brute-force NN: the reference the sharded
    map steps are held to."""
    from mapping_private_tpu_torch.core.se3 import se3_exp

    f64 = dict(dtype=torch.float64, device=dev)
    s, m, nrm = (torch.as_tensor(a).to(**f64) for a in (scan, map_xyz, map_nrm))
    m2 = torch.sum(m * m, dim=1)
    T = torch.eye(4, **f64)
    for _ in range(sweeps):
        p = s @ T[:3, :3].T + T[:3, 3]
        sq, idx = [], []
        for c in range(0, len(p), 256):
            pc = p[c : c + 256]
            v, i = torch.min(torch.sum(pc * pc, dim=1)[:, None] + m2[None, :] - 2.0 * (pc @ m.T), dim=1)
            sq.append(v)
            idx.append(i)
        sq, idx = torch.cat(sq), torch.cat(idx)
        q, n = m[idx], nrm[idx]
        r = torch.sum(n * (p - q), dim=1)
        w = torch.where(r.abs() <= huber_delta, 1.0, huber_delta / r.abs().clamp_min(1e-12))
        w = torch.where(sq <= max_corr_dist**2, w, 0.0)
        J = torch.cat([n, torch.linalg.cross(p, n, dim=1)], dim=1)
        H, g = J.T @ (J * w[:, None]), (J * w[:, None]).T @ r
        T = se3_exp(-torch.linalg.solve(H + damping * torch.eye(6, **f64), g)) @ T
    return T.cpu().numpy()


def phase_sharded(torch, dev, smi: str, seed: int, sm_clock_hz: float, results: dict, launches: dict):
    """Phase 10: the sharded steps, (a) over NCCL at one rank a card and (b)
    on two gloo ranks spawned on cuda:0; the map steps against an f64
    reference; nn_matmul at one shard's shape against its plain version."""
    import torch.distributed as dist

    from mapping_private_tpu_torch.core.se3 import se3_exp
    from mapping_private_tpu_torch.ops import nn_matmul, nn_search
    from mapping_private_tpu_torch.parallel.dryrun import dryrun_multichip, run_job, run_steps
    from mapping_private_tpu_torch.utils.metrics import metrics

    t_phase = time.perf_counter()
    reg, maps, T_true = sharded_data(seed, se3_exp, torch)

    # one shard's search at the map step's shape (world size 1: the whole
    # map), bit for bit against the plain version, then its kernel time
    q, refs = torch.from_numpy(maps[0]).to(dev), torch.from_numpy(maps[2]).to(dev)
    idx_k, sq_k = nn_matmul.nn_matmul(q, refs)
    n_str = nn_search.last_stretches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx_p, sq_p = nn_matmul.nn_matmul_plain(q, refs)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    n_idx, n_bits = int((idx_k != idx_p).sum()), int((sq_k.view(torch.int32) != sq_p.view(torch.int32)).sum())
    err = float((sq_k.double() - sq_p.double()).abs().max())
    label = f"{N_POINTS}x{N_MAP}"
    msg = (f"nn_matmul {label} (a map step's shard search): idx mismatches {n_idx}, sq bit mismatches {n_bits}, "
           f"max|dsq| {err:.3g} (plain version once: {plain_s:.2f} s wall)")
    print(msg, flush=True)
    if n_idx or n_bits or not bool(torch.isfinite(sq_k).all()):
        fail(msg)
    results["nn_matmul"]["max_abs_err"] = max(results["nn_matmul"]["max_abs_err"], err)
    del idx_p, sq_p
    turns = [event_ms(torch, lambda: nn_matmul.nn_matmul(q, refs), 20) for _ in range(3)]
    ms = statistics.median(turns)
    b_ms, b_by, before_ms = bound_ms("nn_matmul", N_POINTS, N_MAP, 4 * (3 * N_POINTS + 3 * N_MAP + 2 * N_POINTS),
                                     sm_clock_hz)
    if nn_search.last_stretches != n_str:
        fail(f"nn_matmul {label}: {n_str} stretches when checked, {nn_search.last_stretches} when timed")
    results["nn_matmul"].setdefault("shapes", {})[label] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, stretches=n_str)
    print(f"nn_matmul {label}: {n_str} ref stretches, kernel {ms:.4f} ms (turns {[round(x, 4) for x in turns]}), "
          f"bound {b_ms:.4f} ms by {b_by} ({b_ms / ms:.3f} of the kernel's time [{before_ms / ms:.3f} by the earlier "
          f"count of {SLOTS_PER_PAIR_BEFORE['nn_matmul']} slots a pair]) [{smi}]", flush=True)
    del q, refs, idx_k, sq_k

    # (a) NCCL, one rank a card: in this process at world size 1
    world = torch.cuda.device_count()
    jobs_a = sharded_jobs(reg, maps, world)
    metrics.counters["nn_matmul.launches"] = 0
    if world == 1:
        with tempfile.TemporaryDirectory() as td:
            dist.init_process_group("nccl", init_method=f"file://{td}/store", world_size=1, rank=0)
            try:
                run_a = {name: run_job(job, dev) for name, job in jobs_a.items()}
            finally:
                dist.destroy_process_group()
        n_launch = metrics.counters["nn_matmul.launches"]
    else:
        per_rank = run_steps(list(jobs_a.values()), world, "nccl", "cuda", timeout=600)
        run_a = dict(zip(jobs_a, per_rank[0]))
        n_launch = sum(r.launches["nn_matmul"] for ranks in per_rank for r in ranks)
    launches["nn_matmul"][f"sharded steps, nccl x{world}"] = n_launch
    # (b) two gloo ranks on cuda:0, collectives through host memory
    jobs_b = sharded_jobs(reg, maps, 2)
    t0 = time.perf_counter()
    per_rank_b = run_steps(list(jobs_b.values()), 2, "gloo", "cuda", timeout=600)
    spawn_s = time.perf_counter() - t0
    run_b = dict(zip(jobs_b, per_rank_b[0]))
    n_launch_b = [sum(r.launches["nn_matmul"] for r in ranks) for ranks in per_rank_b]
    print(f"run (a): nccl, world size {world}{' in this process' if world == 1 else ''}, nn_matmul launches "
          f"{n_launch}; run (b): 2 gloo ranks spawned on cuda:0 (gloo has no card collectives: the port's "
          f"collective helper copies each payload to host memory and back), {spawn_s:.2f} s wall with the "
          f"spawn, nn_matmul launches by rank {n_launch_b}", flush=True)
    if n_launch < 1 or min(n_launch_b) < 1:
        fail("phase 10: the sharded steps did not launch nn_matmul")

    for name in jobs_a:
        (p_a, c_a), (p_b, c_b) = run_a[name].outputs, run_b[name].outputs
        d = float(np.abs(p_a - p_b).max())
        same = d <= SHARDED_TOL and (np.array_equal(c_a, c_b) if name != "pose graph" else True)
        extra = (f"err after pass 3: (a) {float(c_a):.4g}, (b) {float(c_b):.4g} (bound 1e-6; the JAX dry run "
                 f"{JAX_DRYRUN_PG_ERR:.4g} on a CPU virtual mesh)" if name == "pose graph"
                 else f"correspondences (a) {np.asarray(c_a).sum()}, (b) {np.asarray(c_b).sum()}")
        print(f"sharded {name}: wall (median of {len(run_a[name].walls)} warm calls) (a) "
              f"{statistics.median(run_a[name].walls):.2f} ms {[round(x, 2) for x in run_a[name].walls]}, (b) "
              f"{statistics.median(run_b[name].walls):.2f} ms {[round(x, 2) for x in run_b[name].walls]}; "
              f"max |(a) - (b)| {d:.3g} (bound {SHARDED_TOL}); {extra} [{smi}]", flush=True)
        if not same or not np.isfinite(p_a).all():
            fail(f"sharded {name}: run (b) differs from run (a)")
        if name == "pose graph" and not max(float(c_a), float(c_b)) < 1e-6:
            fail("sharded pose graph: err after the third pass is not below 1e-6")

    for name, sweeps in (("brute map", 1), ("tiled map", MAP_SWEEPS)):
        t0 = time.perf_counter()
        T_ref = f64_map_steps(torch, dev, maps[0], maps[2], maps[4], sweeps)
        d = float(np.abs(run_a[name].outputs[0] - T_ref).max())
        print(f"sharded {name}: max |T - T_f64| {d:.3g} (bound {F64_TOL}; the f64 reference, {sweeps} sweep(s) "
              f"with a global brute NN, {time.perf_counter() - t0:.2f} s); |T - T_true|_F "
              f"{np.linalg.norm(run_a[name].outputs[0] - T_true):.3g}", flush=True)
        if not d <= F64_TOL:
            fail(f"sharded {name}: more than {F64_TOL} from the f64 reference")

    # one call: each call spawns its ranks anew, so no call is warm
    t0 = time.perf_counter()
    out = dryrun_multichip(2, "gloo", "cuda", small=False, timeout=600)
    print(f"dryrun_multichip(2, 'gloo', 'cuda'): {time.perf_counter() - t0:.2f} s wall (its process starts "
          f"included); {out} [{smi}]", flush=True)
    if not out["pose_graph_err"] < 1e-6:
        fail("dryrun_multichip: pose-graph err not below 1e-6")
    print(f"phase 10: {time.perf_counter() - t_phase:.2f} s wall", flush=True)


def _segment_sets_match(a, b, tol: float = 0.01) -> bool:
    """Two lists of (kind, centroid) match one to one by kind, centroids
    within ``tol`` (as sets: the order of rounds may differ)."""
    if len(a) != len(b):
        return False
    free = list(b)
    for kind, c in a:
        hit = next((j for j, (k2, c2) in enumerate(free) if k2 == kind and np.linalg.norm(c - c2) < tol), None)
        if hit is None:
            return False
        free.pop(hit)
    return True


def _cli_kinds(records):
    out = []
    for r in records:
        if "cylinder" in r:
            c = r["cylinder"]
            out.append((r["kind"], np.array([*c["center"], 0.5 * (c["z_min"] + c["z_max"])])))
        else:
            out.append((r["kind"], np.asarray(r["box"]["center"])))
    return out


def phase_hough(torch, dev, smi: str, seed: int):
    """Phase 11: Hough segmentation of phase 7's four objects, in this
    process on the card and on the CPU with the same uniforms, and through
    the hough_segment CLI on the card and with --device cpu."""
    import threading

    from mapping_private_tpu_torch.core.cloud import PointCloud
    from mapping_private_tpu_torch.io.pcd import load_pcd_arrays, save_pcd
    from mapping_private_tpu_torch.models import hough_eval, hough_segmentation as hs

    t_phase = time.perf_counter()
    xyz, gts = hough_cloud(seed)
    truth = [hough_eval.GroundTruthObject(**g) for g in gts]
    n_hyp = hs.HoughConfig().num_hypotheses
    rng = np.random.default_rng(seed)
    u = [(rng.random((n_hyp, 2), dtype=np.float32), rng.random((n_hyp, 3), dtype=np.float32))
         for _ in range(HOUGH_DRAWS)]
    cfg = hs.HoughConfig(**HOUGH_CFG)
    with tempfile.TemporaryDirectory() as td:
        save_pcd(f"{td}/objects.pcd", {"xyz": xyz})
        cli = lambda d: [sys.executable, "-m", "mapping_private_tpu_torch.apps.hough_segment",  # noqa: E731
                         f"{td}/objects.pcd", "--json", "--marked", f"{td}/marked_{d}.pcd", "--by-voting",
                         "--sizes-out", f"{td}/sizes_{d}.txt", "--device", d]
        cpu = {}
        cpu_thread = threading.Thread(target=_cpu_runs, args=([("cli", cli("cpu"))], cpu))
        cpu_thread.start()

        runs = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            cloud = PointCloud.from_numpy(xyz, device=d)
            calls = {"hough_segment": lambda: hs.hough_segment(cloud, None, cfg, u=u),
                     "segment_by_voting": lambda: hs.segment_by_voting(cloud, None, u=u)[0]}
            for name, fn in calls.items():
                if where == "cpu":
                    runs[(name, where)] = fn()
                    continue
                fn()  # warm
                wall, runs[(name, where)] = _wall(fn, torch)
                rounds = []
                orig = hs._hough_round

                def timed_round(*a, **k):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = orig(*a, **k)
                    torch.cuda.synchronize()
                    rounds.append(1e3 * (time.perf_counter() - t0))
                    return out

                hs._hough_round = timed_round
                try:
                    fn()
                finally:
                    hs._hough_round = orig
                res, _ = hough_eval.match_scene(runs[(name, where)], truth)
                det, kind_ok = sum(r.segment is not None for r in res), sum(r.kind_correct for r in res)
                want = JAX_HOUGH_MATCHES[name]
                print(f"{name} on the card, {len(xyz)} points: {wall:.2f} ms wall warm (median of 3), rounds "
                      f"{[round(x, 2) for x in rounds]} ms; segments {[(s.kind, s.num_inliers) for s in runs[(name, where)]]}"
                      f"; true objects detected {det} (JAX {want['detected']}), with the right kind {kind_ok} "
                      f"(JAX {want['kind_correct']}) [{smi}]", flush=True)
                if det < want["detected"] or kind_ok < want["kind_correct"]:
                    fail(f"{name}: fewer true objects matched than the JAX package matches")
        for name in ("hough_segment", "segment_by_voting"):
            a, b = ([(s.kind, hough_eval.segment_centroid(s)) for s in runs[(name, w)]] for w in ("card", "cpu"))
            print(f"{name}: card and CPU segments match one to one (kind, centroid within 1 cm): "
                  f"{_segment_sets_match(a, b)}", flush=True)
            if not _segment_sets_match(a, b):
                fail(f"{name}: the card's segments differ from the CPU's: {a} vs {b}")

        t0 = time.perf_counter()
        out = subprocess.run(cli("cuda"), cwd=REPO_ROOT, capture_output=True, text=True, timeout=900)
        cli_s = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"the hough_segment CLI failed: {out.stderr[-2000:]}")
        t0 = time.perf_counter()
        cpu_thread.join()
        waited = time.perf_counter() - t0
        if cpu.get("cli", (1,))[0] != 0:
            fail(f"the hough_segment CLI with --device cpu failed: {cpu.get('cli', (None, '', 'not run'))[2][-2000:]}")
        recs = {"cuda": json.loads(out.stdout)[f"{td}/objects.pcd"],
                "cpu": json.loads(cpu["cli"][1])[f"{td}/objects.pcd"]}
        for d in ("cuda", "cpu"):
            marked = load_pcd_arrays(f"{td}/marked_{d}.pcd")
            sizes = open(f"{td}/sizes_{d}.txt").read().splitlines()
            if len(marked["x"]) != len(xyz) or not set(np.unique(marked["intensity"])) <= {0.0, 2.0, 3.0, 4.0} \
                    or len(sizes) != len(recs[d]):
                fail(f"the hough_segment CLI ({d}) wrote a bad marked cloud or sizes table")
        same = _segment_sets_match(_cli_kinds(recs["cuda"]), _cli_kinds(recs["cpu"]))
        print(f"hough_segment CLI --by-voting: card {cli_s:.2f} s wall (process start included), CPU "
              f"{cpu['cli'][3]:.2f} s alongside (waited {waited:.2f} s); segments card "
              f"{[(r['kind'], r['num_inliers']) for r in recs['cuda']]}, CPU "
              f"{[(r['kind'], r['num_inliers']) for r in recs['cpu']]}; match one to one: {same} [{smi}]", flush=True)
        if not same:
            fail("the hough_segment CLI's card and CPU segments differ")
    print(f"phase 11: {time.perf_counter() - t_phase:.2f} s wall", flush=True)


KINECT_F = 525.0  # render_robot_depth's focal length (px), both axes (phase 12)
KINECT_BF = 0.075 * 580.0  # Kinect baseline (m) x focal length (px)
SF_CAMERA = ((-1.0, 0.0, 1.6), (0.2, 0.0, 0.5))  # the Kinect's position and the point it looks at (world)
SF_ROOT = (-0.85, -0.7, 0.0, np.pi / 3)  # the robot's root in the world: x, y, z, yaw
SF_JOINTS = {"torso_lift": 0.05, "shoulder_pan": 0.12, "shoulder_lift": 0.45, "elbow_flex": -0.35,
             "wrist_roll": 0.6}
SF_FINGER = (100, 24)  # the STL finger's tessellation: segments around, rings along (5,000 triangles)
SF_HYPOTHESES, SF_PLANES = 1024, 6
SF_THRESHOLD = 0.01  # the planes' inlier band (m): at 2-3 cm the best planes tilt 1.7-2.3 degrees (scripts/selffilter_planes.py)
SF_PLANE_TOL = (2.0, 0.02, 0.005)  # normal (degrees), offset from the camera (m), distance from the surface (m)
N_MAP_HANDLES = 40  # handles of the semantic map; with 3 walls and 7 counters, 50 boxes


def look_at(eye, target) -> np.ndarray:
    """World -> camera (x right, y down, z forward) for a camera at ``eye``
    looking at ``target`` with the world's +z up."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    z = target - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, y, z])
    T[:3, 3] = -T[:3, :3] @ eye
    return T


def selffilter_scene():
    """Phase 12's scene in the world frame: a wall (x = 0.65, 5 cm behind the
    table), the floor (z = 0) and phase 7's table top (z = 0.75) as box
    slabs, phase 7's two boxes and two cylinders as meshes.  Returns (vertices, triangles, the
    three planes (name, unit normal, offset) with n . p + d = 0)."""
    from mapping_private_tpu_torch.fit.box import box_mesh
    from mapping_private_tpu_torch.fit.cylinder import cylinder_mesh

    parts = [box_mesh((0.67, 0.0, 1.0), np.eye(3), (0.04, 3.0, 2.0)),
             box_mesh((0.0, 0.0, -0.02), np.eye(3), (3.0, 3.0, 0.04)),
             box_mesh((0.0, 0.0, TABLE_Z - 0.02), np.eye(3), (2 * TABLE_HALF[0], 2 * TABLE_HALF[1], 0.04))]
    for kind, cx, cy, size in TABLE_OBJECTS:
        if kind == "box":
            parts.append(box_mesh((cx, cy, TABLE_Z + size[2] / 2), np.eye(3), size))
        else:
            parts.append(cylinder_mesh((cx, cy, TABLE_Z), (0.0, 0.0, 1.0), size[0], 0.0, size[1]))
    verts, tris, off = [], [], 0
    for v, t in parts:
        verts.append(v)
        tris.append(t + off)
        off += len(v)
    planes = [("wall", (1.0, 0.0, 0.0), -0.65), ("floor", (0.0, 0.0, 1.0), 0.0), ("table top", (0.0, 0.0, 1.0), -TABLE_Z)]
    return np.concatenate(verts).astype(np.float32), np.concatenate(tris).astype(np.int32), planes


def finger_triangles(segments: int, rings: int) -> np.ndarray:
    """A tessellated gripper finger along +x: a tapered, slightly bent tube
    0.09 m long with end caps, (2 segments (rings + 1), 3, 3) float32."""
    a = 2 * np.pi * np.arange(segments + 1) / segments
    s = np.linspace(0.0, 1.0, rings + 1)
    r, bend = 0.012 - 0.006 * s, 0.01 * s * s
    ring = np.stack([np.broadcast_to(0.09 * s[:, None], (rings + 1, segments + 1)),
                     r[:, None] * np.cos(a)[None] + bend[:, None], r[:, None] * np.sin(a)[None]], -1)
    tris = []
    for k in range(rings):
        for i in range(segments):
            tris += [[ring[k, i], ring[k, i + 1], ring[k + 1, i]], [ring[k, i + 1], ring[k + 1, i + 1], ring[k + 1, i]]]
    for k in (0, rings):
        centre = [0.09 * s[k], bend[k], 0.0]
        for i in range(segments):
            tris.append([centre, ring[k, i + 1], ring[k, i]])
    return np.asarray(tris, np.float32)


def write_binary_stl(path: str, tris: np.ndarray) -> None:
    import struct

    with open(path, "wb") as fp:
        fp.write(b"\0" * 80 + struct.pack("<I", len(tris)))
        rec = np.zeros(len(tris), dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")])
        rec["v"] = tris
        fp.write(rec.tobytes())


SF_URDF = """<robot name="tabletop_arm">
  <link name="base_link">
    <collision><origin xyz="0 0 0.15"/><geometry><box size="0.5 0.5 0.3"/></geometry></collision>
  </link>
  <link name="torso_link">
    <collision><origin xyz="0 0 0.35"/><geometry><cylinder radius="0.12" length="0.7"/></geometry></collision>
  </link>
  <link name="shoulder_pan_link">
    <collision><origin xyz="0 0 0.06"/><geometry><box size="0.14 0.14 0.12"/></geometry></collision>
  </link>
  <link name="upper_arm_link">
    <collision><origin xyz="0.17 0 0" rpy="0 1.5707963 0"/>
      <geometry><cylinder radius="0.05" length="0.34"/></geometry></collision>
  </link>
  <link name="forearm_link">
    <collision><origin xyz="0.15 0 0" rpy="0 1.5707963 0"/>
      <geometry><cylinder radius="0.04" length="0.3"/></geometry></collision>
  </link>
  <link name="wrist_link">
    <collision><origin xyz="0.03 0 0"/><geometry><box size="0.06 0.08 0.08"/></geometry></collision>
  </link>
  <link name="palm_link">
    <collision><origin xyz="0.02 0 0"/><geometry><box size="0.04 0.12 0.05"/></geometry></collision>
  </link>
  <link name="left_finger_link">
    <collision><geometry><mesh filename="package://meshes/finger.stl"/></geometry></collision>
  </link>
  <link name="right_finger_link">
    <collision><geometry><mesh filename="package://meshes/finger.stl" scale="1 -1 1"/></geometry></collision>
  </link>
  <joint name="torso_lift" type="prismatic">
    <parent link="base_link"/><child link="torso_link"/><origin xyz="0 0 0.3"/><axis xyz="0 0 1"/>
  </joint>
  <joint name="shoulder_pan" type="revolute">
    <parent link="torso_link"/><child link="shoulder_pan_link"/><origin xyz="0.05 0 0.7"/><axis xyz="0 0 1"/>
  </joint>
  <joint name="shoulder_lift" type="revolute">
    <parent link="shoulder_pan_link"/><child link="upper_arm_link"/><origin xyz="0 0 0.06"/><axis xyz="0 1 0"/>
  </joint>
  <joint name="elbow_flex" type="revolute">
    <parent link="upper_arm_link"/><child link="forearm_link"/><origin xyz="0.34 0 0"/><axis xyz="0 1 0"/>
  </joint>
  <joint name="wrist_roll" type="revolute">
    <parent link="forearm_link"/><child link="wrist_link"/><origin xyz="0.3 0 0"/><axis xyz="1 0 0"/>
  </joint>
  <joint name="palm_fixed" type="fixed">
    <parent link="wrist_link"/><child link="palm_link"/><origin xyz="0.06 0 0"/>
  </joint>
  <joint name="left_finger_fixed" type="fixed">
    <parent link="palm_link"/><child link="left_finger_link"/><origin xyz="0.04 0.04 0" rpy="0 0 -0.1"/>
  </joint>
  <joint name="right_finger_fixed" type="fixed">
    <parent link="palm_link"/><child link="right_finger_link"/><origin xyz="0.04 -0.04 0" rpy="0 0 0.1"/>
  </joint>
</robot>
"""


def root_pose() -> np.ndarray:
    x, y, z, yaw = SF_ROOT
    T = np.eye(4)
    T[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
    T[:3, 3] = [x, y, z]
    return T


def raycast_f64(verts_cam: np.ndarray, tris: np.ndarray, shape, f: float):
    """The analytic depth of a mesh seen from the origin: each pixel's ray
    (u - cx, v - cy, f) / f against every triangle (Moller-Trumbore in
    float64), the nearest hit beyond 0.1 m.  Returns (depth, 0 for a miss;
    face id of the hit, -1 for a miss; a face is a pair of triangles, one
    quad of a box or of a cylinder's side)."""
    h, w = shape
    v_, u_ = np.mgrid[0:h, 0:w].astype(np.float64)
    d = np.stack([(u_ - (w - 1) / 2) / f, (v_ - (h - 1) / 2) / f, np.ones_like(u_)], -1).reshape(-1, 3)
    best = np.full(h * w, np.inf)
    face = np.full(h * w, -1)
    p = verts_cam.astype(np.float64)
    for k, (a, b, c) in enumerate(p[tris]):
        e1, e2 = b - a, c - a
        pvec = np.cross(d, e2)
        det = pvec @ e1
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / det
            tvec = -a
            uu = (pvec @ tvec) * inv
            q = np.cross(tvec, e1)
            vv = (d @ q) * inv
            t = (q @ e2) * inv
        hit = (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (t > 0.1) & (t < best) & np.isfinite(t)
        best[hit] = t[hit]
        face[hit] = k // 2
    depth = np.where(np.isfinite(best), best, 0.0)
    return depth.reshape(h, w), face.reshape(h, w)


def away_from_edges(face: np.ndarray) -> np.ndarray:
    """Pixels whose eight neighbours all show the same face: farther than
    1 px from a silhouette or crease edge."""
    ok = np.ones(face.shape, bool)
    pad = np.pad(face, 1, mode="edge")
    h, w = face.shape
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ok &= pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] == face
    return ok


def semantic_map_xml(path: str, seed: int) -> None:
    """A kitchen in the reference's SemanticMap XML layout, in a frame
    whose +z runs away from the map's viewpoint (phase 12's ray grid):
    3 walls, 7 counters and shelves, N_MAP_HANDLES handles on cabinet
    fronts, as many knobs and 10 candidates (the knobs and candidates are
    not boxed by map_to_boxes)."""
    rng = np.random.default_rng(seed)
    fmt = lambda a: " ".join(f"{x:.4f}" for x in a)  # noqa: E731
    ents = []
    for k, (lo, hi) in enumerate((((-2.5, -1.5, 5.0), (2.5, 1.5, 5.02)), ((-2.52, -1.5, 0.5), (-2.5, 1.5, 5.0)),
                                  ((2.5, -1.5, 0.5), (2.52, 1.5, 5.0)))):
        ents.append(f'<wall name="wall-{k}" id="{k + 1}"><model>0 0 1 0</model><minD>{fmt(lo)}</minD>'
                    f'<maxD>{fmt(hi)}</maxD></wall>')
    for k in range(7):
        y, z0 = 1.0 - 0.35 * k, 3.5 + 0.2 * (k % 3)
        ents.append(f'<horizontal name="counter-{k}" id="{10 + k}"><model>0 1 0 {-y:.2f}</model>'
                    f'<minD>{fmt((-2.4 + 0.3 * k, y, z0))}</minD><maxD>{fmt((-0.8 + 0.5 * k, y, z0 + 1.2))}</maxD>'
                    f'</horizontal>')
    for k in range(N_MAP_HANDLES):
        c = (rng.uniform(-2.3, 2.3), rng.uniform(-1.3, 1.3), rng.uniform(3.0, 4.9))
        door = 100 + 3 * k
        ents.append(f'<handle name="handle-{k}" id="{door + 1}"><center>{fmt(c)}</center>'
                    f'<elongation>{fmt(rng.uniform(0.01, 0.12, 3))}</elongation><doorID>{door}</doorID></handle>')
        ents.append(f'<knob name="knob-{k}" id="{door + 2}"><center>{fmt(c)}</center><radius>0.02</radius>'
                    f'<doorID>{door}</doorID></knob>')
    for k in range(10):
        pts = "".join(f"<point>{fmt(rng.uniform(-2, 2, 3))}</point>" for _ in range(4))
        ents.append(f'<candidate name="drawer-{k}" id="{1000 + k}" type="1" typename="drawer"><wallID>1</wallID>'
                    f'<face side="front">{pts}</face></candidate>')
    with open(path, "w") as fp:
        fp.write("<SemanticMap>\n" + "\n".join(ents) + "\n</SemanticMap>\n")


def rack_cloud(seed: int):
    """Phase 12's shelf rack: three 1 m boards at 0.4, 0.9 and 1.4 m with
    2, 3 and 1 objects on them, 2,000 points a board."""
    rng = np.random.default_rng(seed)
    parts = []
    for h, xs in zip((0.4, 0.9, 1.4), ((0.2, 0.6), (0.15, 0.45, 0.8), (0.5,))):
        parts.append(np.column_stack([rng.uniform(0, 1, 2000), rng.uniform(0, 0.4, 2000), np.full(2000, h)]))
        for x in xs:
            size = rng.uniform(0.05, 0.1, 3)
            parts.append(np.column_stack([rng.uniform(x - size[0] / 2, x + size[0] / 2, 600),
                                          rng.uniform(0.2 - size[1] / 2, 0.2 + size[1] / 2, 600),
                                          h + rng.uniform(0.01, size[2] + 0.01, 600)]))
    return np.concatenate(parts).astype(np.float32)


def selffilter_robot(td: str, cam: np.ndarray):
    """Write the finger STL under ``td``, parse SF_URDF against it; returns
    (robot, root -> camera transform, the finger's triangles)."""
    from mapping_private_tpu_torch.realtime import urdf

    os.makedirs(f"{td}/meshes", exist_ok=True)
    finger = finger_triangles(*SF_FINGER)
    write_binary_stl(f"{td}/meshes/finger.stl", finger)
    return urdf.parse_urdf(SF_URDF, mesh_root=td), cam @ root_pose(), finger


def check_icp_gn(torch, dev, smi: str) -> dict:
    """ICP's GN kernel (csrc/icp_gn.cu) against its plain version, both on
    the card, at two consecutive scans of the scan20k ring with its cell's
    settings: the transform within GN_T_TOL, the count equal, the per-sweep
    RMSE within GN_RMSE_RTOL, one ``icp_gn.launches`` a sweep.  Then one
    sweep's apply, partial sums and solve timed alone, beside nn_argmin at
    the same shape.  Returns the kernel's entry of the kernels JSON line."""
    from unittest import mock

    from mapping_private_tpu_torch.core.cloud import PAD_COORD, PointCloud
    from mapping_private_tpu_torch.ops.nn_argmin import nn_argmin_prepared, prepare_nn_ref_argmin
    from mapping_private_tpu_torch.ops.normals import estimate_normals
    from mapping_private_tpu_torch.registration import icp
    from mapping_private_tpu_torch.utils.metrics import metrics
    from perfbench.scenes.surface_scans import make_ring

    cfg = json.loads((REPO_ROOT / "perfbench" / "configs" / "scan20k.json").read_text())
    src, tgt = (PointCloud.from_numpy(f, device=dev) for f in make_ring(cfg, GN_SEED)["frames"][1:3])
    nrm = estimate_normals(tgt, k=cfg["normals_k"]).channel("normal")
    args = (src.padded_xyz(), src.mask, tgt.padded_xyz(), tgt.mask, nrm)
    kw = {k: cfg["icp"][k] for k in ("iters", "max_corr_dist", "huber_delta", "damping")}
    before = metrics.counters["icp_gn.launches"]
    got = icp.icp_point_to_plane(*args, **kw)
    torch.cuda.synchronize()
    n_sweeps = metrics.counters["icp_gn.launches"] - before
    with mock.patch.object(icp, "_gn_on_card", lambda t: False):
        want = icp.icp_point_to_plane(*args, **kw)
    gap = float(torch.linalg.matrix_norm(got.transform.double() - want.transform.double()))
    rel = float(((got.per_iter_rmse.double() - want.per_iter_rmse.double()).abs()
                 / want.per_iter_rmse.double().abs()).max())
    cnt = (int(got.num_corr), int(want.num_corr))
    msg = (f"icp_gn vs plain on the card, scan20k pair ({kw['iters']} sweeps): |dT|_F {gap:.3g} (bound "
           f"{GN_T_TOL}), num_corr {cnt[0]} / {cnt[1]}, per-sweep RMSE max rel {rel:.3g} (bound {GN_RMSE_RTOL}), "
           f"icp_gn.launches {n_sweeps}")
    print(msg, flush=True)
    if gap > GN_T_TOL or cnt[0] != cnt[1] or rel > GN_RMSE_RTOL or n_sweeps != kw["iters"]:
        fail(msg)

    # one sweep's launches alone, on the auto backend's buffers
    tgt_xyz = torch.where(args[3][:, None], args[2], PAD_COORD)
    prepared = prepare_nn_ref_argmin(tgt_xyz)
    gn = icp._CardGN(args[0], args[1], tgt_xyz, torch.where(args[3][:, None], nrm, 0.0), got.transform,
                     kw["iters"], kw["max_corr_dist"], kw["huber_delta"], kw["damping"], True)
    q = gn.apply()
    idx, sq = nn_argmin_prepared(q, prepared)
    stages = {"apply": lambda: gn._launch(icp._GN_APPLY),
              "partials": lambda: gn._launch(icp._GN_PARTIALS, idx, sq),
              "solve": lambda: gn._launch(icp._GN_SOLVE)}
    us = {name: 1e3 * event_ms(torch, fn, 500) for name, fn in stages.items()}
    sweep_ms = event_ms(torch, lambda: [fn() for fn in stages.values()], 500)
    nn_ms = event_ms(torch, lambda: nn_argmin_prepared(q, prepared), 50)
    plain_ms = event_ms(torch, lambda: icp._gn_from_corr(
        icp.se3_apply(gn.T, args[0]), idx, sq, args[1], tgt_xyz, gn.nrm, gn.T,
        kw["max_corr_dist"], kw["huber_delta"], kw["damping"]), 20)
    n = args[0].shape[0]
    bytes_moved = n * (12 + 1 + 12 + 12) + n * (12 + 4 + 4 + 1 + 24)  # apply, then partials
    bound = 1e3 * bytes_moved / HBM_BYTES_PER_S
    print(f"icp_gn one sweep at {n} points: apply {us['apply']:.2f} us, partials {us['partials']:.2f} us, solve "
          f"{us['solve']:.2f} us, the three back to back {1e3 * sweep_ms:.2f} us (bytes bound {1e3 * bound:.3f} us); "
          f"nn_argmin {nn_ms:.4f} ms; the plain version's GN sweep {plain_ms:.4f} ms [{smi}]", flush=True)
    return dict(max_abs_err=gap, ms=sweep_ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", stretches=None)


def measured_frame(robot_d: np.ndarray, scene: np.ndarray):
    """The Kinect frame: the nearer of robot and scene, quantised to 1/8 px
    of disparity; returns (depth float32, 0 where nothing is seen; the
    pixels where the robot is the visible surface)."""
    near = np.where((robot_d > 0) & ((robot_d < scene) | (scene == 0)), robot_d, scene).astype(np.float64)
    with np.errstate(divide="ignore"):
        disp = np.round(KINECT_BF / near * 8) / 8
        meas = np.where(near > 0, KINECT_BF / disp, 0.0).astype(np.float32)
    return meas, (robot_d > 0) & (near == robot_d)


def _first_and_warm(fn, torch):
    """(first call's wall ms, median warm wall ms of 3, last result), each
    call ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = 1e3 * (time.perf_counter() - t0)
    warm, out = _wall(fn, torch)
    return first, warm, out


def phase_selffilter(torch, dev, smi: str, seed: int):
    """Phase 12: the robot self-filter path at full width (one Kinect VGA
    frame): scene and robot rendered, the robot's pixels cut, the rest
    smoothed, unprojected, split into planes and segments; rays against a
    semantic map's boxes; the host layers on the same data."""
    from mapping_private_tpu_torch.core.cloud import PointCloud
    from mapping_private_tpu_torch.integration import JloRegistry, cluster_objects_on_racks
    from mapping_private_tpu_torch.io import dxf, mesh, pcd, semantic_map
    from mapping_private_tpu_torch.native import loader as native
    from mapping_private_tpu_torch.ops.normals import estimate_normals
    from mapping_private_tpu_torch.ops.voxel import voxel_downsample
    from mapping_private_tpu_torch.fit.box import fit_box_zup
    from mapping_private_tpu_torch.pipeline import Pipeline, Stage
    from mapping_private_tpu_torch.realtime import depth as rd, render as rr, segmentation as rs, urdf
    from mapping_private_tpu_torch.utils.metrics import Metrics
    from perfbench.references.selffilter_frames import segments as exact_segments  # scipy's components

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    h, w = VGA_SHAPE
    f = KINECT_F
    cam = look_at(*SF_CAMERA)
    metrics = Metrics()
    times = {}
    with tempfile.TemporaryDirectory() as td:
        # -- 1. the scene ---------------------------------------------------
        sv, st, planes = selffilter_scene()
        sv_cam = (sv.astype(np.float64) @ cam[:3, :3].T + cam[:3, 3]).astype(np.float32)
        sv_t, st_t = torch.from_numpy(sv).to(dev), torch.from_numpy(st).to(dev)
        pose = torch.from_numpy(cam.astype(np.float32)).to(dev)
        times["render_depth_mesh"] = _first_and_warm(
            lambda: rr.render_depth_mesh(sv_t, st_t, (h, w), fx=f, fy=f, pose=pose), torch)
        scene = times["render_depth_mesh"][2].cpu().numpy()
        view = mesh.virtual_view_depth(sv, st, cam, (h, w), fx=f, fy=f, device=dev)
        ref, face = raycast_f64(sv_cam, st, (h, w), f)
        inner = away_from_edges(face)
        hit = inner & (face >= 0)
        rel = np.abs(scene[hit] - ref[hit]) / ref[hit]
        miss_ok = bool((scene[inner & (face < 0)] == 0).all())
        print(f"scene: {len(sv)} vertices, {len(st)} triangles; render_depth_mesh {h} x {w} against the float64 "
              f"ray cast on {int(hit.sum())} pixels away from edges: max rel err {rel.max():.3g} (bound 1e-4), "
              f"misses empty {miss_ok}; virtual_view_depth equal: {bool(np.array_equal(view, scene))}", flush=True)
        if rel.max() > 1e-4 or not miss_ok or not np.array_equal(view, scene) or hit.sum() < 0.5 * h * w:
            fail("the scene's depth is off the analytic depth")

        # -- 2. the robot ---------------------------------------------------
        robot, cam_root, finger = selffilter_robot(td, cam)
        fv, ft = urdf.load_stl(f"{td}/meshes/finger.stl")
        if not (np.array_equal(fv, finger.reshape(-1, 3)) and np.array_equal(ft, np.arange(len(fv)).reshape(-1, 3))):
            fail("load_stl did not read back the finger STL")
        n_tri = sum(len(urdf._geometry_mesh(g)[1]) for link in robot.links.values() for g in link.geometries)
        kinds = sorted({g.kind for link in robot.links.values() for g in link.geometries})
        joint_types = sorted({j.joint_type for j in robot.joints})
        if len(robot.links) < 8 or n_tri < 10_000 or kinds != ["box", "cylinder", "mesh"]:
            fail(f"the robot is too small: {len(robot.links)} links, {n_tri} triangles, {kinds}")
        render_robot = lambda d: urdf.render_robot_depth(robot, cam_root, (h, w), fx=f, fy=f,  # noqa: E731
                                                         joint_values=SF_JOINTS, device=d)
        times["render_robot_depth"] = _first_and_warm(lambda: render_robot(dev), torch)
        robot_d = times["render_robot_depth"][2]
        robot_cpu = render_robot(cpu)
        differ = (robot_d > 0) != (robot_cpu > 0)
        both = (robot_d > 0) & (robot_cpu > 0)
        rrel = float((np.abs(robot_d[both] - robot_cpu[both]) / robot_cpu[both]).max())
        lower = np.nonzero(robot_d.any(axis=1))[0]
        print(f"robot: {len(robot.links)} links ({', '.join(joint_types)} joints), {n_tri} triangles ({kinds}); "
              f"render_robot_depth covers {int((robot_d > 0).sum())} pixels in rows {lower.min()}-{lower.max()}; "
              f"card vs CPU: hit masks differ on {int(differ.sum())} pixels (bound 0.01% = {h * w // 10000}), "
              f"depth max rel err {rrel:.3g} (bound 1e-5)", flush=True)
        if differ.sum() > h * w // 10000 or rrel > 1e-5 or (robot_d > 0).mean() < 0.02 or lower.mean() < h / 2:
            fail("the robot's render is off")

        # -- 3. the measured frame and the self-filter ------------------------
        meas, robot_seen = measured_frame(robot_d, scene)
        meas_t, robot_t = torch.from_numpy(meas).to(dev), torch.from_numpy(robot_d).to(dev)
        with metrics.stage("background_subtract", sync_result=meas_t):
            keep = rd.background_subtract(meas_t, robot_t, 0.05)
        cut = ~keep.cpu().numpy()
        print(f"self-filter: robot visible on {int(robot_seen.sum())} pixels, {int(cut.sum())} cut; all visible robot "
              f"pixels cut {bool(cut[robot_seen].all())}, all cut pixels inside the robot's silhouette "
              f"{bool((robot_d[cut] > 0).all())}", flush=True)
        if not cut[robot_seen].all() or not (robot_d[cut] > 0).all() or robot_seen.mean() < 0.01:
            fail("background_subtract missed the robot or cut the scene")

        # -- 4. smoothing, unprojection, normals ------------------------------
        filt = torch.where(keep, meas_t, 0.0)
        times["smooth_depth_image"] = _first_and_warm(lambda: rd.smooth_depth_image(filt, iterations=5), torch)
        sm = times["smooth_depth_image"][2]
        disp_t = rd.depth_to_disparity(filt)
        lo = rd.disparity_to_depth(disp_t + 1.0)
        hi = rd.disparity_to_depth(torch.clamp_min(disp_t - 1.0, 1e-3))
        v_in = filt > 0
        inside = bool(((sm >= lo) & (sm <= hi))[v_in].all()) and bool((sm[~v_in] == 0).all())
        sm_cpu = rd.smooth_depth_image(filt.cpu(), iterations=5)
        srel = float(((sm.cpu() - sm_cpu).abs()[v_in.cpu()] / sm_cpu[v_in.cpu()]).max())
        with metrics.stage("depth_to_cloud", sync_result=sm):
            pts, valid = rd.depth_to_cloud(sm, fx=f, fy=f)
        with metrics.stage("fast_normals_image", sync_result=sm):
            nimg = rs.fast_normals_image(pts, valid)
        metrics.count("valid pixels", int(valid.sum()))
        pts_c, valid_c = rd.depth_to_cloud(sm_cpu, fx=f, fy=f)
        n_c = rs.fast_normals_image(pts_c, valid_c)
        nerr = float((nimg.cpu() - n_c).abs().max())
        print(f"smooth_depth_image (5 iterations): every pixel inside its clamp interval {inside}; card vs CPU max "
              f"rel err {srel:.3g} (bound 1e-6); normals card vs CPU max abs diff {nerr:.3g}", flush=True)
        if not inside or srel > 1e-6:
            fail("the smoothing left its clamp interval or differs from the CPU")

        # -- 5. planes --------------------------------------------------------
        mask = valid & (torch.linalg.vector_norm(nimg, dim=-1) > 0.5)
        u = np.random.default_rng(seed).random((SF_PLANES, SF_HYPOTHESES), dtype=np.float32)
        ransac = lambda d, p, n, m: rs.multi_plane_ransac(  # noqa: E731
            p.reshape(-1, 3), n.reshape(-1, 3), m.reshape(-1), None, num_hypotheses=SF_HYPOTHESES,
            max_planes=SF_PLANES, threshold=SF_THRESHOLD, u=torch.from_numpy(u).to(d))
        times["multi_plane_ransac"] = _first_and_warm(lambda: ransac(dev, pts, nimg, mask), torch)
        pl, lab, cnt = times["multi_plane_ransac"][2]
        pl_c, lab_c, cnt_c = ransac(cpu, pts.cpu(), nimg.cpu(), mask.cpu())
        found = pl[: int(cnt)].cpu().numpy().astype(np.float64)
        lab_np = lab.cpu().numpy()
        vgrid, ugrid = np.mgrid[0:h, 0:w].astype(np.float64)
        rays_true = np.stack([(ugrid - (w - 1) / 2) / f, (vgrid - (h - 1) / 2) / f, np.ones_like(ugrid)], -1)
        p_true = (ref[..., None] * rays_true).reshape(-1, 3)  # each pixel's analytic surface point
        matched = []
        for si, (name, n_w, d_w) in enumerate(planes):
            n_cam = cam[:3, :3] @ np.asarray(n_w)
            on = (face.reshape(-1) // 6 == si) & (ref.reshape(-1) > 0)  # meshes 0-2: wall, floor, table slabs
            best = None
            for k, p in enumerate(found):
                nk = p[:3] / np.linalg.norm(p[:3])
                members = (lab_np == k) & on
                if members.sum() < 100:
                    continue
                ang = np.degrees(np.arccos(min(abs(nk @ n_cam), 1.0)))
                off = abs(nk @ p_true[members].mean(0) + p[3] / np.linalg.norm(p[:3]))
                d_err = abs(np.sign(nk @ n_cam) * p[3] / np.linalg.norm(p[:3]) - (d_w - n_cam @ cam[:3, 3]))
                if best is None or ang + 50 * off < best[0] + 50 * best[1]:
                    best = (ang, off, k, d_err)
            ok = best is not None and best[0] <= SF_PLANE_TOL[0] and best[3] <= SF_PLANE_TOL[1] \
                and best[1] <= SF_PLANE_TOL[2]
            matched.append((name, best, ok))
        same_planes = int(cnt) == int(cnt_c) and float((pl - pl_c.to(dev)).abs().max()) <= 1e-4
        lab_eq = float((lab.cpu() == lab_c).float().mean())
        print(f"multi_plane_ransac over {h * w} rows ({int(mask.sum())} live), {SF_HYPOTHESES} hypotheses: {int(cnt)} "
              f"planes, sizes {torch.bincount(lab[lab >= 0].long(), minlength=int(cnt)).tolist()}; matches "
              f"{[(n, tuple(round(float(x), 4) for x in e) if e else None, ok) for n, e, ok in matched]} "
              f"(surface: normal error deg, distance from the true surface at the centroid of its pixels among the "
              f"plane's inliers m, plane, error of the plane's offset from the camera m; bounds: normal, offset, "
              f"distance {SF_PLANE_TOL}); card vs CPU: {int(cnt_c)} planes, max diff "
              f"{float((pl[: int(cnt)] - pl_c[: int(cnt)].to(dev)).abs().max()) if int(cnt) == int(cnt_c) else 'n/a'} "
              f"(bound 1e-4), labels equal on {lab_eq:.5f} (bound 0.999)", flush=True)
        if not all(ok for _, _, ok in matched) or not same_planes or lab_eq < 0.999:
            fail("multi_plane_ransac missed a plane or differs from the CPU")

        # -- 6. segmentation --------------------------------------------------
        times["segment_normal_image"] = _first_and_warm(lambda: rs.segment_normal_image(nimg, mask), torch)
        seg = times["segment_normal_image"][2]
        seg_again, rounds = rs._segment(nimg, mask, 0.3, 30)  # the same call, with its round count
        seg_c = rs.segment_normal_image(nimg.cpu(), mask.cpu())
        seg_eq = float((seg.cpu() == seg_c).float().mean())
        n_comp = int(torch.unique(seg[seg < h * w]).numel())
        exact = exact_segments(rs.mean_shift_normals(nimg, mask, 0.3), mask, 0.3, 30).reshape(h, w)
        big = sorted(torch.bincount(seg[seg < h * w].long()).tolist(), reverse=True)[:4]
        print(f"segment_normal_image: {n_comp} components of at least 30 pixels (largest {big}), connected "
              f"components converged in {rounds} rounds; equal to scipy's exact components "
              f"{bool(np.array_equal(seg.cpu().numpy(), exact))}; card vs CPU labels equal on {seg_eq:.5f} "
              f"(bound 0.999)", flush=True)
        if seg_eq < 0.999 or n_comp < 3 or not torch.equal(seg, seg_again) or not np.array_equal(seg.cpu().numpy(), exact):
            fail("segment_normal_image differs from the CPU or from the exact components")

        # -- 7. rays against the semantic map ---------------------------------
        semantic_map_xml(f"{td}/kitchen.xml", seed)
        smap = semantic_map.parse_semantic_map(f"{td}/kitchen.xml")
        n_ent = len(smap.by_id())
        boxes = semantic_map.map_to_boxes(smap)
        c = np.asarray([b["center"] for b in boxes], np.float32)
        s = np.asarray([b["size"] for b in boxes], np.float32)
        bmin, bmax = c - s / 2, c + s / 2
        origin = np.array([0.1, -0.2, 0.0], np.float32)
        rays = lambda d, lo_, hi_: rr.boxlist_ray_intersection(  # noqa: E731
            torch.from_numpy(lo_).to(d), torch.from_numpy(hi_).to(d), origin, f, w, h)
        times["boxlist_ray_intersection"] = _first_and_warm(lambda: rays(dev, bmin, bmax), torch)
        ids, depth = times["boxlist_ray_intersection"][2]
        ids_c, depth_c = rays(cpu, bmin, bmax)
        fin = torch.isfinite(depth_c)
        same_ids = bool(torch.equal(ids.cpu(), ids_c))
        drel = float(((depth.cpu() - depth_c).abs()[fin] / depth_c[fin].abs().clamp_min(1e-30)).max())
        same_inf = bool(torch.equal(torch.isfinite(depth.cpu()), fin))
        e_ids, e_depth = rays(dev, bmin[:0], bmax[:0])
        empty_ok = bool((e_ids == 0).all()) and bool(torch.isinf(e_depth).all())
        print(f"boxlist_ray_intersection: {n_ent} map entities, {len(boxes)} boxes, {h} x {w} rays: "
              f"{int((ids > 0).sum())} hits over {int(torch.unique(ids[ids > 0]).numel())} boxes; card vs CPU ids "
              f"equal {same_ids}, depth max rel err {drel:.3g} (bound 1e-6); the empty list misses everywhere "
              f"{empty_ok}", flush=True)
        if n_ent < 50 or len(boxes) < 50 or not same_ids or drel > 1e-6 or not same_inf or not empty_ok:
            fail("boxlist_ray_intersection differs from the CPU or mishandles the empty list")

        # -- 8. the host layers on the same data -------------------------------
        all_v, all_t, off = [], [], 0
        for link_name, T in robot.forward_kinematics(SF_JOINTS).items():
            for g in robot.links[link_name].geometries:
                gv, gt = urdf._geometry_mesh(g)
                all_v.append(gv @ T[:3, :3].T + T[:3, 3])
                all_t.append(gt + off)
                off += len(gv)
        rv, rt = np.concatenate(all_v).astype(np.float32), np.concatenate(all_t)
        with metrics.stage("vtk + dxf round trips"):
            mesh.write_vtk_mesh(f"{td}/robot.vtk", rv, rt)
            vv, vt = mesh.read_vtk_mesh(f"{td}/robot.vtk")
            dxf.write_dxf_mesh(f"{td}/robot.dxf", rv, rt)
            xv, xt = dxf.read_dxf_mesh(f"{td}/robot.dxf")
        vtk_ok = np.array_equal(vt, rt) and np.abs(vv - rv).max() <= 1e-6
        dxf_ok = len(xt) == len(rt) and np.abs(xv[xt] - rv[rt]).max() <= 1e-6
        pts_g = mesh.sample_mesh_points(fv, ft, 20_000, seed=seed)
        on = np.full(len(pts_g), np.inf)
        a, b_, c_ = (fv[ft[:, k]].astype(np.float64) for k in range(3))
        nrm = np.cross(b_ - a, c_ - a)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        for lo_i in range(0, len(pts_g), 1024):
            q = pts_g[lo_i:lo_i + 1024].astype(np.float64)[:, None, :] - a[None]
            on[lo_i:lo_i + 1024] = np.abs(np.einsum("tk,ptk->pt", nrm, q)).min(axis=1)
        gcloud = PointCloud.from_numpy(pts_g, device=dev)
        pipe = Pipeline([Stage(op="VoxelDownsample", input="in", outputs={"cloud": "down"},
                               params={"leaf_size": 0.003, "capacity": 8192}),
                         Stage(op="NormalEstimation", input="down", outputs={"cloud": "n"}, params={"k": 12}),
                         Stage(op="RobustBoxEstimation", input="n", outputs={"model": "box"})])
        with metrics.stage("pipeline: voxel, normals, box", sync_result=gcloud):
            out = pipe.run({"in": gcloud})
        metrics.count("gripper points", len(pts_g))
        direct_down = voxel_downsample(gcloud, 0.003, 8192)
        direct = fit_box_zup(direct_down.padded_xyz(), direct_down.mask)
        direct_n = estimate_normals(direct_down, k=12).channel("normal")
        # the voxel sums are atomic adds on the card, so the two runs agree to rounding, not bit for bit
        live_v = direct_down.mask
        pipe_err = max(float((out["down"].xyz - direct_down.xyz)[live_v].abs().max()),
                       float((out["box"].extents - direct.extents).abs().max()),
                       float((out["box"].center - direct.center).abs().max()))
        ndot = float((out["n"].channel("normal") * direct_n).sum(-1).abs()[live_v].min())
        pipe_ok = torch.equal(out["down"].mask, live_v) and pipe_err <= 1e-5 and ndot >= 1 - 1e-4
        racks = rack_cloud(seed)
        rk_d = cluster_objects_on_racks(PointCloud.from_numpy(racks, device=dev), (0.4, 0.9, 1.4))
        rk_c = cluster_objects_on_racks(PointCloud.from_numpy(racks, device=cpu), (0.4, 0.9, 1.4))
        racks_ok = ([len(rk_d[r]) for r in range(3)] == [len(rk_c[r]) for r in range(3)] == [2, 3, 1]
                    and all(np.array_equal(x, y) for r in range(3) for x, y in zip(rk_d[r], rk_c[r])))
        jlo = JloRegistry()
        table_lo = jlo.update("/table", root_pose())
        cup = jlo.update("/cup", look_at((0.1, 0.2, 0.3), (0.0, 0.0, 1.0)), parent_id=table_lo.lo_id)
        jlo_ok = np.allclose(jlo.framequery(cup.lo_id), root_pose() @ cup.pose, atol=1e-12) and np.allclose(
            jlo.framequery(cup.lo_id, table_lo.lo_id), cup.pose, atol=1e-12)
        print(f"host layers: VTK round trip {vtk_ok}, DXF round trip {dxf_ok} ({len(rt)} triangles); "
              f"sample_mesh_points 20,000 on the finger: max distance to the surface {on.max():.3g} m (bound 1e-5); "
              f"Pipeline voxel -> normals -> box against the direct calls: {int(out['down'].count())} voxels, max "
              f"diff {pipe_err:.3g} m (bound 1e-5), least |normal dot| {ndot:.7f} (bound 1 - 1e-4): {pipe_ok}; cluster_objects_on_racks card == CPU {racks_ok} ({[len(rk_d[r]) for r in range(3)]}); "
              f"jlo framequery {jlo_ok}", flush=True)
        if not (vtk_ok and dxf_ok and on.max() <= 1e-5 and pipe_ok and racks_ok and jlo_ok):
            fail("a host layer failed")

        frame, _ = tabletop_frame(seed)
        pcd.save_pcd(f"{td}/frame.pcd", {"xyz": frame})
        with open(f"{td}/frame.pcd", "rb") as fp:
            raw = fp.read()
        body = raw[raw.index(b"DATA ascii\n") + len(b"DATA ascii\n"):]
        if not native.native_available():
            fail("the native library did not build: load_pcd would parse with numpy")
        t0 = time.perf_counter()
        nat = native.parse_floats(body)
        nat_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        npy = np.array(body.split(), dtype=np.float32)
        npy_ms = 1e3 * (time.perf_counter() - t0)
        ulps = np.abs(nat.view(np.int32).astype(np.int64) - npy.view(np.int32).astype(np.int64))
        t0 = time.perf_counter()
        with metrics.stage("load_pcd (native parse)", sync_result=meas_t):
            loaded = pcd.load_pcd(f"{td}/frame.pcd", device=dev)
        load_ms = 1e3 * (time.perf_counter() - t0)
        load_ok = int(loaded.count()) == N_TABLE and np.array_equal(
            loaded.xyz[:N_TABLE].cpu().numpy(), nat.reshape(-1, 3))
        print(f"load_pcd of phase 7's {N_TABLE}-point ASCII frame ({len(body)} bytes): parse path native "
              f"(native_available() {native.native_available()}); native parse {nat_ms:.2f} ms, numpy parse "
              f"{npy_ms:.2f} ms, load_pcd {load_ms:.2f} ms [{smi}]; {int((ulps > 0).sum())} of {len(nat)} values "
              f"differ, by at most {int(ulps.max())} ulp (bound 1); the cloud holds the native values {load_ok}",
              flush=True)
        if len(nat) != 3 * N_TABLE or ulps.max() > 1 or not load_ok:
            fail("the native parse differs from numpy's by more than an ulp")

    for name, (first, warm, _) in times.items():
        metrics.stages[name].add(first / 1e3)
        print(f"{name}: first call {first:.2f} ms, warm {warm:.2f} ms (median of 3) [{smi}]", flush=True)
    print("stage times (utils.metrics.Metrics: first calls of the phase; the parses above):")
    print(metrics.report(), flush=True)
    print(f"phase 12: {time.perf_counter() - t_phase:.2f} s wall", flush=True)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description="On-card smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--profile", action="store_true", help="profile the paths instead of checking them")
    ap.add_argument("--seed", type=int, default=0, help="seed of the scenes of phases 7-12")
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
    from mapping_private_tpu_torch.ops import knn_kbest, nn_argmin, nn_gather, nn_matmul, nn_search
    from mapping_private_tpu_torch.ops.nn_dispatch import nn_1nn
    from mapping_private_tpu_torch.ops.normals import estimate_normals
    from mapping_private_tpu_torch.registration.icp import (
        icp_point_to_plane, icp_point_to_plane_tiled, size_tiled_lattice)
    from mapping_private_tpu_torch.registration.scan_to_map import ScanToMapTracker, TrackerConfig
    from mapping_private_tpu_torch.utils.metrics import metrics

    dev = torch.device("cuda")
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    # each counts its launches as "<name>.launches" (icp_gn: one a sweep, three launches)
    nn_kernels = ("nn_argmin", "nn_matmul", "nn_gather", "knn_kbest", "icp_gn")

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def boundaries(nq, nr):
        splits = nn_search.split_count(nq, nr, sms)
        step = nn_search.stretch_len(nr, splits)
        return [k * step for k in range(1, nn_search.stretch_count(nr, splits))]

    def reset_counts():
        for name in nn_kernels:
            metrics.counters[f"{name}.launches"] = 0

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

    # knn_kbest: the tabletop frame's live rows, then ragged sizes at its bucket edges
    frame_np, _ = tabletop_frame(args.seed)
    in_box = ((frame_np >= np.asarray(TABLE_BOX[:3])) & (frame_np <= np.asarray(TABLE_BOX[3:]))).all(1)
    live_np = frame_np[in_box]
    rng = np.random.default_rng(9)
    edges = sorted({1, knn_kbest.K_MAX} | {e + d for e in range(knn_kbest.K_STEP, knn_kbest.K_MAX, knn_kbest.K_STEP)
                                          for d in (0, 1)})
    kbest_cases = [(f"tabletop_frame_{len(live_np)}_live", live_np, [20, 1, knn_kbest.K_MAX]),
                   ("ragged_5003", rng.uniform(-1, 1, (5003, 3)).astype(np.float32), edges),
                   ("below_k_17", rng.uniform(-1, 1, (17, 3)).astype(np.float32), [1, 16, 17, 20, knn_kbest.K_MAX])]
    max_abs_err = 0.0
    for name, pts_np, ks in kbest_cases:
        kt = nn_argmin.prepare_nn_ref_argmin(to_dev(pts_np))
        for k in ks:
            got = knn_kbest.knn_kbest(kt, k)
            torch.cuda.synchronize()
            want = knn_kbest.knn_kbest_plain(kt, k)
            n_bits = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            gap = torch.where(got == want, 0.0, (got.double() - want.double()).abs())  # inf == inf reads 0
            err = float(gap.max()) if gap.numel() else 0.0
            max_abs_err = max(max_abs_err, err)
            msg = f"knn_kbest {name} k={k}: sq bit mismatches {n_bits}, max|dsq| {err:.3g}"
            if k in (1, 20, knn_kbest.K_MAX):
                print(msg, flush=True)
            if n_bits:
                fail(msg)
    print(f"knn_kbest: {sum(len(ks) for _, _, ks in kbest_cases)} cases bit for bit", flush=True)
    results["knn_kbest"] = {"max_abs_err": max_abs_err, "stretches": None}  # it never splits the refs
    kt = nn_argmin.prepare_nn_ref_argmin(to_dev(live_np))
    ms, p_ms, kern, plain = time_turns(torch, lambda: knn_kbest.knn_kbest(kt, 20),
                                       lambda: knn_kbest.knn_kbest_plain(kt, 20))
    n_live = len(live_np)
    b_ms, b_by, _ = bound_ms("knn_kbest", n_live, n_live, 4 * (3 * n_live + 20 * n_live), sm_clock_hz)
    results["knn_kbest"].update(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"knn_kbest {n_live} live points, k=20: kernel {ms:.4f} ms (turns {[round(x, 4) for x in kern]}), plain "
          f"{p_ms:.4f} ms (turns {[round(x, 4) for x in plain]}), bound {b_ms:.4f} ms by {b_by} "
          f"({b_ms / ms:.3f} of the kernel's time) [{smi}]", flush=True)
    del kt, got, want

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
        n_launch = launches["nn_argmin"]["icp_register"] = metrics.counters["nn_argmin.launches"]
        n_gn_register = metrics.counters["icp_gn.launches"]
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
    if n_gn_register != pairs * ICP_ITERS:
        fail(f"icp_register took ICP's GN kernel in {n_gn_register} sweeps, expected {pairs * ICP_ITERS}")

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

    # ICP's GN kernel against its plain version on the card
    before = metrics.counters["icp_gn.launches"]
    results["icp_gn"] = check_icp_gn(torch, dev, smi)
    launches["icp_gn"] = {"icp_register": n_gn_register, "GN check": metrics.counters["icp_gn.launches"] - before}

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
    launches["nn_matmul"]["ops.nn_matmul"] = metrics.counters["nn_matmul.launches"]
    rms["nn_matmul"] = residual_rms(q, tgt_xyz[idx_m.long()], tgt_nrm[idx_m.long()])
    for dist in nn_gather.DIST_MODES:
        before = metrics.counters["nn_gather.launches"]
        sq_g, q_g, n_g = nn_gather.nn_gather(q, tgt_xyz, tgt_nrm, dist=dist)
        launches[f"nn_gather:{dist}"]["ops.nn_gather"] = metrics.counters["nn_gather.launches"] - before
        rms[f"nn_gather:{dist}"] = residual_rms(q, q_g, n_g)
        if dist == "vpu":
            n_bad = int((sq_g != sq_a).sum() + (q_g != q_a).any(1).sum() + (n_g != n_a).any(1).sum())
            print(f"nn_gather[vpu] vs nn_argmin + gathers on the 20k pair: {n_bad} unequal rows")
            if n_bad:
                fail("nn_gather(dist='vpu') disagrees with what the registration path gathers")
    torch.cuda.synchronize()
    launches["nn_argmin"]["ops cross-check"] = metrics.counters["nn_argmin.launches"]
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
    launches["nn_argmin"]["nn_1nn brute 200k"] = metrics.counters["nn_argmin.launches"]
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

    # the dense lattice against the compact engine: the same stencil over
    # the same direct differences, so d² bit for bit, indices equal untied
    lat_walls = []
    for turn in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        i_l, s_l = nn_1nn(big_src, ones, big_tgt, ones, radius=BIG_RADIUS, engine="lattice")
        torch.cuda.synchronize()
        lat_walls.append(1e3 * (time.perf_counter() - t0))
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    i_l, s_l = i_l.cpu().numpy(), s_l.cpu().numpy()
    n_sq_l = int((bits(s_l) != bits(s_c)).sum())
    differ = i_l != i_c
    d_l = ((big_src_np[differ] - big_tgt_np[np.maximum(i_l[differ], 0)]) ** 2).sum(1)
    d_c = ((big_src_np[differ] - big_tgt_np[np.maximum(i_c[differ], 0)]) ** 2).sum(1)
    n_untied_l = int(((np.abs(d_l - d_c) > 1e-9) | (i_l[differ] < 0) | (i_c[differ] < 0)).sum())
    print(f"nn_1nn {N_BIG}x{N_BIG} radius {BIG_RADIUS} engine lattice: {lat_walls[1]:.2f} ms warm "
          f"({lat_walls[0]:.2f} first) against compact {walls['compact'][1]:.2f} ms warm, wall with sync; "
          f"peak memory above the inputs {peak_mb:.1f} MiB; sq bit mismatches against compact {n_sq_l}, "
          f"index differences {int(differ.sum())} of which untied {n_untied_l} [{smi}]", flush=True)
    if n_sq_l or n_untied_l:
        fail("nn_1nn: the lattice and compact engines disagree at 200k")

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

    # the dense lattice (max_tiles=0) on the lattice icp_point_to_plane_tiled
    # sizes, and the segmented re-bucketing, against that compact run
    lattice = size_tiled_lattice(moved_d, ones, big_tgt, ones, tile_size=BIG_RADIUS, cap_per_cell=128)
    lattice["max_tiles"] = 0
    modes = {
        "dense lattice (max_tiles=0)": lambda: icp_point_to_plane(
            moved_d, ones, big_tgt, ones, big_nrm, nn_backend="tiled", grid_cell=BIG_RADIUS, iters=6, **lattice),
        "segmented (rebucket_sweeps=2)": lambda: icp_point_to_plane_tiled(
            moved_d, ones, big_tgt, ones, big_nrm, tile_size=BIG_RADIUS, cap_per_cell=128, iters=6,
            rebucket_sweeps=2),
    }
    for mode, run in modes.items():
        mode_walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r_m = run()
            T_m = r_m.transform.cpu().numpy()
            mode_walls.append(1e3 * (time.perf_counter() - t0))
        dT = float(np.abs(T_m - T_got).max())
        print(f"icp_point_to_plane {mode}, {N_BIG} points, 6 sweeps, tile {BIG_RADIUS}, lattice "
              f"{lattice['tile_dims']}: {mode_walls[1]:.2f} ms warm ({mode_walls[0]:.2f} first) against compact "
              f"{icp_walls[1]:.2f} ms; max |T - T_compact| {dT:.3g} (bound 1e-5), num_corr {int(r_m.num_corr)} "
              f"(compact {n_corr}) [{smi}]", flush=True)
        if not dT <= 1e-5 or int(r_m.num_corr) != n_corr:
            fail(f"tiled ICP {mode} disagrees with the compact per-sweep run")

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
        n_launch = launches["nn_argmin"]["build_map"] = metrics.counters["nn_argmin.launches"]
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

    def kbest_launches(path, phase):
        before = metrics.counters["knn_kbest.launches"]
        phase()
        launches["knn_kbest"][path] = metrics.counters["knn_kbest.launches"] - before

    # -- phase 7: the tabletop slice -------------------------------------------
    kbest_launches("tabletop (phase 7)", lambda: phase_tabletop(torch, dev, smi, args.seed))
    if launches["knn_kbest"]["tabletop (phase 7)"] < TABLE_FRAMES:
        fail(f"the tabletop's denoise launched knn_kbest {launches['knn_kbest']['tabletop (phase 7)']} times")

    # -- phase 8: the structural scenes ----------------------------------------
    kbest_launches("structural, cloud_ops (phase 8)", lambda: phase_structural(torch, dev, smi, args.seed))

    # -- phase 9: object recognition and classification -------------------------
    phase_recognition(torch, dev, smi, args.seed)

    # -- phase 10: the sharded steps ---------------------------------------------
    phase_sharded(torch, dev, smi, args.seed, sm_clock_hz, results, launches)

    # -- phase 11: Hough segmentation ---------------------------------------------
    kbest_launches("hough (phase 11)", lambda: phase_hough(torch, dev, smi, args.seed))

    # -- phase 12: the robot self-filter path (no NN kernel lies on it) ------------
    reset_counts()
    phase_selffilter(torch, dev, smi, args.seed)
    on_path = {name: metrics.counters[f"{name}.launches"] for name in nn_kernels}
    for name in launches:
        launches[name]["self-filter (phase 12)"] = on_path[name.split(":")[0]]
    print(f"phase 12 launched the NN kernels {on_path} times (none lies on the self-filter path)", flush=True)

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
