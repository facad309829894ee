"""mapping_private_tpu_torch — the PyTorch/CUDA port of ``mapping_private_tpu``.

A second package beside the JAX one, ported one slice at a time and held
against it by parity tests (``tests/test_torch_*.py``).  Module names
mirror the JAX package so each counterpart is easy to find.  It imports
torch and numpy, never jax and never ``mapping_private_tpu``.

Every module of the JAX package has its counterpart: scan-to-scan
registration and the mapping loop (``apps.icp_register``,
``apps.build_map``), tabletop perception (``apps.table_pipeline``,
``apps.clean_table``), the structural-scene models
(``apps.room_segment``, ``apps.cloud_ops``), object recognition and
classification (``apps.detect_object``, ``apps.classify``), the sharded
steps (``parallel``), Hough segmentation (``apps.hough_segment``), the
realtime Kinect layer (``realtime``) and the host-side layers:

core          PointCloud (fixed capacity + mask), the dense VoxelGrid,
              SE(3) maps, 6×6 solve
io            PCD reader/writer (ASCII through the native parser),
              markers and PLY, VTK/DXF/PPM meshes, mesh sampling and
              virtual views, the CAD semantic map (host-side numpy)
ops           kNN (brute force, grid hash), normals, the three 1-NN
              kernels and their front door (brute, compact tiles, dense
              lattice), voxel downsampling, filters, clustering, region
              growing, hulls, MLS smoothing, depth-image triangulation
fit           batched-hypothesis RANSAC (plane, 2-D line and circle,
              cylinder, surface of revolution, Manhattan orientation),
              oriented boxes
registration  point-to-plane ICP (dense, tiled, segmented re-bucketing),
              scan-to-map tracking, pose-graph relaxation (and its
              edge-sharded step)
parallel      meshes over torch.distributed ranks, sharded registration
              and scan-to-map steps, the multi-rank dry run
models        the tabletop detectors (unordered and organized clouds),
              the table memory, Hough segmentation and its evaluation,
              room segmentation, layered reconstruction
features      C3-HLAC (ColorCHLAC 117/981, per subdivision), RSD surface
              types, GRSD/VOSCH, PFH, GFPFH, 2-D HLAC, extraction pipelines
recognition   PCA subspaces (reference file formats), sliding-box search
classify      libsvm models, per-class subspaces, linear and kernel SVM
              training, the corpus evaluation protocols
realtime      Kinect depth smoothing, the chunked mesh rasteriser and
              ray/box casting, URDF parsing and robot rendering, the
              self-filter, image normals, multi-plane RANSAC, lattice
              connected components, mean-shift normal segmentation
pipeline      typed configs, the op registry and DAG runner, acquisition
integration   service and pose registries, the COP bridge, shelf racks
native        the g++-built host library (ASCII floats, grid keys, RGB)
utils         stage timers, counters, torch.profiler traces
apps          the nine CLIs, each with ``--device`` (default cuda)
csrc          hand-written CUDA C++ kernels for Hopper (sm_90a)
"""

__version__ = "0.1.0"

# Metric geometry needs exact f32 products: reduced-precision (TF32)
# matmuls mis-rank near-tie neighbours and bias the GN step, the same
# reason the JAX package forces "highest" matmul precision at import.
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
