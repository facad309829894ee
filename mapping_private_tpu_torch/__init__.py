"""mapping_private_tpu_torch — the PyTorch/CUDA port of ``mapping_private_tpu``.

A second package beside the JAX one, ported one slice at a time and held
against it by parity tests (``tests/test_torch_*.py``).  Module names
mirror the JAX package so each counterpart is easy to find.  It imports
torch and numpy, never jax and never ``mapping_private_tpu``.

Slices ported so far: scan-to-scan registration and the mapping loop
(``apps.icp_register``, ``apps.build_map``) and tabletop perception
(``apps.table_pipeline``, ``apps.clean_table``):

core          PointCloud (fixed capacity + mask), SE(3) maps, 6×6 solve
io            PCD reader/writer, markers and PLY (host-side numpy)
ops           kNN (brute force, grid hash), normals, the three 1-NN
              kernels and their front door, voxel downsampling, filters,
              clustering, hulls, MLS smoothing
fit           batched-hypothesis RANSAC (plane, 2-D line and circle,
              cylinder), oriented boxes
registration  point-to-plane ICP (dense and tiled), scan-to-map
              tracking, pose-graph relaxation
models        the tabletop detector and the table memory
apps          the four CLIs, each with ``--device`` (default cuda)
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
