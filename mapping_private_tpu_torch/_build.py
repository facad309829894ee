"""Build and load the hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` is compiled by nvcc for Hopper
(``sm_90a``) into a shared library of its own with a plain C interface
and loaded with ctypes: no PyTorch headers, so a build takes seconds.
Headers shared between sources are ``csrc/*.cuh``.  The libraries land in
``build/torch_kernels/`` at the repository root, keyed by a hash of the
source, every header and the flags, at first use.  A failed build raises;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_VP, _CI = ctypes.c_void_p, ctypes.c_int
# Kernel name -> argument types of its ``<name>_launch`` entry point (all
# return cudaGetLastError() as an int).  Each library also exports
# ``<name>_error_string(int) -> const char*``.
KERNELS = {
    # q, nq, rt, nr, stretch, rows, part_d, part_i, n_counters, counters, idx, sq, stream
    "nn_argmin": [_VP, _CI, _VP, _CI, _CI, _CI, _VP, _VP, _CI, _VP, _VP, _VP, _VP],
    # q, nq, r, nr, stretch, rows, part_d, part_i, n_counters, counters, idx, sq, stream
    "nn_matmul": [_VP, _CI, _VP, _CI, _CI, _CI, _VP, _VP, _CI, _VP, _VP, _VP, _VP],
    # q, nq, rt, nr, stretch, rows, part_d, part_i, n_counters, counters, mode, nt, sq, q_sel,
    # n_sel, stream
    "nn_gather": [_VP, _CI, _VP, _CI, _CI, _CI, _VP, _VP, _CI, _VP, _CI, _VP, _VP, _VP, _VP, _VP],
    # rt, n, k, out, stream
    "knn_kbest": [_VP, _CI, _CI, _VP, _VP],
    # stage, n, blocks, T, src, mask, p, queries, idx, sq, tgt, nrm, params, work, rmse, cnt, stream
    "icp_gn": [_CI, _CI, _CI, *[_VP] * 13, _VP],
}


def source_path(name: str, csrc_dir: pathlib.Path = CSRC_DIR) -> pathlib.Path:
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; have {sorted(KERNELS)}")
    return csrc_dir / f"{name}.cu"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH)")
    return found


def _library_path(name: str, csrc_dir: pathlib.Path = CSRC_DIR) -> pathlib.Path:
    """Where the library of ``csrc_dir/<name>.cu`` goes: its name carries a
    hash of the source, of every header beside it (any source may include
    any of them) and of the flags, so an edit of either builds anew."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source_path(name, csrc_dir), *sorted(csrc_dir.glob("*.cuh"))]:
        data = path.read_bytes()
        key.update(f"\0{path.name}\0{len(data)}\0".encode() + data)
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def compile_libraries(names=None) -> dict[str, tuple[pathlib.Path, str, float]]:
    """Compile every named kernel (default: all) that has no library for
    its hash yet, one nvcc process per source, all started together.

    Returns {name: (library path, nvcc's output including ``-Xptxas -v``'s
    register and shared-memory report, seconds that nvcc ran — 0.0 on a
    cache hit)}.  Raises if any build fails."""
    names = list(KERNELS) if names is None else list(names)
    out, running = {}, []
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            out[name] = (lib, "", 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(source_path(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, cmd, proc, time.perf_counter()))
    failures = []
    for name, lib, tmp, cmd, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        out[name] = (lib, log, seconds)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel's library."""
    path, _, _ = compile_libraries([name])[name]
    lib = ctypes.CDLL(str(path))
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = KERNELS[name]
    launch.restype = _CI
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [_CI]
    err.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call ``<name>_launch(*args)`` and raise on a CUDA error code."""
    lib = load_library(name)
    err = getattr(lib, f"{name}_launch")(*args)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode(errors="replace")
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
