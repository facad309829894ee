"""Build the native host library with g++ at first use (no pybind11).

Counterpart of ``mapping_private_tpu/native/build.py``.  The port keeps
its own copy of the source, ``native/src/mapping_native.cpp``.  The
library lands in ``build/torch_native/`` at the repository root, keyed by
a hash of the source and the flags, so an edit builds anew.  A failed
build (no compiler) returns None and the callers use their numpy paths.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys
import threading

_HERE = pathlib.Path(__file__).resolve().parent
SRC = _HERE / "src" / "mapping_native.cpp"
BUILD_DIR = _HERE.parent.parent / "build" / "torch_native"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_lock = threading.Lock()


def library_path() -> pathlib.Path:
    key = hashlib.sha256(" ".join(FLAGS).encode() + b"\0" + SRC.read_bytes())
    return BUILD_DIR / f"mapping_native-{key.hexdigest()[:16]}.so"


def build_library(verbose: bool = False) -> str | None:
    """Compile (if needed) and return the library's path, or None when
    the build fails."""
    try:
        path = library_path()
    except OSError:
        return None
    if path.exists():
        return str(path)
    with _lock:
        if path.exists():
            return str(path)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            if verbose:
                print(res.stderr, file=sys.stderr)
            return None
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
        return str(path)
