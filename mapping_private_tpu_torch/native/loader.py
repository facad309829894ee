"""ctypes bindings of the native host library, with numpy fallbacks.

Counterpart of ``mapping_private_tpu/native/loader.py``.  Every function
works whether or not the library built: the native path speeds up host
ingest (the role PCL's C++ PCD reader plays for the reference) and the
numpy path stands in where there is no compiler.  ``parse_floats`` rounds
each token once with ``strtof``; the numpy path parses to float64 and
rounds again to float32, which can differ in the last bit.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from mapping_private_tpu_torch.native.build import build_library

_lib: Optional[ctypes.CDLL] = None
_tried = False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = build_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    c_char_p = ctypes.c_char_p
    c_long = ctypes.c_long
    c_int = ctypes.c_int
    c_float = ctypes.c_float
    fp = ctypes.POINTER(c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.parse_floats.restype = c_long
    lib.parse_floats.argtypes = [c_char_p, c_long, fp, c_long]
    lib.parse_floats_mt.restype = c_long
    lib.parse_floats_mt.argtypes = [c_char_p, c_long, fp, c_long, c_int]
    lib.grid_keys.restype = None
    lib.grid_keys.argtypes = [fp, c_long, c_float, ip]
    lib.unpack_rgb.restype = None
    lib.unpack_rgb.argtypes = [fp, c_long, fp, fp, fp]
    _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def parse_floats(
    text: bytes, capacity: Optional[int] = None, threads: int = 0
) -> np.ndarray:
    """Whitespace-separated float parse: bytes → float32 array."""
    lib = get_lib()
    if lib is None:
        return np.array(text.split(), dtype=np.float32)
    if capacity is None:
        # upper bound: one float per 2 chars is impossible; tokens ≥ 2 bytes
        # apart on average ("0 " minimum), so len/2 + 1 always suffices
        capacity = len(text) // 2 + 1
    out = np.empty(capacity, np.float32)
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    n = lib.parse_floats_mt(
        text, len(text),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        capacity, threads,
    )
    if n < 0:
        raise ValueError("parse_floats: capacity overflow")
    return out[:n]


def grid_keys(xyz: np.ndarray, cell_size: float) -> np.ndarray:
    """Packed 30-bit grid-hash keys: 10 bits an axis, each cell index
    wrapped mod 1024."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    lib = get_lib()
    if lib is None:
        cell = np.floor(xyz / cell_size).astype(np.int64)
        m = (1 << 10) - 1
        return (
            ((cell[:, 0] & m) << 20) | ((cell[:, 1] & m) << 10) | (cell[:, 2] & m)
        ).astype(np.int32)
    keys = np.empty(len(xyz), np.int32)
    lib.grid_keys(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(xyz), np.float32(1.0 / cell_size),
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return keys


def unpack_rgb(rgbf: np.ndarray) -> tuple:
    rgbf = np.ascontiguousarray(rgbf, np.float32)
    lib = get_lib()
    if lib is None:
        v = rgbf.view(np.uint32)
        return (
            ((v >> 16) & 0xFF).astype(np.float32),
            ((v >> 8) & 0xFF).astype(np.float32),
            (v & 0xFF).astype(np.float32),
        )
    n = len(rgbf)
    r = np.empty(n, np.float32)
    g = np.empty(n, np.float32)
    b = np.empty(n, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.unpack_rgb(
        rgbf.ctypes.data_as(fp), n,
        r.ctypes.data_as(fp), g.ctypes.data_as(fp), b.ctypes.data_as(fp),
    )
    return r, g, b
