"""PCD point-cloud file I/O (host-side numpy).

Counterpart of ``mapping_private_tpu/io/pcd.py``: reads modern
``.PCD v.5+`` (FIELDS/SIZE/TYPE/COUNT, DATA ascii or binary) and the
legacy ``COLUMNS`` format, unpacks packed-float ``rgb`` into r/g/b, and
turns multi-COUNT fields into (N, C) channels.  ASCII bodies are parsed
by the native library (``native.loader.parse_floats``, numpy where it
could not be built).  Device ingestion goes through
``PointCloud.from_numpy``.
"""
from __future__ import annotations

import io as _io
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.native.loader import parse_floats

_TYPE_MAP = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
}


def _unpack_rgb(rgb_f32: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    bits = rgb_f32.astype(np.float32).view(np.uint32)
    r = ((bits >> 16) & 0xFF).astype(np.float32)
    g = ((bits >> 8) & 0xFF).astype(np.float32)
    b = (bits & 0xFF).astype(np.float32)
    return r, g, b


def pack_rgb(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    """r, g, b in [0, 255] → PCL's packed-float rgb: the bits
    (r<<16)|(g<<8)|b reinterpreted as float32 (``_unpack_rgb``'s inverse)."""
    bits = (
        (np.clip(r, 0, 255).astype(np.uint32) << 16)
        | (np.clip(g, 0, 255).astype(np.uint32) << 8)
        | np.clip(b, 0, 255).astype(np.uint32)
    )
    return bits.view(np.float32)


def load_pcd_arrays(path: str) -> Dict[str, np.ndarray]:
    """Parse a PCD file into named numpy arrays (one key per field; packed
    rgb expanded into r/g/b as well as kept raw)."""
    with open(path, "rb") as f:
        raw = f.read()

    # Header is ASCII lines up to and including the DATA line.
    pos = 0
    data_kind = fields = sizes = types = counts = npoints = None
    width = height = None
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl].decode("ascii", errors="replace").strip()
        pos = nl + 1
        if not line or line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        key = key.upper()
        vals = rest.split()
        if key in ("FIELDS", "COLUMNS"):
            fields = vals
        elif key == "SIZE":
            sizes = [int(v) for v in vals]
        elif key == "TYPE":
            types = vals
        elif key == "COUNT":
            counts = [int(v) for v in vals]
        elif key == "POINTS":
            npoints = int(vals[0])
        elif key == "WIDTH":
            width = int(vals[0])
        elif key == "HEIGHT":
            height = int(vals[0])
        elif key == "DATA":
            data_kind = vals[0].lower()
            break
    if fields is None or data_kind is None:
        raise ValueError(f"{path}: not a PCD file (no FIELDS/COLUMNS + DATA)")
    if npoints is None:
        if width is None or height is None:
            raise ValueError(f"{path}: PCD header has neither POINTS nor WIDTH/HEIGHT")
        npoints = width * height
    nf = len(fields)
    if counts is None:
        counts = [1] * nf
    if types is None:
        types = ["F"] * nf
        sizes = [4] * nf
    dtypes = [_TYPE_MAP[(t, s)] for t, s in zip(types, sizes)]

    out: Dict[str, np.ndarray] = {}
    if data_kind == "ascii":
        # the native multithreaded strtof parser, as in the JAX package
        # (numpy inside when the library could not be built)
        flat = parse_floats(raw[pos:]).astype(np.float64)
        row_len = sum(counts)
        if flat.size < npoints * row_len:
            raise ValueError(f"{path}: ascii body truncated")
        flat = flat[: npoints * row_len].reshape(npoints, row_len)
        col = 0
        for name, cnt, dt in zip(fields, counts, dtypes):
            block = flat[:, col : col + cnt]
            col += cnt
            arr = block[:, 0] if cnt == 1 else block
            out[name] = arr.astype(np.float32 if dt == np.float32 else dt)
            if name == "rgb" and cnt == 1:
                # ascii rgb may be written as packed-int-as-float
                out["rgb_packed"] = arr.astype(np.float32)
    elif data_kind == "binary":
        struct_fields = []
        for name, cnt, dt in zip(fields, counts, dtypes):
            struct_fields.append((name, dt, (cnt,)) if cnt > 1 else (name, dt))
        rec = np.dtype(struct_fields)
        # Old PCL pads the header to a page boundary before the binary
        # blob; robustly, the data is the last npoints*itemsize bytes.
        start = len(raw) - rec.itemsize * npoints
        if start < pos:
            raise ValueError(f"{path}: binary body truncated")
        table = np.frombuffer(raw[start:], dtype=rec, count=npoints)
        for name in fields:
            out[name] = np.array(table[name])
    else:
        raise ValueError(f"{path}: unsupported DATA kind {data_kind}")

    if "rgb" in out and out["rgb"].ndim == 1:
        out["r"], out["g"], out["b"] = _unpack_rgb(out["rgb"].astype(np.float32))
    return out


def load_pcd(
    path: str,
    capacity: Optional[int] = None,
    capacity_bucket: Optional[int] = None,
    *,
    device: torch.device | str,
) -> PointCloud:
    """Load a PCD file into a padded PointCloud on ``device``.

    xyz fields become positions; every other field becomes a channel.
    Rows with non-finite xyz (Kinect NaNs) are dropped before padding.
    capacity_bucket rounds the capacity up to its multiple.
    """
    arrays = load_pcd_arrays(path)
    if not all(k in arrays for k in ("x", "y", "z")):
        raise ValueError(f"{path}: no x/y/z fields (feature-only PCD?)")
    xyz = np.stack([arrays.pop("x"), arrays.pop("y"), arrays.pop("z")], axis=-1)
    xyz = xyz.astype(np.float32)
    finite = np.isfinite(xyz).all(axis=1)
    xyz = xyz[finite]
    channels = {
        k: np.asarray(v, np.float32)[finite]
        for k, v in arrays.items()
        if k not in ("rgb", "rgb_packed")
    }
    if capacity is None and capacity_bucket:
        n = len(xyz)
        capacity = max(capacity_bucket, -(-n // capacity_bucket) * capacity_bucket)
    return PointCloud.from_numpy(xyz, channels, capacity, device=device)


def save_pcd(path: str, cloud_or_arrays, ascii_fmt: str = "%.6f") -> None:
    """Write a v.7 ascii PCD.  Accepts a PointCloud or a dict of arrays
    with key 'xyz' (N,3) plus optional per-point channels."""
    if isinstance(cloud_or_arrays, PointCloud):
        data = cloud_or_arrays.to_numpy()
    else:
        data = dict(cloud_or_arrays)
    xyz = np.asarray(data.pop("xyz"), np.float32)
    n = xyz.shape[0]
    names = ["x", "y", "z"]
    cols = [xyz[:, 0], xyz[:, 1], xyz[:, 2]]
    counts = [1, 1, 1]
    for k, v in data.items():
        v = np.asarray(v, np.float32)
        names.append(k)
        cols.append(v)
        counts.append(1 if v.ndim == 1 else v.shape[1])
    buf = _io.StringIO()
    buf.write("# .PCD v.7 - Point Cloud Data file format\n")
    buf.write("FIELDS " + " ".join(names) + "\n")
    buf.write("SIZE " + " ".join("4" for _ in names) + "\n")
    buf.write("TYPE " + " ".join("F" for _ in names) + "\n")
    buf.write("COUNT " + " ".join(str(c) for c in counts) + "\n")
    buf.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n")
    mat = np.concatenate([c[:, None] if c.ndim == 1 else c for c in cols], axis=1)
    np.savetxt(buf, mat, fmt=ascii_fmt)
    with open(path, "w") as f:
        f.write(buf.getvalue())
