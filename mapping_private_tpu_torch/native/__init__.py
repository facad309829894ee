"""The native host library (g++, ctypes): float parsing, grid keys, RGB unpacking."""
from mapping_private_tpu_torch.native.loader import (
    get_lib,
    native_available,
    parse_floats,
    grid_keys,
    unpack_rgb,
)

__all__ = [
    "get_lib",
    "native_available",
    "parse_floats",
    "grid_keys",
    "unpack_rgb",
]
