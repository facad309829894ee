"""The device policy of the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises
    (nothing falls back to the CPU unless the caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available")
    return device
