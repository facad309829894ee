"""Host-side file I/O."""
from mapping_private_tpu_torch.io.pcd import load_pcd, load_pcd_arrays, save_pcd

__all__ = [
    "load_pcd",
    "load_pcd_arrays",
    "save_pcd",
]
