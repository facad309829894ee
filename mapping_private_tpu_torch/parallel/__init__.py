"""Sharded steps over ``torch.distributed`` ranks: device meshes, sharded
registration and scan-to-map ICP, and a multi-rank dry run
(``parallel.dryrun``)."""
from mapping_private_tpu_torch.parallel.mesh import make_mesh
from mapping_private_tpu_torch.parallel.distributed import (
    make_sharded_registration_step,
    make_sharded_map_icp_step,
    make_sharded_map_icp_step_tiled,
    size_map_lattice,
)

__all__ = [
    "make_mesh",
    "make_sharded_registration_step",
    "make_sharded_map_icp_step",
    "make_sharded_map_icp_step_tiled",
    "size_map_lattice",
]
