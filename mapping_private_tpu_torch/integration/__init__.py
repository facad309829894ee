"""Service, pose-registry and COP bridges; shelf-rack perception."""
from mapping_private_tpu_torch.integration.services import (
    ServiceRegistry,
    JloRegistry,
    LocatedObject,
    CopBridge,
)
from mapping_private_tpu_torch.integration.shopping import (
    cluster_objects_on_racks,
    infer_object_location,
)

__all__ = [
    "ServiceRegistry",
    "JloRegistry",
    "LocatedObject",
    "CopBridge",
    "cluster_objects_on_racks",
    "infer_object_location",
]
