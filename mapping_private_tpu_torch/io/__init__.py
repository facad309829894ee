"""Host-side file I/O: PCD, meshes (VTK, DXF, PPM), the semantic map."""
from mapping_private_tpu_torch.io.pcd import load_pcd, load_pcd_arrays, save_pcd
from mapping_private_tpu_torch.io.dxf import write_dxf_mesh, read_dxf_mesh
from mapping_private_tpu_torch.io.mesh import (
    write_vtk_mesh,
    read_vtk_mesh,
    sample_mesh_points,
    virtual_view_depth,
)
from mapping_private_tpu_torch.io.semantic_map import (
    SemanticMap,
    parse_semantic_map,
    corner_frame_offset,
    map_to_boxes,
)

__all__ = [
    "load_pcd",
    "load_pcd_arrays",
    "save_pcd",
    "write_dxf_mesh",
    "read_dxf_mesh",
    "write_vtk_mesh",
    "read_vtk_mesh",
    "sample_mesh_points",
    "virtual_view_depth",
    "SemanticMap",
    "parse_semantic_map",
    "corner_frame_offset",
    "map_to_boxes",
]
