"""Object recognition: PCA subspaces and the sliding-box subspace search."""
from mapping_private_tpu_torch.recognition.pca import (
    PCAResult,
    pca_fit,
    read_pca,
    subspace_axis,
    variance_report,
    write_pca,
)
from mapping_private_tpu_torch.recognition.search import (
    Detection,
    SceneData,
    build_scene_data,
    search_object,
    search_objects_multi,
)

__all__ = [
    "PCAResult",
    "pca_fit",
    "subspace_axis",
    "read_pca",
    "variance_report",
    "write_pca",
    "SceneData",
    "Detection",
    "build_scene_data",
    "search_object",
    "search_objects_multi",
]
