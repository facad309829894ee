"""Descriptors: ColorCHLAC / C3-HLAC (117, 981, per subdivision), RSD
surface types with GRSD and VOSCH, PFH, GFPFH, 2-D HLAC, and the
cloud → descriptor extraction pipelines."""
from mapping_private_tpu_torch.features.colorchlac import (
    calc_auto_threshold,
    calc_scene_auto_threshold,
    colorchlac117,
    colorchlac117_subdiv,
    colorchlac981,
    colorchlac981_subdiv,
    occupied_count_subdiv,
    rgb_voxel_histograms,
    rotate_feature_981,
)
from mapping_private_tpu_torch.features.extract import (
    extract_colorchlac117,
    extract_colorchlac981,
    extract_grsd_cchlac,
    voxel_types,
    voxelize_for_features,
)
from mapping_private_tpu_torch.features.hlac2d import hlac_bin, hlac_color, hlac_gray
from mapping_private_tpu_torch.features.pfh import pair_features, pfh_histograms
from mapping_private_tpu_torch.features.rsd import (
    get_type,
    grsd20_from_types,
    grsd325_from_types,
    plus_grsd110_from_types,
    rsd_radii,
    vosch,
)

__all__ = [
    "calc_auto_threshold",
    "calc_scene_auto_threshold",
    "rgb_voxel_histograms",
    "colorchlac117",
    "colorchlac981",
    "colorchlac117_subdiv",
    "colorchlac981_subdiv",
    "occupied_count_subdiv",
    "rotate_feature_981",
    "rsd_radii",
    "get_type",
    "grsd20_from_types",
    "grsd325_from_types",
    "plus_grsd110_from_types",
    "vosch",
    "pfh_histograms",
    "pair_features",
    "hlac_bin",
    "hlac_gray",
    "hlac_color",
    "extract_grsd_cchlac",
    "extract_colorchlac117",
    "extract_colorchlac981",
    "voxelize_for_features",
    "voxel_types",
]
