"""Shelf-rack perception: objects clustered per shelf, and a product's
place from a rule table.

Counterpart of ``mapping_private_tpu/integration/shopping.py``
(shopping_demo's cluster_objects_on_racks.cpp:103-470: band-filter the
cloud at each rack height, Euclidean-cluster the band, report each rack's
object clusters; and infer_object_location.cpp:336-350's knowledge-base
query, a plain rule table here).  The clustering runs on the cloud's
device; the clusters come back as numpy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.ops.cluster import euclidean_cluster, top_clusters
from mapping_private_tpu_torch.ops.filters import z_band_mask


def cluster_objects_on_racks(
    cloud: PointCloud,
    rack_heights: Sequence[float],
    band: float = 0.25,
    tolerance: float = 0.03,
    min_pts: int = 30,
    max_objects_per_rack: int = 8,
) -> Dict[int, List[np.ndarray]]:
    """Per rack: clusters of points in [h, h + band] above the shelf board,
    computed on the cloud's device.

    Returns {rack_index: [cluster points (P_i, 3) numpy, ...]}."""
    xyz = cloud.padded_xyz()
    xyz_np = cloud.xyz.cpu().numpy()
    out: Dict[int, List[np.ndarray]] = {}
    for ri, h in enumerate(rack_heights):
        m = z_band_mask(xyz, cloud.mask, h + 0.005, h + band)
        labels = euclidean_cluster(xyz, m, tolerance)
        member, sizes = top_clusters(labels, m, max_objects_per_rack, min_size=min_pts)
        member, sizes = member.cpu().numpy(), sizes.cpu().numpy()
        out[ri] = [xyz_np[member[oi]] for oi in range(max_objects_per_rack) if int(sizes[oi]) >= min_pts]
    return out


# The KB rules the Prolog queries encoded: product → preferred rack level
# (infer_object_location.cpp asks the knowledge base which shelf a product
# belongs on; here the mapping is explicit data).
DEFAULT_PRODUCT_RACKS: Dict[str, int] = {
    "heavy": 0,      # heavy goods on the bottom shelf
    "default": 1,
    "fragile": 2,
    "light": 2,
}


def infer_object_location(
    product_class: str,
    rack_occupancy: Dict[int, List[np.ndarray]],
    rules: Optional[Dict[str, int]] = None,
    rack_width: float = 1.0,
) -> Tuple[int, np.ndarray]:
    """Best (rack, position) for a product: its rule-preferred rack, at the
    widest free gap between existing clusters (the demo's placement pick).
    """
    rules = DEFAULT_PRODUCT_RACKS if rules is None else rules
    rack = rules.get(product_class, rules.get("default", 0))
    clusters = rack_occupancy.get(rack, [])
    # occupied intervals along the rack's x axis
    intervals = sorted(
        (float(c[:, 0].min()), float(c[:, 0].max())) for c in clusters
    )
    best_gap, best_x = -1.0, rack_width / 2
    prev = 0.0
    for lo, hi in intervals + [(rack_width, rack_width)]:
        gap = lo - prev
        if gap > best_gap:
            best_gap, best_x = gap, prev + gap / 2
        prev = max(prev, hi)
    return rack, np.array([best_x, 0.0, 0.0])
