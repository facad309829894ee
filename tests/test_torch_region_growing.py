"""Port parity: ops/region_growing.py against the JAX package, same numpy
inputs through both: labels identical (integer work over the same kNN
graph; the graph's distances are compared against the tolerance, so a
neighbour lying on it could flip, and the scenes keep every gap far from
it)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.ops.normals import estimate_normals
from mapping_private_tpu.core import PointCloud
from mapping_private_tpu.ops.region_growing import region_grow as jgrow
from mapping_private_tpu_torch.ops.region_growing import region_grow as tgrow


def _scene(seed=0):
    """Two perpendicular 0.6 m planes meeting at an edge, a blob 1 m off,
    and dead rows: growable, seeded and angle-gated regions differ."""
    rng = np.random.default_rng(seed)
    a = np.column_stack([rng.uniform(0, 0.6, 300), rng.uniform(0, 0.6, 300), np.zeros(300)])
    b = np.column_stack([rng.uniform(0, 0.6, 300), np.zeros(300), rng.uniform(0.02, 0.6, 300)])
    c = rng.normal([1.8, 0.3, 0.3], 0.03, (100, 3))
    return np.vstack([a, b, c]).astype(np.float32)


def _both(xyz, mask, **kw):
    want = np.asarray(jgrow(jnp.asarray(xyz), jnp.asarray(mask), **{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}))
    got = tgrow(torch.from_numpy(xyz), torch.from_numpy(mask), **{
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    assert got.dtype == torch.int32
    return got.numpy(), want


def _cloud():
    cloud = estimate_normals(PointCloud.from_numpy(_scene()), k=10)
    mask = np.asarray(cloud.mask).copy()
    mask[::17] = False
    return np.array(cloud.padded_xyz()), mask, np.array(cloud.channel("normal"))


@pytest.mark.parametrize("gate", ["none", "grow", "seed", "angle", "grid"])
def test_region_grow_matches_jax(gate):
    xyz, mask, nrm = _cloud()
    n = len(mask)
    kw = dict(radius=0.08, k=8)
    if gate == "grow":
        kw["grow_mask"] = xyz[:, 0] < 0.45
    elif gate == "seed":
        seed = np.zeros(n, bool)
        seed[[3, 650]] = True  # plane a and the blob
        kw["seed_mask"] = seed
    elif gate == "angle":
        kw.update(normals=nrm, angle_threshold=0.3)
    elif gate == "grid":
        kw["use_grid"] = True
    got, want = _both(xyz, mask, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got[~mask] == n).all()
    n_regions = len(np.unique(got[got < n]))
    assert {"none": 2, "grow": 1, "seed": 2, "angle": 3, "grid": 2}[gate] <= n_regions
