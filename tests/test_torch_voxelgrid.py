"""Port parity: core/voxelgrid.py against the JAX package.

The same seeded cloud (dead rows and points outside the grid included)
goes through both ``voxelize``s.  Counts and integer colour sums are
exact in f32 and compared bit for bit; the centroid sums (``_xyz``) are
summed in another order (``index_add_``), so they agree within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.core import PointCloud as JCloud
from mapping_private_tpu.core import voxelgrid as jvg
from mapping_private_tpu_torch.core import PointCloud, VoxelGrid
from mapping_private_tpu_torch.core import voxelgrid as tvg


def _cloud(seed, n=700, dead_every=9):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.02, 0.13, (n, 3)).astype(np.float32)  # some points outside the grid
    ch = {c: rng.integers(0, 256, n).astype(np.float32) for c in "rgb"}
    jc = JCloud.from_numpy(xyz, channels=ch)
    jc = jc.select(jnp.arange(jc.capacity) % dead_every != 0)
    jc = jc.with_channel("_xyz", jc.padded_xyz())
    tc = PointCloud.from_arrays(np.asarray(jc.xyz), np.asarray(jc.mask),
                                {k: np.asarray(v) for k, v in jc.channels.items()}, device="cpu")
    return jc, tc


@pytest.mark.parametrize("seed,dims", [(0, (10, 10, 10)), (1, (7, 12, 5)), (2, (1, 1, 1))])
def test_voxelize_matches_jax(seed, dims):
    jc, tc = _cloud(seed)
    origin = np.array([0.0, 0.005, -0.01], np.float32)
    jg = jvg.voxelize(jc, 0.01, jnp.asarray(origin), dims, channels=("r", "g", "b", "_xyz"))
    tg = tvg.voxelize(tc, 0.01, torch.tensor(origin), dims, channels=("r", "g", "b", "_xyz"))
    assert tg.dims == dims and tg.count.dtype == torch.int32
    np.testing.assert_array_equal(tg.count.numpy(), np.asarray(jg.count))
    assert int(tg.count.sum()) > 0 or dims == (1, 1, 1)
    for c in "rgb":
        assert tg.sums[c].shape == dims
        np.testing.assert_array_equal(tg.sums[c].numpy(), np.asarray(jg.sums[c]))
        np.testing.assert_array_equal(tg.mean(c).numpy(), np.asarray(jg.mean(c)))
    assert tg.sums["_xyz"].shape == dims + (3,)
    np.testing.assert_allclose(tg.mean("_xyz").numpy(), np.asarray(jg.mean("_xyz")), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tg.occupancy().numpy(), np.asarray(jg.occupancy()))
    assert float(tg.voxel_size) == pytest.approx(0.01)
    np.testing.assert_array_equal(tg.origin.numpy(), origin)


def test_dead_and_outside_rows_are_dropped():
    """Every in-range live point is counted once; nothing else is."""
    jc, tc = _cloud(3)
    dims = (15, 15, 15)
    tg = tvg.voxelize(tc, 0.01, torch.zeros(3), dims)
    xyz, live = tc.xyz.numpy(), tc.mask.numpy()
    idx = np.floor(xyz / 0.01)
    inside = live & (idx >= 0).all(1) & (idx < 15).all(1)
    assert int(tg.count.sum()) == int(inside.sum()) < int(live.sum())
    assert tg.sums == {}


def test_grid_carried_across_gives_the_same_means():
    """A JAX VoxelGrid's fields carried into the port's dataclass."""
    jc, _ = _cloud(4)
    jg = jvg.voxelize(jc, 0.02, jnp.zeros(3), (6, 6, 6), channels=("r", "_xyz"))
    tg = VoxelGrid(origin=torch.tensor(np.asarray(jg.origin)), voxel_size=torch.tensor(np.asarray(jg.voxel_size)),
                   count=torch.tensor(np.asarray(jg.count)),
                   sums={k: torch.tensor(np.asarray(v)) for k, v in jg.sums.items()})
    for name in ("r", "_xyz"):
        np.testing.assert_array_equal(tg.mean(name).numpy(), np.asarray(jg.mean(name)))
