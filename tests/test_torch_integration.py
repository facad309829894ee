"""Port parity: integration/services.py and integration/shopping.py against
the JAX package.

The service, pose and COP bridges are the same host code: registries
and queries compare equal, poses within 1e-12.  ``cluster_objects_on_racks``
clusters on the port's ops, on the cloud's device (the CPU here): the same
clusters, point for point, in the same order, on a synthetic three-shelf
rack."""
import inspect
import types

import numpy as np
import pytest
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.core import PointCloud as JCloud
from mapping_private_tpu.integration import services as jsvc, shopping as jshop
from mapping_private_tpu_torch.core.cloud import PointCloud as TCloud
from mapping_private_tpu_torch.integration import services as tsvc, shopping as tshop

RACKS = (0.4, 0.9, 1.4)


def rack_cloud(seed=0):
    """Three shelf boards 1 m wide with 2, 3 and 1 objects standing on
    them, and a few stray points between the shelves."""
    rng = np.random.default_rng(seed)
    parts = []
    for h, xs in zip(RACKS, ((0.2, 0.6), (0.15, 0.45, 0.8), (0.5,))):
        parts.append(np.column_stack([rng.uniform(0, 1, 400), rng.uniform(0, 0.4, 400), np.full(400, h)]))
        for x in xs:
            size = rng.uniform(0.05, 0.1, 3)
            parts.append(np.column_stack([rng.uniform(x - size[0] / 2, x + size[0] / 2, 150),
                                          rng.uniform(0.2 - size[1] / 2, 0.2 + size[1] / 2, 150),
                                          h + rng.uniform(0.01, size[2] + 0.01, 150)]))
    parts.append(np.column_stack([rng.uniform(0, 1, 10), rng.uniform(0, 0.4, 10), rng.uniform(0.3, 1.6, 10)]))
    xyz = np.concatenate(parts).astype(np.float32)
    return xyz[rng.permutation(len(xyz))]


@pytest.mark.parametrize("seed,tolerance,min_pts", [(0, 0.03, 30), (1, 0.02, 50)])
def test_cluster_objects_on_racks_matches(seed, tolerance, min_pts):
    xyz = rack_cloud(seed)
    got = tshop.cluster_objects_on_racks(TCloud.from_numpy(xyz, device="cpu"), RACKS, tolerance=tolerance,
                                         min_pts=min_pts)
    want = jshop.cluster_objects_on_racks(JCloud.from_numpy(xyz), RACKS, tolerance=tolerance, min_pts=min_pts)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    assert [len(got[r]) for r in range(3)] == [len(want[r]) for r in range(3)] == [2, 3, 1]
    for r in range(3):
        for a, b in zip(got[r], want[r]):
            np.testing.assert_array_equal(a, b)
    # the placement rule on the port's occupancy, as in the JAX package
    for product in ("heavy", "fragile", "default", "unknown"):
        rt, pt = tshop.infer_object_location(product, got)
        rj, pj = jshop.infer_object_location(product, want)
        assert rt == rj
        np.testing.assert_array_equal(pt, pj)
    assert tshop.infer_object_location("x", {}, rules={"default": 2}) == (2, pytest.approx(np.array([0.5, 0, 0])))


def test_cluster_objects_on_racks_runs_on_the_clouds_device():
    """The cloud fixes the device, as in the JAX package: the same
    parameters, and the clusters come back as the cloud's f32 points."""
    assert list(inspect.signature(tshop.cluster_objects_on_racks).parameters) == \
        list(inspect.signature(jshop.cluster_objects_on_racks).parameters)
    xyz = rack_cloud(2)
    got = tshop.cluster_objects_on_racks(TCloud.from_numpy(xyz, device="cpu"), RACKS[:1])
    assert len(got[0]) == 2
    for c in got[0]:
        assert isinstance(c, np.ndarray) and c.dtype == np.float32 and c.shape[1] == 3
        assert np.isin(c.view("V12").ravel(), xyz.view("V12").ravel()).all()


def pose(rz, t):
    c, s = np.cos(rz), np.sin(rz)
    T = np.eye(4)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = t
    return T


def test_jlo_registry_matches():
    regs = tsvc.JloRegistry(), jsvc.JloRegistry()
    out = []
    for reg in regs:
        table = reg.update("/table", pose(0.3, [1.0, 2.0, 0.7]), cov=np.eye(6) * 0.01)
        cup = reg.update("/cup", pose(-0.2, [0.1, 0.05, 0.05]), parent_id=table.lo_id)
        plate = reg.update("/plate", pose(1.0, [0.3, -0.2, 0.02]), parent_id=table.lo_id)
        moved = reg.update("/cup", pose(0.1, [0.2, 0.05, 0.05]), parent_id=table.lo_id)
        assert moved.lo_id == cup.lo_id and reg.namequery("/cup") is moved
        out.append([reg.framequery(cup.lo_id), reg.framequery(cup.lo_id, plate.lo_id),
                    reg.framequery(table.lo_id), [table.lo_id, cup.lo_id, plate.lo_id]])
        reg.delete(plate.lo_id)
        with pytest.raises(KeyError):
            reg.namequery("/plate")
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_allclose(out[0][0][:3, 3], pose(0.3, [1.0, 2.0, 0.7])[:3, :3] @ [0.2, 0.05, 0.05]
                               + [1.0, 2.0, 0.7], atol=1e-12)  # the cup in the world: table ∘ cup
    reg = tsvc.JloRegistry()
    a = reg.update("/a", np.eye(4))
    b = reg.update("/b", np.eye(4), parent_id=a.lo_id)
    a.parent_id = b.lo_id
    with pytest.raises(ValueError, match="cycle"):
        reg.framequery(b.lo_id)


def test_service_registry_and_cop_bridge_match():
    for mod in (tsvc, jsvc):
        reg = mod.ServiceRegistry()
        reg.register("/intersect_poly", lambda a, b=1: a + b)
        assert reg.exists("/intersect_poly") and not reg.exists("/nope")
        assert reg.call("/intersect_poly", 2, b=5) == 7
        with pytest.raises(KeyError, match="not advertised"):
            reg.call("/nope")
    objs = [types.SimpleNamespace(name="cup", center=np.array([0.1, 0.2, 0.8])),
            types.SimpleNamespace(name="plate", center=np.array([0.5, 0.2, 0.75]))]
    table = types.SimpleNamespace(latest=lambda: types.SimpleNamespace(objects=objs))
    empty = types.SimpleNamespace(latest=lambda: None)
    memory = types.SimpleNamespace(tables=[table, empty])
    queries = [np.array([0.12, 0.2, 0.8]), np.array([0.45, 0.25, 0.75]), np.array([2.0, 2.0, 2.0])]
    got = tsvc.CopBridge(memory, match_dist=0.1).query(queries)
    assert got == jsvc.CopBridge(memory, match_dist=0.1).query(queries) == ["cup", "plate", None]
    assert tsvc.CopBridge().query(queries) == [None] * 3
