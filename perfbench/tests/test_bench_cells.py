"""Each cell driven end to end on the CPU at a small size: the reference
agrees with the port, nothing of JAX is loaded, and each fault that the
cell can have turns ``correct`` false.

The runs go through ``harness.run`` with ``device="cpu"``: everything of
a run but the look for a chip, the timing readers that need the card,
and the traced run's profile."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness

BENCH = harness.load_bench()
SEED = 2**31 + 99
SMALL = {"scan20k.pairs": {"points_per_scan": 2000, "ring_frames": 8},
         "tabletop.frames": {"points_per_frame": 20000, "ring_frames": 4}}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run_small(cell, seconds=0.5):
    _, cfg, _ = harness.load_cell(BENCH, cell)
    return harness.run(cell, SEED, seconds, False, "cpu", cfg=dict(cfg, **SMALL[cell]), bench=BENCH)


@pytest.mark.parametrize("cell", list(SMALL))
def test_reference_agrees_with_the_port(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_cell_run_loads_nothing_of_jax(cell):
    code = f"""
import json, sys, torch
torch.set_num_threads(2)
sys.path.insert(0, {str(harness.ROOT)!r})
from perfbench import harness
bench = harness.load_bench()
_, cfg, _ = harness.load_cell(bench, {cell!r})
res = harness.run({cell!r}, 5, 0.2, False, "cpu", cfg=dict(cfg, **{SMALL[cell]!r}), bench=bench)
print(json.dumps({{"correct": res["correct"], "loaded": harness.banned_modules(),
                  "port": "mapping_private_tpu_torch" in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=harness.ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "loaded": [], "port": True}


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mapping_private_tpu_torch_x", sys)
    assert "mapping_private_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "mapping_private_tpu.ops", sys)
    assert harness.banned_modules() == ["mapping_private_tpu"]


# -- faults: each breaks the timed path underneath and must read as not correct
def _icp_unchanged(orig):
    def fn(*a, **k):
        res = orig(*a, **k)
        return type(res)(transform=torch.eye(4), rmse=res.rmse, num_corr=res.num_corr,
                         per_iter_rmse=res.per_iter_rmse)
    return fn


def _icp_altered(orig):
    def fn(*a, **k):
        res = orig(*a, **k)
        T = res.transform.clone()
        T[0, 3] += 2e-3
        return type(res)(transform=T, rmse=res.rmse, num_corr=res.num_corr,
                         per_iter_rmse=res.per_iter_rmse)
    return fn


def _denoise_unchanged(orig):
    def fn(cloud, **k):
        _, valid = orig(cloud, **k)
        return cloud, valid
    return fn


def _denoise_half(orig):
    def fn(cloud, **k):
        half = cloud.mask.clone()
        half[1::2] = False
        out, valid = orig(cloud.select(half), **k)
        return out, valid
    return fn


def _detect_altered(orig):
    def fn(*a, **k):
        det, down = orig(*a, **k)
        plane = det.plane.clone()
        plane[3] += 0.005
        centers = det.object_centers.clone()
        centers[:, 0] += 0.01
        import dataclasses
        return dataclasses.replace(det, plane=plane, object_centers=centers), down
    return fn


def _all_boxes(orig):
    def fn(*a, **k):
        obj = orig(*a, **k)
        obj.object_type, obj.cylinder = "box", None
        return obj
    return fn


def _cylinder_altered(orig):
    def fn(*a, **k):
        obj = orig(*a, **k)
        if obj.cylinder is not None:
            obj.cylinder = dict(obj.cylinder, radius=obj.cylinder["radius"] + 5e-3)
        return obj
    return fn


def _memory_unchanged(orig):
    def fn(self, *a, **k):
        if self.tables:  # the first observation only: later ones leave the state as it was
            self.tables[0].instances.append(self.tables[0].instances[-1])
            return 0
        return orig(self, *a, **k)
    return fn


FAULTS = [
    ("scan20k.pairs", "mapping_private_tpu_torch.registration.icp", "icp_point_to_plane", _icp_unchanged),
    ("scan20k.pairs", "mapping_private_tpu_torch.registration.icp", "icp_point_to_plane", _icp_altered),
    ("tabletop.frames", "mapping_private_tpu_torch.ops.filters", "remove_statistical_outliers",
     _denoise_unchanged),
    ("tabletop.frames", "mapping_private_tpu_torch.ops.filters", "remove_statistical_outliers",
     _denoise_half),
    ("tabletop.frames", "mapping_private_tpu_torch.models.table_detector", "detect_table", _detect_altered),
    ("tabletop.frames", "mapping_private_tpu_torch.models.table_memory", "TableMemory.update",
     _memory_unchanged),
    ("tabletop.frames", "mapping_private_tpu_torch.models.table_memory", "_reconstruct_object", _all_boxes),
    ("tabletop.frames", "mapping_private_tpu_torch.models.table_memory", "_reconstruct_object",
     _cylinder_altered),
]


@pytest.mark.parametrize("cell, module, attr, fault", FAULTS, ids=[f[3].__name__ for f in FAULTS])
def test_a_fault_reads_as_not_correct(monkeypatch, cell, module, attr, fault):
    import importlib

    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    monkeypatch.setattr(owner, name, fault(getattr(owner, name)))
    res = run_small(cell, seconds=0.2)
    assert not res["correct"], res["checks"]
