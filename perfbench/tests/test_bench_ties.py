"""The tabletop reference's ties: decided as the judged side decided them,
and only within their tolerance."""
import math

import numpy as np
import pytest
import torch

from perfbench import harness

BENCH = harness.load_bench()
REF = harness.load_module("references", "tabletop_frames")
SEED = 2**31 + 23


@pytest.fixture(scope="module")
def scene():
    _, cfg, _ = harness.load_cell(BENCH, "tabletop.frames")
    cfg = dict(cfg, points_per_frame=40000, ring_frames=2)
    xyz = torch.as_tensor(harness.load_module("scenes", "tabletop").make_ring(cfg, SEED)["frames"][0])
    u = np.random.default_rng(SEED).random((cfg["detector"]["max_table_candidates"],
                                             cfg["detector"]["sac_hypotheses"], 3))
    return cfg, xyz.double(), u


def test_a_gate_tie_follows_the_judged_voxel_and_nothing_else_does(scene, monkeypatch):
    cfg, xyz, u = scene
    own = REF.detect(xyz, u, cfg["detector"])
    assert own["found"] and own["members"].any()
    flip = int(np.nonzero(own["members"])[0][0])
    follow = own["members"].copy()
    follow[flip] = False
    # that voxel lies far from every gate: its own decision stands
    kept = REF.detect(xyz, u, cfg["detector"], follow)
    assert kept["gate_ties"] == 0 and np.array_equal(kept["members"], own["members"])
    # every voxel a tie: the judged side's decision is taken
    monkeypatch.setattr(REF, "GATE_TIE_M", math.inf)
    tied = REF.detect(xyz, u, cfg["detector"], follow)
    assert tied["gate_ties"] == 1 and not tied["members"][flip]


def test_a_cylinder_tie_takes_the_judged_axis_only_within_its_tolerance(monkeypatch):
    g = torch.Generator().manual_seed(SEED)
    th, z = torch.rand(400, generator=g, dtype=torch.float64) * 2 * math.pi, torch.rand(400, generator=g, dtype=torch.float64) * 0.2
    p = torch.stack([0.05 * torch.cos(th), 0.05 * torch.sin(th), z], 1)
    nrm = torch.stack([torch.cos(th), torch.sin(th), 0 * th], 1) + 0.05 * torch.randn(400, 3, generator=g, dtype=torch.float64)
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    u = torch.rand((64, 2), generator=g)
    best = REF.cylinder(p, nrm, u, 0.01)
    tilted = np.array([0.0, math.sin(0.3), math.cos(0.3)])
    # the best hypothesis is taken while no other lies within CYL_TIE of it
    monkeypatch.setattr(REF, "CYL_TIE", 0.0)
    strict = REF.cylinder(p, nrm, u, 0.01, tilted)
    assert strict[4] == 0.0 and np.allclose(strict[1], best[1])
    # every hypothesis a tie: the one whose axis is nearest the judged axis
    monkeypatch.setattr(REF, "CYL_TIE", 2.0)
    loose = REF.cylinder(p, nrm, u, 0.01, tilted)
    assert loose[4] > 0.0
    assert abs(float(np.dot(loose[1], tilted))) > abs(float(np.dot(best[1], tilted)))


def test_a_cylinder_tie_at_float32_rounding_is_followed_and_a_wider_gap_is_not(monkeypatch):
    # the case read on an H100 (seed 3172000012, window frame 230): the
    # judged pick 6.7e-5 of the best score short of it, a gap that rounding
    # the object's centroids to float32 opens; a gap of 5e-4 is a worse fit
    # and stands
    g = torch.Generator().manual_seed(SEED)
    p = torch.rand((200, 3), generator=g, dtype=torch.float64) * 0.1
    nrm = torch.nn.functional.normalize(torch.randn((200, 3), generator=g, dtype=torch.float64), dim=1)
    score = torch.tensor([100.0, 100.0 * (1 - 6.7e-5), 100.0 * (1 - 5e-4)], dtype=torch.float64)
    axes = torch.eye(3, dtype=torch.float64)
    hyps = (score, axes, torch.zeros((3, 3), dtype=torch.float64), torch.full((3,), 0.05, dtype=torch.float64))
    monkeypatch.setattr(REF, "cylinder_hypotheses", lambda *a: hyps)
    u = torch.zeros((3, 2))
    near = REF.cylinder(p, nrm, u, 0.01, axes[1].numpy())
    assert np.allclose(near[1], axes[1].numpy()) and near[4] == pytest.approx(6.7e-5)
    far = REF.cylinder(p, nrm, u, 0.01, axes[2].numpy())
    assert not np.allclose(far[1], axes[2].numpy()) and far[4] <= REF.CYL_TIE
