"""The generators: exact repeats for a seed, rings that close."""
import numpy as np
import pytest

from perfbench import harness

BENCH = harness.load_bench()
SEED = 2**31 + 17


def small(name):
    _, cfg, _ = harness.load_cell(BENCH, name)
    key = "points_per_scan" if "points_per_scan" in cfg else "points_per_frame"
    return dict(cfg, **{key: 3000})


@pytest.mark.parametrize("cell", ["scan20k.pairs", "tabletop.frames"])
def test_ring_repeats_for_a_seed_and_differs_across_seeds(cell):
    cfg = small(cell)
    scene = harness.load_module("scenes", cfg["scene"])
    a, b, c = scene.make_ring(cfg, SEED), scene.make_ring(cfg, SEED), scene.make_ring(cfg, SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a["frames"], b["frames"]))
    assert not np.array_equal(a["frames"][0], c["frames"][0])
    assert len(a["frames"]) == cfg["ring_frames"]
    assert all(f.dtype == np.float32 and f.shape[1] == 3 for f in a["frames"])


def _rot_angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("seed", [0, SEED, 2**31 + 4321])
def test_scan_ring_closes_within_the_step_limits(seed):
    _, cfg, _ = harness.load_cell(BENCH, "scan20k.pairs")
    P = harness.load_module("scenes", "surface_scans").ring_poses(cfg, seed)
    steps = [np.linalg.inv(P[j]) @ P[(j + 1) % len(P)] for j in range(len(P))]
    trans = [np.linalg.norm(S[:3, 3]) for S in steps]
    rot = [_rot_angle(S[:3, :3]) for S in steps]
    assert max(trans) <= cfg["max_step_m"] and max(rot) <= cfg["max_step_rad"]
    # the wrap step (last -> first) is no larger than the largest other step
    assert trans[-1] <= max(trans[:-1]) * (1 + 1e-9) and rot[-1] <= max(rot[:-1]) * (1 + 1e-9)
    assert min(trans) > 0.5 * cfg["max_step_m"] / 2


def test_scans_sample_the_surface_afresh_from_their_pose():
    cfg = small("scan20k.pairs")
    ring = harness.load_module("scenes", "surface_scans").make_ring(cfg, SEED)
    s = cfg["surface"]
    for scan, P in zip(ring["frames"][:3], ring["poses"][:3]):
        w = scan.astype(np.float64) @ P[:3, :3].T + P[:3, 3]
        z = s["a"] * np.sin(s["fx"] * w[:, 0]) + s["b"] * np.cos(s["fy"] * w[:, 1])
        assert np.abs(w[:, 2] - z).max() < 1e-5
    assert not np.allclose(ring["frames"][0][:10], ring["frames"][1][:10], atol=0.05)


def test_tabletop_ring_moves_out_and_back():
    cfg = small("tabletop.frames")
    ring = harness.load_module("scenes", "tabletop").make_ring(cfg, SEED)
    d = np.diff(np.vstack([ring["shifts"], ring["shifts"][:1]]), axis=0)
    assert np.allclose(np.abs(d), np.abs(cfg["shift_per_frame_m"]))
    f = ring["frames"][0]
    assert np.isclose(f[:, 2], cfg["scene_geometry"]["table_z_m"], atol=0.01).sum() > 0.03 * len(f)
