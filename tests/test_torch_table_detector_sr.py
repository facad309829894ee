"""Port parity: models/table_detector_sr.py against the JAX package on
tests/test_table_detector_sr.py's organized scene (a 20 cm box on a table
seen obliquely, 64 × 64), with the JAX package's plane-fit uniforms
carried across.

- ``jump_edge_keep_mask``: identical.
- ``organized_normals_filtered``: ``ok`` identical; normals within 1e-4
  where the window's two smallest eigenvalues are apart (λ₂ > 1.1 λ₁ and
  λ₂ > 1e-7: the 3×3 eigenvector is ill-conditioned otherwise, see
  ROADMAP "Rank-deficient covariances").
- ``detect_table_sr``: plane within 1e-4, every mask identical (table
  inliers, jump-edge mask, objects), sizes equal, centres within 1e-5.
- ``split_table_detection``: the same polygon and object clouds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)
from test_table_detector_sr import BOX_HI, H, TABLE_Z, VP, W, _organized_scene

from mapping_private_tpu.models import table_detector_sr as jsr
from mapping_private_tpu_torch.models import table_detector_sr as tsr

CFG = dict(min_table_inliers=30, object_cluster_min_pts=20)


def _inputs(invalid_every=0):
    pts, in_box = _organized_scene()
    valid = np.ones((H, W), bool)
    if invalid_every:
        valid.reshape(-1)[::invalid_every] = False
    return pts, valid, in_box


@pytest.mark.parametrize("step", [1, 2])
def test_jump_edge_mask_matches_jax(step):
    pts, valid, _ = _inputs(invalid_every=29)
    want = np.asarray(jsr.jump_edge_keep_mask(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(VP), step=step))
    got = tsr.jump_edge_keep_mask(torch.from_numpy(pts), torch.from_numpy(valid), torch.from_numpy(VP), step=step)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.8 < want.mean() < 0.99


def test_shift2d_is_a_roll_without_wrap():
    a = torch.arange(5 * 7 * 2, dtype=torch.float32).reshape(5, 7, 2)
    for dy, dx in ((0, 0), (1, -2), (-3, 4), (5, 0), (0, -7), (2, 6)):
        want = np.asarray(jsr._shift2d(jnp.asarray(a.numpy()), dy, dx))
        np.testing.assert_array_equal(tsr._shift2d(a, dy, dx).numpy(), want)


def _window_eigs(pts, keep, k=2, max_z=0.03):
    """Two smallest eigenvalues of each pixel's filtered window
    covariance, in float64 (independent of both packages' solvers)."""
    P = pts.astype(np.float64)
    pad = np.pad(P, ((k, k), (k, k), (0, 0)))
    wpad = np.pad(keep.astype(np.float64), k)
    S0, S1, S2 = np.zeros((H, W)), np.zeros((H, W, 3)), np.zeros((H, W, 3, 3))
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            nb = pad[k - dy:k - dy + H, k - dx:k - dx + W]
            wn = wpad[k - dy:k - dy + H, k - dx:k - dx + W] * (np.abs(nb[..., 2] - P[..., 2]) <= max_z)
            S0 += wn
            S1 += nb * wn[..., None]
            S2 += nb[..., :, None] * nb[..., None, :] * wn[..., None, None]
    c = np.maximum(S0, 1.0)
    mean = S1 / c[..., None]
    ev = np.linalg.eigvalsh(S2 / c[..., None, None] - mean[..., :, None] * mean[..., None, :])
    return ev[..., 0], ev[..., 1]


def test_organized_normals_match_jax():
    pts, valid, _ = _inputs()
    nj, oj = (np.asarray(a) for a in jsr.organized_normals_filtered(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(VP)))
    nt, ot = (a.numpy() for a in tsr.organized_normals_filtered(
        torch.from_numpy(pts), torch.from_numpy(valid), torch.from_numpy(VP)))
    np.testing.assert_array_equal(ot, oj)
    keep = np.asarray(jsr.jump_edge_keep_mask(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(VP)))
    l1, l2 = _window_eigs(pts, keep)
    gap = oj & (l2 > 1.1 * l1) & (l2 > 1e-7)
    assert gap.mean() > 0.7
    np.testing.assert_allclose(nt[gap], nj[gap], rtol=0, atol=1e-4)
    assert (nt[~ot] == 0).all()


@pytest.mark.parametrize("key", [0, 7])
def test_detect_table_sr_matches_jax(key):
    pts, valid, in_box = _inputs()
    k = jax.random.PRNGKey(key)
    dj = jsr.detect_table_sr(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(VP), k, jsr.SRDetectorConfig(**CFG))
    u = torch.tensor(np.asarray(jax.random.uniform(k, (256, 3))))
    dt = tsr.detect_table_sr(torch.from_numpy(pts), torch.from_numpy(valid), torch.from_numpy(VP),
                             cfg=tsr.SRDetectorConfig(**CFG), u=u)
    assert bool(dt.found) == bool(dj.found) is True
    np.testing.assert_allclose(dt.plane.numpy(), np.asarray(dj.plane), rtol=0, atol=1e-4)
    for f in ("table_inliers", "keep_mask", "object_masks", "object_sizes"):
        np.testing.assert_array_equal(getattr(dt, f).numpy(), np.asarray(getattr(dj, f)), err_msg=f)
    for f in ("table_min", "table_max", "object_centers"):
        np.testing.assert_allclose(getattr(dt, f).numpy(), np.asarray(getattr(dj, f)), rtol=0, atol=1e-5,
                                   err_msg=f)
    # the outcome the JAX test asserts: the table and the box as one object
    assert abs(-float(dt.plane[3]) / float(dt.plane[2]) - TABLE_Z) < 0.01
    sizes = dt.object_sizes.numpy()
    assert (sizes > 0).sum() == 1
    m = dt.object_masks.numpy()[np.argmax(sizes)].reshape(H, W)
    assert m[in_box].sum() == m.sum() > 100
    assert TABLE_Z + 0.05 < dt.object_centers.numpy()[np.argmax(sizes)][2] < BOX_HI[2]

    pj, cj = jsr.split_table_detection(dj, jnp.asarray(pts))
    pt, ct = tsr.split_table_detection(dt, torch.from_numpy(pts))
    np.testing.assert_array_equal(pt, pj)
    assert [int(c.count()) for c in ct] == [int(c.mask.sum()) for c in cj] == [int(sizes.max())]
    np.testing.assert_array_equal(ct[0].to_numpy()["xyz"], np.asarray(cj[0].xyz)[np.asarray(cj[0].mask)])


def test_no_table_found():
    """A scene with no horizontal surface: not found, no objects."""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    wall = np.stack([np.full((H, W), 1.0), xs * 0.01, ys * 0.01 + 0.5], -1).astype(np.float32)
    dt = tsr.detect_table_sr(torch.from_numpy(wall), torch.ones(H, W, dtype=torch.bool),
                             torch.tensor([0.0, 0.3, 0.8]), torch.Generator().manual_seed(0))
    assert not bool(dt.found) and int(dt.object_sizes.sum()) == 0 and not dt.table_inliers.any()
    poly, clouds = tsr.split_table_detection(dt, torch.from_numpy(wall))
    assert poly.shape == (0, 2) and clouds == []
