"""Port parity: ops/triangulation.py against the JAX package on an
organized depth grid with a depth discontinuity and invalid pixels:
triangles and their validity identical (edge lengths are compared with
``max_edge``, and no edge of the scene lies within 1e-4 of it), and
``compact_mesh`` the same vertices and faces."""
import jax.numpy as jnp
import numpy as np
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)

from mapping_private_tpu.ops import triangulation as jtri
from mapping_private_tpu_torch.ops import triangulation as ttri


def _grid(h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = np.where(xs < w // 2, 1.0, 1.3) + rng.normal(0, 1e-3, (h, w))  # a 0.3 m step
    pts = np.stack([xs * 0.01, ys * 0.01, z], -1).astype(np.float32)
    valid = rng.uniform(size=(h, w)) > 0.05
    return pts, valid


def test_triangulate_matches_jax():
    pts, valid = _grid()
    tj, oj = (np.asarray(a) for a in jtri.triangulate_depth_image(jnp.asarray(pts), jnp.asarray(valid)))
    tt_, ot = ttri.triangulate_depth_image(torch.from_numpy(pts), torch.from_numpy(valid))
    assert tt_.dtype == torch.int32 and tt_.shape == (2 * 23 * 31, 3)
    np.testing.assert_array_equal(tt_.numpy(), tj)
    np.testing.assert_array_equal(ot.numpy(), oj)
    assert 0.5 < oj.mean() < 0.95  # the step and the holes drop triangles
    e = pts.reshape(-1, 3)
    lens = np.linalg.norm(e[tj[:, [0, 1, 2]]] - e[tj[:, [1, 2, 0]]], axis=-1)
    assert np.abs(lens - 0.05).min() > 1e-4
    vj, fj = jtri.compact_mesh(pts, tj, oj)
    vt, ft = ttri.compact_mesh(pts, tt_.numpy(), ot.numpy())
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)


def test_all_invalid_gives_no_triangles():
    pts, _ = _grid(8, 8)
    _, ok = ttri.triangulate_depth_image(torch.from_numpy(pts), torch.zeros(8, 8, dtype=torch.bool))
    assert not ok.any()
