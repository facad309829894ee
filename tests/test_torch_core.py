"""Port parity: core/se3.py, core/linalg.py and core/cloud.py against the
JAX package on the same numpy inputs.  Tolerance 1e-6 (absolute and
relative): both sides compute in f32 with the same formulas."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapping_private_tpu.core import cloud as jcloud
from mapping_private_tpu.core import linalg as jlinalg
from mapping_private_tpu.core import se3 as jse3
from mapping_private_tpu_torch.core import cloud as tcloud
from mapping_private_tpu_torch.core import linalg as tlinalg
from mapping_private_tpu_torch.core import se3 as tse3

TOL = dict(rtol=1e-6, atol=1e-6)

_TWISTS = {
    "random": np.array([0.3, -0.2, 0.5, 0.4, -0.7, 0.2], np.float32),
    "zero": np.zeros(6, np.float32),
    "small_angle": np.array([0.1, 0.2, 0.3, 3e-5, -2e-5, 1e-5], np.float32),
    "near_pi": np.array([0.1, -0.2, 0.3, 0.0, np.pi - 0.01, 0.0], np.float32),
    "near_pi_oblique": np.array([0.4, 0.1, -0.3, 1.7, -1.7, 1.7], np.float32),
}


def _j(f, *args):
    return np.asarray(f(*[jnp.asarray(a) for a in args]))


def _t(f, *args):
    return f(*[torch.from_numpy(np.array(a)) for a in args]).numpy()


@pytest.mark.parametrize("name", sorted(_TWISTS))
def test_se3_maps_match(name):
    xi = _TWISTS[name]
    T = _j(jse3.se3_exp, xi)
    np.testing.assert_allclose(_t(tse3.se3_exp, xi), T, **TOL)
    np.testing.assert_allclose(_t(tse3.so3_exp, xi[3:]), _j(jse3.so3_exp, xi[3:]), **TOL)
    np.testing.assert_allclose(_t(tse3.skew, xi[3:]), _j(jse3.skew, xi[3:]), **TOL)
    # logs and inverse on the SAME (JAX-made) matrix
    np.testing.assert_allclose(_t(tse3.so3_log, T[:3, :3]), _j(jse3.so3_log, T[:3, :3]), **TOL)
    np.testing.assert_allclose(_t(tse3.se3_log, T), _j(jse3.se3_log, T), **TOL)
    np.testing.assert_allclose(_t(tse3.se3_inverse, T), _j(jse3.se3_inverse, T), **TOL)


def test_se3_compose_and_apply_match():
    rng = np.random.default_rng(0)
    A = _j(jse3.se3_exp, rng.normal(0, 0.5, 6).astype(np.float32))
    B = _j(jse3.se3_exp, rng.normal(0, 0.5, 6).astype(np.float32))
    pts = rng.uniform(-2, 2, (257, 3)).astype(np.float32)
    np.testing.assert_allclose(_t(tse3.se3_compose, A, B), _j(jse3.se3_compose, A, B), **TOL)
    np.testing.assert_allclose(_t(tse3.se3_apply, A, pts), _j(jse3.se3_apply, A, pts), **TOL)


def test_so3_log_gradient_finite_at_identity():
    """The safe-where: d log / dR is finite at R = I (the pose graph
    differentiates through it at convergence)."""
    R = torch.eye(3, requires_grad=True)
    tse3.so3_log(R).sum().backward()
    assert torch.isfinite(R.grad).all()


@pytest.mark.parametrize("jitter", [0.0, 1e-6, 0.5])
def test_cholesky_solve_unrolled_matches(jitter):
    rng = np.random.default_rng(1)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    H = (A @ A.T + 0.1 * np.eye(6)).astype(np.float32)
    g = rng.normal(size=6).astype(np.float32)
    want = np.asarray(jlinalg.cholesky_solve_unrolled(jnp.asarray(H), jnp.asarray(g), jitter))
    got = tlinalg.cholesky_solve_unrolled(torch.from_numpy(H), torch.from_numpy(g), jitter)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cholesky_solve_clamps_singular_pivot():
    """A singular H (no correspondences) stays finite: the pivot clamp."""
    H = np.zeros((6, 6), np.float32)
    g = np.zeros(6, np.float32)
    want = np.asarray(jlinalg.cholesky_solve_unrolled(jnp.asarray(H), jnp.asarray(g)))
    got = tlinalg.cholesky_solve_unrolled(torch.from_numpy(H), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pointcloud_from_numpy_matches_bit_for_bit():
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    chans = {"curvature": rng.uniform(size=300), "normal": rng.normal(size=(300, 3))}
    jc = jcloud.PointCloud.from_numpy(xyz, channels=chans)
    tc = tcloud.PointCloud.from_numpy(xyz, chans, device="cpu")
    assert tc.capacity == jc.capacity == 384
    np.testing.assert_array_equal(tc.xyz.numpy(), np.asarray(jc.xyz))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.padded_xyz().numpy(), np.asarray(jc.padded_xyz()))
    for k in chans:
        np.testing.assert_array_equal(tc.channel(k).numpy(), np.asarray(jc.channel(k)))
    tn, jn = tc.to_numpy(), jc.to_numpy()
    assert tn.keys() == jn.keys()
    for k in tn:
        np.testing.assert_array_equal(tn[k], jn[k])
    with pytest.raises(ValueError):
        tcloud.PointCloud.from_numpy(xyz, capacity=128, device="cpu")


def test_pointcloud_from_arrays_carries_dead_rows():
    """from_arrays takes the JAX cloud's fields as they are, dead rows and
    arbitrary (non-sentinel) dead coordinates included."""
    rng = np.random.default_rng(3)
    jc = jcloud.PointCloud.from_numpy(rng.normal(size=(200, 3)).astype(np.float32))
    keep = jnp.asarray(rng.uniform(size=jc.capacity) > 0.3)
    jc = jc.select(keep).with_channel("curvature", jnp.arange(jc.capacity, dtype=jnp.float32))
    tc = tcloud.PointCloud.from_arrays(
        np.asarray(jc.xyz), np.asarray(jc.mask),
        {k: np.asarray(v) for k, v in jc.channels.items()}, device="cpu",
    )
    np.testing.assert_array_equal(tc.xyz.numpy(), np.asarray(jc.xyz))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.padded_xyz().numpy(), np.asarray(jc.padded_xyz()))
    np.testing.assert_array_equal(
        tc.channel("curvature").numpy(), np.asarray(jc.channel("curvature")))
    assert tc.with_channel("x", tc.xyz[:, 0]).channels.keys() == {"curvature", "x"}
    assert tcloud.PAD_COORD == jcloud.PAD_COORD


def test_pointcloud_accessors_match():
    """count, has_channel, with_xyz, select and the stacked normals / rgb
    (one channel, or three scalar channels) as the JAX package has them."""
    rng = np.random.default_rng(4)
    n = 150
    chans = {"nx": rng.normal(size=n), "ny": rng.normal(size=n), "nz": rng.normal(size=n),
             "rgb": rng.uniform(0, 255, (n, 3))}
    jc = jcloud.PointCloud.from_numpy(rng.normal(size=(n, 3)).astype(np.float32), chans)
    tc = tcloud.PointCloud.from_numpy(np.asarray(jc.xyz)[:n], chans, device="cpu")
    keep = rng.uniform(size=jc.capacity) > 0.4
    js, ts = jc.select(jnp.asarray(keep)), tc.select(torch.from_numpy(keep))
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    assert int(ts.count()) == int(js.count()) and ts.count().dtype == torch.int32
    assert int(tc.count()) == n
    for name in ("nx", "normal", "r"):
        assert tc.has_channel(name) == jc.has_channel(name)
    for a, b in ((ts.normals(), js.normals()), (ts.rgb(), js.rgb())):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tc.with_channel("normal", tc.xyz).normals() is not None
    assert tcloud.PointCloud.from_numpy(np.zeros((3, 3)), device="cpu").normals() is None
    moved = ts.with_xyz(ts.xyz + 1.0)
    np.testing.assert_array_equal(moved.xyz.numpy(), np.asarray(js.with_xyz(js.xyz + 1.0).xyz))
    assert moved.channels.keys() == ts.channels.keys()
