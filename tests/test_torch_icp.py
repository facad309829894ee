"""Port parity: registration/icp.py against the JAX package on the two
synthetic cases of tests/test_icp.py.

For the exact backends the JAX side runs ``nn_backend="xla"``: its
``pallas`` route cannot run on the CPU outside interpret mode, and both
routes compute the same GN from exact correspondences.  The ``grid`` and
``tiled`` backends run against the JAX package's own (the dense lattice
and the segmented mode in tests/test_torch_icp_tiled.py).  Both packages get the same target cloud and
the same (JAX-estimated) normals.  Tolerances: transform within 1e-5,
per-sweep RMSE within rtol 1e-4, correspondence count exact.  Once a run
has converged its RMSE is f32 rounding noise (~2e-8 for coordinates of
order 1, ulp 6e-8), where a relative bound means nothing; RMSE therefore
also passes within an absolute 1e-7, the rounding of one coordinate."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ref import one_torch_thread  # noqa: F401 (fixture)
from test_icp import _bumpy_surface

from mapping_private_tpu.core import PointCloud, se3_apply, se3_exp, se3_inverse
from mapping_private_tpu.ops.normals import estimate_normals
from mapping_private_tpu.registration import icp as jicp
from mapping_private_tpu_torch import _build
from mapping_private_tpu_torch.core.cloud import PAD_COORD
from mapping_private_tpu_torch.ops import icp_gn
from mapping_private_tpu_torch.registration import icp as ticp

# (seed, true twist, iters, max_corr_dist): test_icp.py:19-35 and :38
CASES = {
    "recovers_known_transform": (0, [0.05, -0.04, 0.03, 0.04, -0.03, 0.05], 15, 0.5),
    "grid_path_case": (1, [0.03, 0.02, -0.02, -0.02, 0.03, 0.02], 15, 0.3),
}


def _inputs(seed, xi, dead_every=0):
    tgt = PointCloud.from_numpy(_bumpy_surface(seed=seed))
    if dead_every:
        tgt = tgt.select(jnp.arange(tgt.capacity) % dead_every != 0)
    tgt = estimate_normals(tgt, k=12, viewpoint=jnp.array([0.0, 0.0, 10.0]))
    T_true = se3_exp(jnp.asarray(np.array(xi, np.float32)))
    src = se3_apply(se3_inverse(T_true), tgt.padded_xyz())
    arrays = (src, tgt.mask, tgt.padded_xyz(), tgt.mask, tgt.channel("normal"))
    return [np.asarray(a) for a in arrays], np.asarray(T_true)


def _run_both(case, backend, dead_every=0):
    seed, xi, iters, mcd = CASES[case]
    arrays, T_true = _inputs(seed, xi, dead_every)
    rj = jicp.icp_point_to_plane(
        *[jnp.asarray(a) for a in arrays], iters=iters, max_corr_dist=mcd, nn_backend="xla")
    rt = ticp.icp_point_to_plane(
        *[torch.tensor(a) for a in arrays], iters=iters, max_corr_dist=mcd,
        nn_backend=backend)
    return rj, rt, T_true


@pytest.mark.parametrize("backend", ["xla", "auto"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_icp_matches_jax(case, backend):
    rj, rt, T_true = _run_both(case, backend)
    np.testing.assert_allclose(rt.transform.numpy(), np.asarray(rj.transform), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        rt.per_iter_rmse.numpy(), np.asarray(rj.per_iter_rmse), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(rt.rmse), float(rj.rmse), rtol=1e-4, atol=1e-7)
    assert int(rt.num_corr) == int(rj.num_corr)
    assert rt.num_corr.dtype == torch.int32
    np.testing.assert_allclose(rt.transform.numpy(), T_true, atol=5e-3)


@pytest.mark.parametrize("backend", ["xla", "auto"])
def test_icp_dead_rows_match_jax(backend):
    """Dead source and target rows are gated out identically."""
    rj, rt, _ = _run_both("recovers_known_transform", backend, dead_every=5)
    np.testing.assert_allclose(rt.transform.numpy(), np.asarray(rj.transform), rtol=0, atol=1e-5)
    assert int(rt.num_corr) == int(rj.num_corr)


def test_tiled_argument_errors():
    """The tiled backend needs its lattice; an unknown backend is refused."""
    arrays, _ = _inputs(0, [0.0] * 6)
    with pytest.raises(ValueError, match="tile_origin"):
        ticp.icp_point_to_plane(*[torch.tensor(a) for a in arrays], nn_backend="tiled")
    with pytest.raises(ValueError, match="unknown nn_backend"):
        ticp.icp_point_to_plane(*[torch.tensor(a) for a in arrays], nn_backend="kdtree")


def _assert_same_run(rt, rj, T_true):
    """Transform within 1e-5, per-sweep RMSE within rtol 1e-4 (or 1e-7
    absolute once converged), correspondence count exact."""
    np.testing.assert_allclose(rt.transform.numpy(), np.asarray(rj.transform), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        rt.per_iter_rmse.numpy(), np.asarray(rj.per_iter_rmse), rtol=1e-4, atol=1e-7)
    assert int(rt.num_corr) == int(rj.num_corr)
    np.testing.assert_allclose(rt.transform.numpy(), T_true, atol=5e-3)


@pytest.mark.parametrize("dead_every", [0, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_icp_grid_backend_matches_jax(case, dead_every):
    """Both packages run their grid hash (cell 0.3, 32 per cell)."""
    seed, xi, iters, mcd = CASES[case]
    arrays, T_true = _inputs(seed, xi, dead_every)
    kw = dict(iters=iters, max_corr_dist=mcd, nn_backend="grid", grid_cell=0.3, cap_per_cell=32)
    rj = jicp.icp_point_to_plane(*[jnp.asarray(a) for a in arrays], **kw)
    rt = ticp.icp_point_to_plane(*[torch.tensor(a) for a in arrays], **kw)
    _assert_same_run(rt, rj, T_true)


@pytest.mark.parametrize("dead_every", [0, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_icp_tiled_matches_jax(case, dead_every):
    """Both packages size their lattice from the clouds and run the
    compact occupied-tiles engine, re-bucketing the queries every sweep."""
    seed, xi, iters, mcd = CASES[case]
    arrays, T_true = _inputs(seed, xi, dead_every)
    kw = dict(tile_size=0.3, cap_per_cell=128, iters=iters, max_corr_dist=0.3)
    rj = jicp.icp_point_to_plane_tiled(*[jnp.asarray(a) for a in arrays], **kw)
    rt = ticp.icp_point_to_plane_tiled(*[torch.tensor(a) for a in arrays], **kw)
    _assert_same_run(rt, rj, T_true)


def test_tiled_matches_exact_backend_within_the_port():
    """Correspondences within the tile size are the exact ones, so the
    tiled run lands where the exact-argmin run does."""
    seed, xi, iters, _ = CASES["grid_path_case"]
    arrays, _ = _inputs(seed, xi)
    ts = [torch.tensor(a) for a in arrays]
    ra = ticp.icp_point_to_plane(*ts, iters=iters, max_corr_dist=0.3)
    rt = ticp.icp_point_to_plane_tiled(*ts, tile_size=0.3, cap_per_cell=128, iters=iters, max_corr_dist=0.3)
    np.testing.assert_allclose(rt.transform.numpy(), ra.transform.numpy(), rtol=0, atol=1e-6)
    assert int(rt.num_corr) == int(ra.num_corr)


def test_tiled_sizing_syncs_once(monkeypatch):
    """icp_point_to_plane_tiled reads the device exactly once (bounds,
    lattice dims and both occupancies in one transfer) and the sweeps
    read nothing: the counterpart of the JAX package's one-device_get
    guard."""
    rng = np.random.default_rng(0)
    n = 4096
    xy = rng.uniform(0, 2.0, (n, 2))
    tgt = np.column_stack([xy, 0.2 * np.sin(xy[:, 0] * 3)]).astype(np.float32)
    src = (tgt + rng.normal(0, 0.005, tgt.shape)).astype(np.float32)
    nrm = np.tile(np.asarray([0, 0, 1.0], np.float32), (n, 1))
    mask = torch.ones(n, dtype=torch.bool)
    args = (torch.from_numpy(src), mask, torch.from_numpy(tgt), mask, torch.from_numpy(nrm))

    calls = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: (calls.append(1), real_cpu(self, *a, **k))[1])
    for name in ("item", "tolist", "__bool__", "__float__", "__int__", "__index__"):
        def forbid(self, *a, _n=name, **k):
            raise AssertionError(f"host read through Tensor.{_n}")
        monkeypatch.setattr(torch.Tensor, name, forbid)
    r = ticp.icp_point_to_plane_tiled(*args, tile_size=0.25, iters=2)
    monkeypatch.undo()
    assert len(calls) == 1, f"sizing used {len(calls)} host reads (contract: 1)"
    assert float(r.rmse) < 0.02


def test_ate_rmse_matches():
    a = np.stack([np.eye(4, dtype=np.float32)] * 3)
    b = a.copy()
    b[:, 0, 3] += 0.1
    b[1, 2, 3] -= 0.3
    want = float(jicp.ate_rmse(jnp.asarray(a), jnp.asarray(b)))
    got = float(ticp.ate_rmse(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _small_pair(n=400, seed=7):
    """A small surface and a moved fresh sampling of it, the last rows of
    each dead, with the port's own normals: CPU tensors."""
    from mapping_private_tpu_torch.core.cloud import PointCloud as TCloud
    from mapping_private_tpu_torch.ops.normals import estimate_normals as t_normals

    rng = np.random.default_rng(seed)

    def sample():
        xy = rng.uniform(-1, 1, (n, 2))
        return np.c_[xy, 0.2 * np.sin(3 * xy[:, 0]) + 0.1 * np.cos(2 * xy[:, 1])].astype(np.float32)

    c, s = np.cos(0.03), np.sin(0.03)
    tgt, src = sample(), sample() @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32).T + [0.02, -0.01, 0.01]
    keep = torch.arange(n) < n - 20
    t = TCloud.from_numpy(tgt, device="cpu")
    t = t.select(t.mask & torch.nn.functional.pad(keep, (0, t.mask.shape[0] - n)))
    sm = keep.clone()
    return torch.from_numpy(src.astype(np.float32)), sm, t.padded_xyz(), t.mask, t_normals(t, k=8).channel("normal")


@pytest.mark.parametrize("backend", ["auto", "xla", "grid", "tiled"])
def test_cpu_tensors_take_the_plain_path(monkeypatch, backend):
    """On CPU tensors csrc/icp_gn.cu is never reached (``icp_gn.launches``
    stays where it was) and the result is the plain version's: every sweep
    through ``gn_from_corr``, whose last pose and count are returned."""
    from mapping_private_tpu_torch.utils.metrics import metrics

    def refuse(*a, **k):
        raise AssertionError("a kernel was launched for CPU tensors")

    monkeypatch.setattr(_build, "launch", refuse)
    outs = []
    orig = icp_gn.gn_from_corr

    def recorded(*a, **k):
        outs.append(orig(*a, **k))
        return outs[-1]

    monkeypatch.setattr(icp_gn, "gn_from_corr", recorded)
    before = metrics.counters["icp_gn.launches"]
    args, iters = _small_pair(), 6
    if backend == "tiled":
        r = ticp.icp_point_to_plane_tiled(*args, tile_size=0.3, cap_per_cell=128, iters=iters, max_corr_dist=0.3)
    else:
        r = ticp.icp_point_to_plane(*args, iters=iters, max_corr_dist=0.3, nn_backend=backend,
                                    grid_cell=0.3, cap_per_cell=32)
    assert metrics.counters["icp_gn.launches"] == before
    assert len(outs) == iters
    T_last, rmse_last, cnt_last = outs[-1]
    assert torch.equal(r.transform, T_last) and torch.equal(r.num_corr, cnt_last)
    assert torch.equal(r.per_iter_rmse, torch.stack([o[1] for o in outs])) and torch.equal(r.rmse, rmse_last)
    assert int(r.num_corr) > 300 and float(r.rmse) < 0.01


# csrc/icp_gn.cu's constants and what the host mirrors of them: a wrong kRow
# would size the partial-sums workspace wrong and the card would write past it
GN_MIRRORS = {"kBlock": icp_gn.BLOCK, "kMaxBlocks": icp_gn.MAX_BLOCKS, "kRow": icp_gn.ROW,
              "kPadCoord": PAD_COORD}


@pytest.mark.parametrize("constant", sorted(GN_MIRRORS))
def test_kernel_constants_match_their_mirrors(constant):
    text = _build.source_path("icp_gn").read_text()
    value = re.search(rf"constexpr (?:int|float) {constant} = ([0-9.e]+)f?;", text).group(1)
    assert float(value) == GN_MIRRORS[constant]
