"""Card tests of ICP's Gauss-Newton kernel, ``csrc/icp_gn.cu`` (marked
``cuda``; skipped without a GPU).  Run on a machine with an NVIDIA GPU from
the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card_icp.py

(``--noconftest``: tests/conftest.py imports jax; nothing here does.)

On the card, ``icp_point_to_plane`` against its plain version
(``ops/icp_gn.py``'s ``PlainGN``, which CPU tensors run; here forced on the
card's tensors) after 20 sweeps: a 20,000-point pair made as the ``scan20k``
configuration makes its scans, and a tiled pair with dead rows on both
sides and queries that spill out of the occupied-tile slots (idx = -1).
The kernel sums JᵀWJ and JᵀWr in float64 where the plain version takes f32
matrix products, so the transforms agree to ‖ΔT‖_F ≤ 2e-6, the per-sweep
RMSE to 1e-5 relative, the correspondence count exactly."""
import json
import pathlib

import numpy as np
import pytest
import torch

from mapping_private_tpu_torch.core.cloud import PointCloud
from mapping_private_tpu_torch.core.se3 import se3_exp
from mapping_private_tpu_torch.ops import icp_gn
from mapping_private_tpu_torch.ops.normals import estimate_normals
from mapping_private_tpu_torch.ops.tiled_nn import lattice_occupancy
from mapping_private_tpu_torch.registration import icp
from mapping_private_tpu_torch.utils.metrics import metrics
from perfbench.scenes.surface_scans import make_ring

SCAN20K = pathlib.Path(__file__).resolve().parents[1] / "perfbench" / "configs" / "scan20k.json"
ITERS = 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scan_pair(dev, seed=3190000001):
    """Two consecutive scans of the scan20k ring, with the settings of its
    cell: (arguments, keyword arguments) of icp_point_to_plane."""
    cfg = json.loads(SCAN20K.read_text())
    frames = make_ring(cfg, seed)["frames"]
    src, tgt = (PointCloud.from_numpy(f, device=dev) for f in frames[1:3])
    nrm = estimate_normals(tgt, k=cfg["normals_k"]).channel("normal")
    kw = {k: cfg["icp"][k] for k in ("iters", "max_corr_dist", "huber_delta", "damping")}
    return (src.padded_xyz(), src.mask, tgt.padded_xyz(), tgt.mask, nrm), kw


def tiled_pair(dev, n=20_000, tile=0.25):
    """A target on [0, 2]² and a fresh noisy sampling of the same surface on
    [0, 3]², moved by a small twist, a tenth of the rows dead on each side;
    the compact engine's slots cover the target's occupied tiles but not the
    source's, so queries spill."""
    rng = np.random.default_rng(19)

    def sample(extent):
        xy = rng.uniform(0, extent, (n, 2))
        z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1]) + rng.normal(0, 0.002, n)
        return np.column_stack([xy, z]).astype(np.float32)

    tgt, src = sample(2.0), sample(3.0)
    c, s = np.cos(0.02), np.sin(0.02)
    src = (src @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T + [0.02, -0.01, 0.01]).astype(np.float32)
    g = tgt[:, :2].astype(np.float64)
    nrm = np.column_stack([-0.6 * np.cos(2 * g[:, 0]), 0.6 * np.sin(3 * g[:, 1]), np.ones(n)])
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    sm, tm = to(rng.uniform(size=n) > 0.1), to(rng.uniform(size=n) > 0.1)
    lattice = icp.size_tiled_lattice(to(src), sm, to(tgt), tm, tile_size=tile, cap_per_cell=128)
    lo = torch.tensor(lattice["tile_origin"], dtype=torch.float32, device=dev)
    t = torch.tensor(tile, dtype=torch.float32, device=dev)
    dims = torch.tensor(lattice["tile_dims"], dtype=torch.int32, device=dev)
    occ_t = int(lattice_occupancy(to(tgt), tm, lo, t, dims)[0])
    occ_s = int(lattice_occupancy(to(src), sm, lo, t, dims)[0])
    lattice["max_tiles"] = 1 << int(np.ceil(np.log2(occ_t)))
    assert occ_s > lattice["max_tiles"] >= occ_t
    kw = dict(nn_backend="tiled", grid_cell=tile, iters=ITERS, max_corr_dist=0.25, **lattice)
    return (to(src), sm, to(tgt), tm, to(nrm)), kw


PAIRS = {"scan20k": scan_pair, "tiled_spill": tiled_pair}


def run(args, kw, kernel: bool, monkeypatch):
    """icp_point_to_plane on the kernel path or the plain one; the result
    and how many sweeps took the kernel."""
    with monkeypatch.context() as m:
        if not kernel:
            m.setattr(icp_gn, "gauss_newton", icp_gn.PlainGN)
        before = metrics.counters["icp_gn.launches"]
        res = icp.icp_point_to_plane(*args, **kw)
        torch.cuda.synchronize()
        return res, metrics.counters["icp_gn.launches"] - before


@pytest.mark.cuda
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_kernel_path_matches_the_plain_path(cuda_device, monkeypatch, pair):
    args, kw = PAIRS[pair](cuda_device)
    got, n_kernel = run(args, kw, True, monkeypatch)
    want, n_plain = run(args, kw, False, monkeypatch)
    assert (n_kernel, n_plain) == (kw["iters"], 0)
    assert got.transform.dtype == torch.float32 and got.transform.shape == (4, 4)
    assert got.num_corr.dtype == torch.int32 and got.per_iter_rmse.shape == (kw["iters"],)
    gap = float(torch.linalg.matrix_norm(got.transform.double() - want.transform.double()))
    assert gap <= 2e-6, gap
    assert int(got.num_corr) == int(want.num_corr) > 0
    torch.testing.assert_close(got.per_iter_rmse, want.per_iter_rmse, rtol=1e-5, atol=0)
    assert float(got.rmse) == float(got.per_iter_rmse[-1])
    if pair == "tiled_spill":
        # the spilled queries found nothing; the others were matched
        assert 0 < int(got.num_corr) < int(args[1].sum())


@pytest.mark.cuda
def test_two_calls_give_the_same_bits(cuda_device, monkeypatch):
    args, kw = scan_pair(cuda_device)
    a, _ = run(args, kw, True, monkeypatch)
    b, _ = run(args, kw, True, monkeypatch)
    assert torch.equal(a.transform, b.transform)
    assert torch.equal(a.per_iter_rmse, b.per_iter_rmse) and torch.equal(a.num_corr, b.num_corr)


@pytest.mark.cuda
def test_no_accepted_correspondence_leaves_the_pose(cuda_device, monkeypatch):
    """With every pair beyond max_corr_dist JᵀWJ and JᵀWr are zero: the
    damped solve gives ξ = 0, so T stays init_T, finite; init_T itself is
    not written."""
    args, kw = scan_pair(cuda_device)
    init = se3_exp(torch.tensor([0.01, -0.02, 0.0, 0.0, 0.01, -0.01], device=cuda_device))
    keep = init.clone()
    res, n = run(args, dict(kw, max_corr_dist=1e-9, init_T=init), True, monkeypatch)
    assert n == kw["iters"]
    assert torch.equal(init, keep)
    assert bool(torch.isfinite(res.transform).all())
    torch.testing.assert_close(res.transform, init, rtol=0, atol=1e-7)
    assert int(res.num_corr) == 0 and float(res.per_iter_rmse.abs().max()) == 0.0
