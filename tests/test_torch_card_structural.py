"""Card tests of this slice's paths (marked ``cuda``; skipped without a
GPU).  Run on a machine with an NVIDIA GPU from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card_structural.py

(``--noconftest``: tests/conftest.py imports jax; nothing here does.)

- ``nn_1nn(engine="lattice")`` against the compact engine on the card at
  20,000 points: d² bit for bit, indices equal where d² is not tied.
- ``detect_table_sr`` on the card against the port on the CPU, the same
  uniforms on both, on a 176 × 144 frame: found and the object sizes
  equal, the jump-edge mask identical, the plane within 1e-4, table
  inliers equal but for at most 0.1% of pixels (sums run in another
  order on the card, so a pixel on the 3 cm band may flip)."""
import numpy as np
import pytest
import torch

import chip_smoke
from mapping_private_tpu_torch.models.table_detector_sr import detect_table_sr
from mapping_private_tpu_torch.ops.nn_dispatch import nn_1nn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_lattice_matches_compact_on_card(cuda_device):
    tgt = chip_smoke.surface(20_000, 0)
    src = (tgt + np.random.default_rng(1).normal(0, 0.01, tgt.shape)).astype(np.float32)
    ones = torch.ones(20_000, dtype=torch.bool, device=cuda_device)
    q, r = torch.from_numpy(src).to(cuda_device), torch.from_numpy(tgt).to(cuda_device)
    il, sl = (a.cpu().numpy() for a in nn_1nn(q, ones, r, ones, radius=0.1, engine="lattice"))
    ic, sc = (a.cpu().numpy() for a in nn_1nn(q, ones, r, ones, radius=0.1, engine="compact"))
    np.testing.assert_array_equal(sl.view(np.int32), sc.view(np.int32))
    differ = il != ic
    d_l = ((src[differ] - tgt[il[differ]]) ** 2).sum(1)
    d_c = ((src[differ] - tgt[ic[differ]]) ** 2).sum(1)
    np.testing.assert_array_equal(d_l, d_c)
    assert (il >= 0).mean() > 0.99


@pytest.mark.cuda
def test_detect_table_sr_card_matches_cpu(cuda_device):
    pts, in_box = chip_smoke.sr_frame(chip_smoke.SR_SHAPE, 0)
    u = torch.rand((256, 3), generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        out[dev.type] = detect_table_sr(
            torch.from_numpy(pts).to(dev), torch.ones(chip_smoke.SR_SHAPE, dtype=torch.bool, device=dev),
            torch.tensor(chip_smoke.SR_VIEW, device=dev), u=u.to(dev))
    c, g = out["cpu"], out["cuda"]
    assert bool(c.found) and bool(g.found)
    np.testing.assert_array_equal(g.keep_mask.cpu().numpy(), c.keep_mask.numpy())
    np.testing.assert_array_equal(g.object_sizes.cpu().numpy(), c.object_sizes.numpy())
    np.testing.assert_allclose(g.plane.cpu().numpy(), c.plane.numpy(), rtol=0, atol=1e-4)
    assert (g.table_inliers.cpu().numpy() != c.table_inliers.numpy()).mean() <= 1e-3
    sizes = c.object_sizes.numpy()
    m = c.object_masks.numpy()[np.argmax(sizes)].reshape(chip_smoke.SR_SHAPE)
    assert (sizes > 0).sum() == 1 and m[in_box].sum() == m.sum()
