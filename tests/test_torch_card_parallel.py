"""Card test of the sharded steps (marked ``cuda``; skipped without a GPU).
Run on a machine with an NVIDIA GPU from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card_parallel.py

(``--noconftest``: tests/conftest.py imports jax; nothing here does.)

The small dry run's four steps on two gloo ranks spawned on one card
against the same ranks on the CPU: poses within 1e-5, correspondence
counts equal, the pose graph's err below 1e-6 on both, and the brute
steps' per-shard search went through the ``nn_matmul`` kernel."""
import numpy as np
import pytest
import torch

from mapping_private_tpu_torch.parallel import dryrun


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jobs, _ = dryrun.dryrun_jobs(2, small=True)
    card = dryrun.run_steps(jobs, 2, "gloo", "cuda", store_dir=str(tmp_path), timeout=120)
    cpu = dryrun.run_steps(jobs, 2, "gloo", "cpu", store_dir=str(tmp_path), timeout=120)
    for rank in range(2):
        for c, p in zip(card[rank][:3], cpu[rank][:3]):  # (poses, correspondence counts)
            np.testing.assert_allclose(c.outputs[0], p.outputs[0], rtol=0, atol=1e-5)
            np.testing.assert_array_equal(c.outputs[1], p.outputs[1])
        (kf_c, err_c), (kf_p, err_p) = card[rank][3].outputs, cpu[rank][3].outputs  # the pose graph
        np.testing.assert_allclose(kf_c, kf_p, rtol=0, atol=1e-5)
        assert err_c < 1e-6 and err_p < 1e-6
        assert card[rank][0].launches["nn_matmul"] == 1 and card[rank][1].launches["nn_matmul"] == 1
        assert cpu[rank][0].launches["nn_matmul"] == 0
