"""The frozen arithmetic: the nn_argmin roofline count and the statistics."""
import pytest

from perfbench import yardstick


@pytest.mark.parametrize("nq, nr, bound_ms", [(20_000, 20_000, 0.1076), (20_000, 65_536, 0.3526),
                                              (200_000, 200_000, 10.7610)])
def test_nn_argmin_bound_reproduces_the_recorded_bounds(nq, nr, bound_ms):
    # the bounds recorded beside the kernel's times (9 FP32 slots a pair at 1.98 GHz)
    assert round(1e3 * yardstick.nn_argmin_bound_s(nq, nr), 4) == bound_ms


def test_fp32_rate_is_the_data_sheets():
    assert yardstick.FP32_SLOTS_PER_S * 2 == pytest.approx(66.9e12, rel=1e-3)


def test_percentile_and_spread():
    assert yardstick.percentile(list(range(101)), 95) == 95.0
    assert yardstick.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(3.0 / 3.0)
