"""The benchmark's fixed arithmetic: the peaks of one H100, the work of a
brute exact 1-NN, percentiles and spreads.

The counts are of the work a call needs, not of the code that does it, so
they read the same whatever implements the search.  A change that stops
searching all pairs needs a new count, made in the benchmark.
"""
from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np

# One NVIDIA H100 SXM (NVIDIA's data sheet): 132 SMs x 128 FP32 lanes at
# the 1.98 GHz boost clock issue 33.45e12 FP32 operations a second, the
# 67 TFLOP/s of the data sheet when a fused multiply-add counts twice.
H100_SMS = 132
H100_FP32_LANES = 128
H100_BOOST_HZ = 1.98e9
FP32_SLOTS_PER_S = H100_SMS * H100_FP32_LANES * H100_BOOST_HZ
HBM_BYTES_PER_S = 3.35e12

# FP32 issue slots a query-ref pair of the brute exact 1-NN needs: the
# squared distance by direct differences (3 sub + 3 mul + 2 add) and one
# min, since the least of N numbers takes N - 1 of them.  The index, ties
# and the output are per query, not per pair.
NN_ARGMIN_SLOTS_PER_PAIR = 9


def nn_argmin_bound_s(nq: int, nr: int) -> float:
    """Least seconds an H100 needs for the exact 1-NN of ``nq`` live
    queries among ``nr`` live refs: the larger of the operations over the
    FP32 rate and the bytes (xyz in, index and distance out) over HBM's."""
    ops_s = NN_ARGMIN_SLOTS_PER_PAIR * nq * nr / FP32_SLOTS_PER_S
    bytes_s = (12 * nq + 12 * nr + 8 * nq) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile (Python's
    ``statistics.quantiles``, n=4) as a share of the median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
