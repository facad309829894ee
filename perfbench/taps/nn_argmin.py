"""The live query and ref rows, and the CUDA-event time, of each call of
the port's nn_argmin kernel in a traced run.

The tap wraps the entry that the ICP calls
(``registration/icp.py``'s ``nn_argmin_prepared``) from outside; the
untraced run never installs it.  The kernel runs on PyTorch's current
stream (``ops/nn_search.py``), so nothing else runs between the events;
but on a device that waits for the host they also time the host's launch
path, so the harness takes the kernel's time from the device trace where
the trace holds it (one kernel a call), and the events only where not.
"""
from __future__ import annotations

from typing import List, Tuple

# Dead queries carry -1e8 and dead refs +1e8 (the kernel's contract).
_DEAD = 0.5e8


class Tap:
    # the kernel's device function (csrc/nn_search.cuh, as csrc/nn_argmin.cu instantiates it)
    symbol = "search_kernel<nn_search::DirectPair, nn_search::StoreIndex>"

    def __init__(self):
        import torch

        import mapping_private_tpu_torch.registration.icp as icp

        self._icp, self._orig = icp, icp.nn_argmin_prepared
        self.calls: List[Tuple] = []
        orig, calls = self._orig, self.calls

        def timed(q, prepared):
            nq = torch.sum(q[:, 0] > -_DEAD)
            nr = torch.sum(prepared[0] < _DEAD)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(q, prepared)
            end.record()
            calls.append((start, end, nq, nr))
            return out

        icp.nn_argmin_prepared = timed

    def read(self, lo: int = 0, hi: int = None) -> List[Tuple[float, int, int]]:
        """(seconds, live queries, live refs) of calls lo..hi (after a
        synchronize)."""
        return [(s.elapsed_time(e) / 1e3, int(nq), int(nr)) for s, e, nq, nr in self.calls[lo:hi]]

    def remove(self) -> None:
        self._icp.nn_argmin_prepared = self._orig
