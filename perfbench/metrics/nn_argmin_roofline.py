"""Share (%) of its roofline that the port's nn_argmin kernel reaches: the
least time the brute exact 1-NN of each call needs (live queries x live
refs x the frozen count of FP32 issue slots a pair, over one H100's FP32
rate; perfbench/yardstick.py), summed, over the calls' summed kernel
times: those of the profiled frames from the device trace, or, where the
trace lacks the kernel, the window's CUDA-event times."""
from perfbench.yardstick import nn_argmin_bound_s


def read(trace):
    calls = trace.taps.get("nn_argmin")
    if not calls:
        return None
    spent = sum(s for s, _, _ in calls)
    return 100.0 * sum(nn_argmin_bound_s(nq, nr) for _, nq, nr in calls) / spent
