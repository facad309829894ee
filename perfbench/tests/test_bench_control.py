"""The control: the reference in the next lower precision (float32 with
its matrix products' operands rounded to TF32) put in the program's place
must read as not correct, while the program reads as correct.  At a size
a test run holds, on the CPU (the TF32 rounding is explicit, so it is the
same there) and, with ``-m cuda``, on the card; ``perfbench/control.py``
reads both at the cells' own sizes on the card.
"""
import pytest
import torch

from perfbench import harness
from perfbench.tracing import Spans

BENCH = harness.load_bench()
SMALL = {"scan20k.pairs": {"points_per_scan": 2000, "ring_frames": 3},
         "tabletop.frames": {"points_per_frame": 20000, "ring_frames": 2}}


def failed(checks):
    return [c["name"] for c in checks if not c["value"] <= c["limit"]]


def control_and_program(cell, seed, device):
    _, cfg, traffic = harness.load_cell(BENCH, cell)
    cfg = dict(cfg, **SMALL[cell])
    ring = harness.load_module("scenes", cfg["scene"]).make_ring(cfg, seed)
    stream = harness.load_module("pipelines", traffic["pipeline"]).Stream(
        cfg, traffic, ring, device, Spans(False), seed)
    warm = traffic["warmup_frames"]
    for k in range(warm + len(ring["frames"])):
        stream.frame(k)
    ref = harness.load_module("references", traffic["reference"])
    assert not failed(ref.check(cfg, traffic, ring, stream.records, warm, device))
    assert failed(ref.control(cfg, traffic, ring, stream.records, warm, device))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("cell", list(SMALL))
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
def test_control_fails_and_program_passes(cell, seed):
    control_and_program(cell, seed, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_and_program_passes_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    control_and_program(cell, 2**31 + 5, "cuda")
