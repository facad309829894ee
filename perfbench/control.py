"""The readings that a cell's limits are set from, on the chip.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--frames N]

For each seed, in one process: the cell's ring, its warm-up frames and
``--frames`` frames more through the port (the cell's own per-frame
runner at the cell's own sizes), then the reference's comparison of the
program (``check``) and of the control, the reference in the next lower
precision put in the program's place (``control``).  One JSON line a
seed: {"seed", "program": {number: value}, "control": {number: value}},
and where the reference has a ``witness``, the program's numbers against
the reference's own chain under "witness".
The benchmark's runs never run this.
"""
import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from perfbench import harness
    from perfbench.tracing import Spans

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=None,
                    help="frames after the warm-up (default: the ring's length)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("perfbench/control.py: no CUDA device")
    bench = harness.load_bench()
    cell, cfg, traffic = harness.load_cell(bench, args.workload)
    pipeline = harness.load_module("pipelines", traffic["pipeline"])
    ref = harness.load_module("references", traffic["reference"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0, extra = time.perf_counter(), {}
        ring = harness.load_module("scenes", cfg["scene"]).make_ring(cfg, seed)
        stream = pipeline.Stream(cfg, traffic, ring, "cuda", Spans(False), seed)
        warm = traffic["warmup_frames"]
        frames = args.frames if args.frames is not None else len(ring["frames"])
        for k in range(warm + frames):
            stream.frame(k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stream.release()
        prog = {c["name"]: c["value"] for c in ref.check(cfg, traffic, ring, stream.records, warm, "cuda")}
        t2 = time.perf_counter()
        ctrl = {c["name"]: c["value"] for c in ref.control(cfg, traffic, ring, stream.records, warm, "cuda")}
        t3 = time.perf_counter()
        if hasattr(ref, "witness"):
            extra["witness"] = {c["name"]: c["value"]
                                for c in ref.witness(cfg, traffic, ring, stream.records, warm, "cuda")}
        print(json.dumps({"workload": args.workload, "seed": seed, "frames": frames, "program": prog,
                          "control": ctrl, **extra, "seconds": {"program": t1 - t0, "check": t2 - t1,
                                                                "control": t3 - t2}}), flush=True)
        del stream
        torch.cuda.empty_cache()
