#!/usr/bin/env python3
"""Time the 1-NN kernels of the PyTorch/CUDA port (nn_argmin, nn_matmul,
nn_gather in its three modes) alone on the card.

Run from the root of a checkout, on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/time_nn_search.py [--splits 1,2,4,7]

The scenes and the timer are ``chip_smoke.py``'s, of the tree this file
lies in; ``mapping_private_tpu_torch`` is imported from the current
directory, so the same file times any tree: to compare two trees on one
card, unpack the other one's package beside this tree and run this file in
turns (other, this, this, other), each run from its tree's root.  Only the
public wrappers are used unless ``--splits`` is given; that option needs a
tree whose ``ops/nn_search.py`` has ``search_index`` and times each given
number of ref stretches beside the one the wrapper chooses.

Shapes: 20,000 x 20,000 (a pairwise ICP sweep), 20,000 queries against a
65,536-row map of which a quarter is dead (a tracker sweep), 200,000 x
200,000 (the brute engine of nn_1nn), and 20,000 dead queries (-PAD_COORD:
every ref ~1e8 away, ties everywhere).  nn_argmin and nn_matmul run at all
four, nn_gather (aux rows from a seed) at the first and the last.  Each time is the median of five
turns of back-to-back launches between two CUDA events; the last line is
one JSON object {"card": ..., "ms": {kernel shape [splits]: ms}}.
"""
import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", default="", help="comma-separated numbers of ref stretches to time as well")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from chip_smoke import big_pair, event_ms, surface

    sys.path.insert(0, os.getcwd())
    import torch

    from mapping_private_tpu_torch.core.cloud import PAD_COORD
    from mapping_private_tpu_torch.ops import nn_argmin, nn_gather, nn_matmul

    if not torch.cuda.is_available():
        raise SystemExit("time_nn_search: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    map_rows = surface(65_536, 7)
    map_rows[49_152:] = PAD_COORD
    big_tgt, big_src, _ = big_pair()
    shapes = {
        "20000x20000": (surface(20_000, 1), surface(20_000, 0), 200),
        "20000x65536_map": (surface(20_000, 1), map_rows, 100),
        "200000x200000": (big_src, big_tgt, 5),
        "dead_queries_20000x20000": (np.full((20_000, 3), -PAD_COORD, np.float32), surface(20_000, 0), 200),
    }
    gathered = ("20000x20000", "dead_queries_20000x20000")
    splits = [int(s) for s in args.splits.split(",") if s]
    if splits:
        from mapping_private_tpu_torch.ops.nn_search import search_index
    out = {}
    for name, (q_np, r_np, reps) in shapes.items():
        q, r = torch.from_numpy(q_np).to(dev), torch.from_numpy(r_np).to(dev)
        prep = nn_argmin.prepare_nn_ref_argmin(r)
        calls = {f"nn_argmin {name}": lambda: nn_argmin.nn_argmin_prepared(q, prep),
                 f"nn_matmul {name}": lambda: nn_matmul.nn_matmul(q, r)}
        if name in gathered:
            aux = torch.from_numpy(np.random.default_rng(5).normal(size=r_np.shape).astype(np.float32)).to(dev)
            rt, nt = nn_gather.prepare_nn_ref(r, aux)
            for dist in nn_gather.DIST_MODES:
                calls[f"nn_gather:{dist} {name}"] = lambda d=dist: nn_gather.nn_gather_prepared(q, rt, nt, dist=d)
        for s in splits:
            calls[f"nn_argmin {name} splits={s}"] = lambda s=s: search_index("nn_argmin", q, prep, len(r), s)
            calls[f"nn_matmul {name} splits={s}"] = lambda s=s: search_index("nn_matmul", q, r, len(r), s)
            if name in gathered:
                for dist in nn_gather.DIST_MODES:
                    calls[f"nn_gather:{dist} {name} splits={s}"] = (
                        lambda s=s, d=dist: nn_gather._launch(q, rt, nt, d, s))
        turns = {k: [] for k in calls}
        for _ in range(5):
            for k, fn in calls.items():
                turns[k].append(event_ms(torch, fn, reps))
        for k, t in turns.items():
            out[k] = statistics.median(t)
            print(f"{k}: {out[k]:.4f} ms (turns {[round(x, 4) for x in t]})", flush=True)
    print(json.dumps({"card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
