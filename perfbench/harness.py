"""The benchmark's harness: one cell of BENCHMARK.json, run once.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that BENCHMARK.json gives it:

- ``<config file>``: the deployment's sizes; its ``scene`` names the
  generator ``perfbench/scenes/<scene>.py`` that makes the cell's ring of
  frames from the seed;
- ``perfbench/traffic/<traffic>.json``: the mix's parameters; its
  ``pipeline`` names the per-frame runner of the port
  ``perfbench/pipelines/<pipeline>.py``, its ``reference`` the plain
  reference and comparison ``perfbench/references/<reference>.py``, its
  ``taps`` the kernel timers ``perfbench/taps/<tap>.py`` of a traced run,
  and its ``limits`` the limit of each number compared;
- ``perfbench/end_to_end/<metric>.py`` and ``perfbench/metrics/<metric>.py``:
  one reader a metric, which returns None where it finds nothing to read.
  A quantity split by the cells it is read in (``<base>.<qualifier>``,
  such as ``frames_per_s.scan``) is read by the base's reader unless it
  has a file of its own.

The loop is closed: the next frame is handed in, as a host numpy array,
only when the last result is on the host.  The window opens after the
warm-up frames and closes at the end of the first frame that finishes
after ``--seconds``.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
# Top-level module names that may not be loaded in a run, compared whole:
# the port's own name begins with the JAX package's.
BANNED = ("jax", "jaxlib", "flax", "mapping_private_tpu")
# One host thread for the math libraries: the frames' host work is the
# launch path and small numpy, and idle pool threads only add jitter.
HOST_THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_name(kind: str, name: str) -> str:
    """The reader file's name of metric ``name``: its own, or, for
    ``<base>.<qualifier>`` with no file of its own, the base's."""
    while not (BENCH / kind / f"{name}.py").is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
    return name


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(bench: dict, name: str):
    """(cell entry, configuration dict, traffic dict) of the named cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, traffic


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def cell_metrics(bench: dict, cell: str):
    """(end-to-end entries, per-layer entries) that the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


class Window:
    """What the end-to-end readers read: the window's frames."""

    def __init__(self, setup_s: float):
        self.setup_s = setup_s
        self.latencies_s = []
        self.window_s = 0.0


class Trace:
    """What the per-layer readers read: spans, taps and the profile of
    the traced frames."""

    def __init__(self, spans: dict, taps: dict, profile):
        self.spans = spans
        self.taps = taps  # name -> [(kernel seconds, live queries, live refs)] a call
        self.profile = profile


def passes(check: dict) -> bool:
    return math.isfinite(check["value"]) and check["value"] <= check["limit"]


def card_info() -> dict:
    """Name, power limit and SM clocks from nvidia-smi ({} without it)."""
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    return dict(zip(q.split(","), (v.strip() for v in out.splitlines()[0].split(","))))


def run(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        started: float = None, cfg: dict = None, traffic: dict = None, bench: dict = None) -> dict:
    """One run of a cell; returns the result dict (``checks`` last).  The
    tests pass a small ``cfg``/``traffic`` and ``device="cpu"``."""
    import torch

    started = time.perf_counter() if started is None else started
    bench = load_bench() if bench is None else bench
    cell, cfg0, traffic0 = load_cell(bench, cell_name)
    cfg, traffic = cfg or cfg0, traffic or traffic0
    on_cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)

    from perfbench.tracing import Spans, reduce_profile, warm_profiler

    ring = load_module("scenes", cfg["scene"]).make_ring(cfg, seed)
    spans = Spans(trace and on_cuda)
    taps = {n: load_module("taps", n).Tap() for n in traffic.get("taps", [])} if trace and on_cuda else {}
    stream = load_module("pipelines", traffic["pipeline"]).Stream(cfg, traffic, ring, device, spans, seed)
    warm = traffic["warmup_frames"]
    for k in range(warm):
        stream.frame(k)
    sync()
    if trace and on_cuda:
        warm_profiler(device)
    spans.seconds.clear()
    tap_lo = {n: len(t.calls) for n, t in taps.items()}

    prof, p0, pn = None, traffic.get("profile_skip", 0), traffic.get("profile_frames", 0)
    profiled = {}  # t0, t1, frames, taps' call counts at its start and end
    failed, k = 0, warm
    t_open = time.perf_counter()
    win = Window(t_open - started)
    while True:
        if trace and on_cuda and pn and k - warm == p0:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            profiled = {"t0": time.perf_counter(), "calls0": {n: len(t.calls) for n, t in taps.items()}}
        t0 = time.perf_counter()
        with torch.profiler.record_function("frame") if trace else contextlib.nullcontext():
            ok = stream.frame(k)
        t1 = time.perf_counter()
        failed += 0 if ok else 1
        win.latencies_s.append(t1 - t0)
        k += 1
        done = t1 - t_open >= seconds
        if prof is not None and "t1" not in profiled and (k - warm == p0 + pn or done):
            prof.__exit__(None, None, None)
            profiled.update(t1=t1, frames=k - warm - p0,
                            calls1={n: len(t.calls) for n, t in taps.items()})
        if done:
            break
    win.window_s = t1 - t_open
    sync()
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    stream.release()

    result = {"correct": False, "attempted": len(win.latencies_s), "failed": failed, "metrics": {}}
    e2e, layer = cell_metrics(bench, cell_name)
    if not trace:
        for m in e2e:
            v = load_module("end_to_end", reader_name("end_to_end", m["name"])).read(win)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    taps_read = {n: t.read(tap_lo[n]) for n, t in taps.items()}
    profile = None
    if prof is not None:
        profile = reduce_profile(prof, profiled["t1"] - profiled["t0"])
        profile.update(frames=profiled["frames"], tap_times={})
        for n, tap in taps.items():
            calls = tap.read(profiled["calls0"][n], profiled["calls1"][n])
            traced = [d for _, d, name in profile["kernels"] if tap.symbol in name]
            if traced and len(traced) == len(calls):
                # on an idle device the events also time the host's launch path
                taps_read[n] = [(d, nq, nr) for d, (_, nq, nr) in zip(traced, calls)]
                profile["tap_times"][n] = "device trace"
            elif not traced:  # a kernel the trace does not hold: its event time is busy
                profile["busy_s"] += sum(e for e, _, _ in calls)
                profile["tap_times"][n] = "CUDA events, added to busy"
            else:
                profile["tap_times"][n] = "CUDA events"
    for t in taps.values():
        t.remove()
    if trace:
        tr = Trace(dict(spans.seconds), taps_read, profile)
        for m in layer:
            v = load_module("metrics", reader_name("metrics", m["name"])).read(tr)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["device"] = {"platform": "gpu" if on_cuda else "cpu",
                        "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
                        "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if profile:
        result["device"].update(busy_s=profile["busy_s"], window_s=profile["window_s"])
        result["breakdown"] = {"device_ops": profile["device_ops"], "idle_gaps": profile["idle_gaps"]}
        result["profile"] = {"frames": profile["frames"], "tap_times": profile["tap_times"]}
    if trace:
        result["traced_frames_per_s"] = len(win.latencies_s) / win.window_s
        if on_cuda:
            result["card"] = card_info()

    checks = load_module("references", traffic["reference"]).check(
        cfg, traffic, ring, stream.records, warm, device)
    result["correct"] = all(passes(c) for c in checks) and failed == 0
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv, started: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(HOST_THREADS)
    bench = load_bench()
    cell, _, _ = load_cell(bench, args.workload)

    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import mapping_private_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the port is not importable here: {e}", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", started,
                 bench=bench)
    banned = banned_modules()
    if banned:
        print(f"perfbench: the run loaded {banned}; no result", file=sys.stderr)
        return 3
    if "card" in result:
        print(f"card: {json.dumps(result['card'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {'ok' if passes(c) else 'FAILED'}",
              file=sys.stderr)
        if not math.isfinite(c["value"]):  # no answer to compare: the largest double, in strict JSON
            c["value"] = sys.float_info.max
    print(json.dumps(result, allow_nan=False))
    return 0
