#!/usr/bin/env python3
"""The port's own spans and branch times in a benchmark cell, on one card.

Usage, from the root of a checkout (one CUDA card):

    python3 tools/trace_spans.py --workload slam.near_corner.chunk16 --seed N \\
        [--seconds 20] [--trace-seconds 2] [--reps 20] [--out DIR]

Builds the cell's program as ``portbench/run.py`` does (the same driver,
traffic and warm-up from the seed), then:

1. the untraced window (``--seconds``): the recorder's spans over it
   (``tracing.diff`` of two snapshots), per frame;
2. the traced window (``portbench/trace.py``, ``--trace-seconds``): the
   device's busy share, its longest idle gaps named by the innermost host
   operation (the program's ``mslam.`` spans among them), the device
   operations per frame, and the recorder's spans under the profiler;
   then three more, the spans' profiler ranges left out of the middle two,
   for what those ranges cost;
3. the step's ``step_device_ms`` as the benchmark reads it, and
   ``GraphedStep.branch_times`` (``--reps`` replays of the timing graph):
   each branch's device ms and operations per frame (per stream-frame in
   the batched cell), with the timing call's seconds and peak bytes;
4. the cost of one span with no profiler on.

Prints the span tables to stderr and one JSON line to stdout, also
written to ``DIR/<workload>.<seed>.json`` (default chiprun_out/trace_spans).
No correctness check runs here: ``portbench/run.py`` is the benchmark.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from manhattanslam_tpu_torch import tracing  # noqa: E402
from portbench import common  # noqa: E402
from portbench.trace import traced  # noqa: E402

SPAN_COST_N = 100_000


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def graphed_and_view(driver):
    """The cell's GraphedStep, its view and its recorder."""
    if hasattr(driver, "system"):
        tr = driver.system.tracker
        return tr.step, tr.view, driver.system.trace
    return driver.step.graphed, driver.view, driver.step.graphed.trace


def per_frame(d: dict, frames: int) -> dict:
    """The metrics the spans give over a window of `frames` frames."""
    leaf = tracing.by_leaf(d)
    sp = d["spans"]
    disp = sp.get("chunk_dispatch", (0.0, 0, 0.0))[0]
    disp_launch = sp.get("chunk_dispatch/step.launch", (0.0, 0, 0.0))[0]
    return {
        "launch_wait_ms_per_frame": leaf.get("step.launch", (0.0, 0))[0] * 1e3 / frames,
        "dispatch_self_ms_per_frame": (disp - disp_launch) * 1e3 / frames if disp else None,
        "intake_ms_per_frame": (leaf["intake"][0] * 1e3 / frames) if "intake" in leaf else None,
    }


def span_cost_us() -> float:
    rec = tracing.Recorder()
    t0 = time.perf_counter()
    for _ in range(SPAN_COST_N):
        with rec.span("a"):
            pass
    return (time.perf_counter() - t0) * 1e6 / SPAN_COST_N


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--trace-seconds", type=float, default=None)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "trace_spans"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        log("trace_spans: needs a CUDA card")
        return 2
    bench = common.load_benchmark()
    wl = common.find_workload(bench, args.workload)
    cfg_file = common.load_data("configs", wl["config"])
    traffic = common.load_data("traffic", wl["traffic"])
    trace_s = args.trace_seconds or traffic["trace_seconds"]
    driver_cls = importlib.import_module(f"portbench.drivers.{cfg_file['entry']}").DRIVER
    driver = driver_cls(cfg_file, traffic, args.seed, "cuda")
    card = f"{torch.cuda.get_device_name(0)}, power limit {common.power_limit()}"
    log(f"card: {card}; set-up {common.process_age_s():.2f} s")
    out = {"workload": args.workload, "seed": args.seed, "card": card,
           **measure(driver, cfg_file["entry"], args.seconds, trace_s, args.reps)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}.{args.seed}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("window_spans", "traced_spans")}),
          flush=True)
    return 0


def measure(driver, entry: str, seconds: float, trace_s: float, reps: int) -> dict:
    """Steps 1-4 of the module docstring on a built driver."""
    step, view, rec = graphed_and_view(driver)
    streams = getattr(driver, "B", 1)

    # 1. the untraced window
    s0 = rec.snapshot()
    ctx = driver.window(seconds)
    win = tracing.diff(s0, rec.snapshot())
    frames = ctx["frames"]
    log(f"untraced window: {frames} frames in {ctx['window_s']:.3f} s; spans per frame:\n"
        f"{tracing.table(win, frames)}")
    out = {"frames": frames, "window_s": ctx["window_s"], "frames_per_s": frames / ctx["window_s"],
           "host_perf_ms_per_frame": (ctx["host_perf_s"] * 1e3 / frames
                                      if ctx.get("host_perf_s") is not None else None),
           **per_frame(win, frames),
           "window_spans": win["spans"], "window_counters": win["counters"]}

    # 2. the traced window, with the spans' ranges and without them
    s1 = rec.snapshot()
    span = (lambda: torch.profiler.record_function(f"portbench.{entry}"))
    tr = driver.traced_window(trace_s, traced, span=span)
    traced_spans = tracing.diff(s1, rec.snapshot())
    n_ops = sum(n for n, _ in tr["kernels"].values())
    steps = tr["frames"] / streams
    log(f"traced window: {tr['frames']} frames in {tr['window_s']:.3f} s, busy {tr['busy_s']:.3f} s, "
        f"{n_ops / steps:.1f} device operations per step; idle gaps "
        f"{json.dumps(tr['breakdown']['idle_gaps'])}; spans per frame:\n"
        f"{tracing.table(traced_spans, tr['frames'])}")
    # three more traced windows, the spans' ranges off, off, then on again
    real = torch._C._autograd._profiler_enabled
    rates = {"ranges": [tr["frames"] / tr["window_s"]], "bare": []}
    for ranges in (False, False, True):
        if not ranges:
            torch._C._autograd._profiler_enabled = lambda: False  # the spans enter no range
        try:
            t = driver.traced_window(trace_s, traced, span=span)
        finally:
            torch._C._autograd._profiler_enabled = real
        rates["ranges" if ranges else "bare"].append(t["frames"] / t["window_s"])
        if not ranges:
            bare = t
    log(f"traced frames/s with the spans' ranges {rates['ranges']}, without {rates['bare']}")
    out.update({
        "traced_frames_per_s": rates["ranges"],
        "bare_traced_frames_per_s": rates["bare"],
        "traced_idle_pct": 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"],
        "traced_ops_per_step": n_ops / steps,
        "idle_gaps": tr["breakdown"]["idle_gaps"],
        "traced_spans": traced_spans["spans"],
        "bare_idle_gaps": bare["breakdown"]["idle_gaps"],
    })

    # 3. the step's device time and its branches
    out["step_device_ms"] = driver.step_device_ms()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    times = step.branch_times(view, reps=reps)
    out["timing_call_s"] = time.perf_counter() - t0
    out["timing_peak_bytes"] = torch.cuda.max_memory_allocated() - mem0
    out["production_nodes"] = step.nodes
    out["branches"] = {k: {"device_ms": v["ms"] / streams, "ops": v["ops"]}
                       for k, v in times.items()}
    out["branch_sum_ms"] = sum(v["ms"] for v in times.values()) / streams
    out["step_launches"] = (sum(v["ops"] for v in times.values())
                            if all(v["ops"] is not None for v in times.values()) else None)
    out["branch_share_of_step"] = (out["branch_sum_ms"] / out["step_device_ms"]
                                   if out["step_device_ms"] else None)
    out["launches_share_of_traced"] = (out["step_launches"] / out["traced_ops_per_step"]
                                       if out["step_launches"] and n_ops else None)
    log("branches (device ms per frame, operations per step): " + ", ".join(
        f"{k} {v['device_ms']:.4f} ms {v['ops']}" for k, v in out["branches"].items())
        + f"; sum {out['branch_sum_ms']:.4f} against step_device_ms {out['step_device_ms']}; "
        f"launches {out['step_launches']} against {out['traced_ops_per_step']:.1f} traced")

    # 4. a span's cost with no profiler on
    out["span_cost_us"] = span_cost_us()
    log(f"one span with no profiler: {out['span_cost_us']:.3f} us")
    return out


if __name__ == "__main__":
    sys.exit(main())
