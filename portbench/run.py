#!/usr/bin/env python3
"""The benchmark of manhattanslam_tpu_torch on one NVIDIA card.

Usage, from the root of a checkout:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Reads the workload's entry in BENCHMARK.json and finds its configuration,
traffic and limits by name (portbench/configs, portbench/traffic,
portbench/cells).  Set-up (counted in ``setup_s``, from the start of the
process) renders the traffic on the card from the seed, builds the
program's entry and warms every shape the window uses.  The window runs
the traffic closed loop for S seconds.  With ``--trace 0`` the result
holds the cell's end-to-end metrics; with ``--trace 1`` a further window
of the same traffic runs under torch.profiler and the result holds the
per-layer metrics, the device's busy seconds and a breakdown.  After the
windows, with the program's state freed, the timed path's outputs are
compared with the ground truth and the plain reference (judge.py), and
each number compared is printed beside its limit: as the last lines on
standard error, and last in the result.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), checks.  Without
a CUDA card holding the chips the cell asks for, the run prints no result
and exits with 2; when a JAX module was loaded, with 3.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# a library that would load JAX by itself is kept from it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from portbench import common  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


# traced launches whose frames the ORB kernels' least time is counted on
# (evenly spaced over the traced window)
LEAST_LAUNCHES = 16


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(workload: dict, cfg_file: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device) -> tuple[dict, dict, dict]:
    """Set-up, the window, the traced window and the check of one run on
    `device`.  Returns (ctx for the metric readers, the numbers compared,
    facts for the result: attempted, failed, memory)."""
    import importlib

    import torch

    from portbench import judge

    driver_cls = importlib.import_module(f"portbench.drivers.{cfg_file['entry']}").DRIVER
    before = common.process_age_s()
    driver = driver_cls(cfg_file, traffic, seed, device)
    cuda = torch.device(device).type == "cuda"
    setup_s = common.process_age_s()
    log(f"setup: {before} s to the driver (interpreter, imports, CUDA), then "
        f"{ {k: round(v, 3) for k, v in driver.setup_parts.items()} }")
    ctx = driver.window(seconds)
    ctx["setup_s"] = setup_s
    facts = {"attempted": ctx["frames"],
             "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    ref = judge.reference_params(cfg_file)
    if trace:
        from torch.profiler import record_function

        from portbench.trace import traced

        ctx["trace"] = driver.traced_window(
            traffic["trace_seconds"], traced,
            span=lambda: record_function(f"portbench.{cfg_file['entry']}"))
        ctx["step_device_ms"] = driver.step_device_ms()
    facts["failed"] = driver.failed(ctx)
    outputs = driver.free()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = driver.check_numbers(outputs, ref)
    log(f"check: {numbers['compared_frames']:.0f} frames against the reference in "
        f"{time.perf_counter() - t0:.1f} s")
    if trace:
        launches = ctx["trace"]["launch_frames"]
        every = max(1, len(launches) // LEAST_LAUNCHES)
        ctx["least_ms"] = judge.mean_least_ms(
            [driver.rgb[idx, ..., 0] for idx in launches[::every]], ref, device)
    return ctx, numbers, facts


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = common.load_benchmark()
    workload = common.find_workload(bench, args.workload)
    cfg_file = common.load_data("configs", workload["config"])
    traffic = common.load_data("traffic", workload["traffic"])
    limits = common.load_data("cells", workload["name"])["limits"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        log(f"portbench: {workload['name']} needs {workload['chips']} CUDA device(s); "
            f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    limit = common.power_limit()
    log(f"card: {torch.cuda.get_device_name(0)}, power limit {limit}")

    from portbench import judge

    ctx, numbers, facts = run_cell(workload, cfg_file, traffic, args.seed, args.seconds,
                                   bool(args.trace), "cuda")
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in common.cell_metrics(bench, workload["name"], section):
        value = common.metric_reader(m["name"])(ctx)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"window: {ctx['frames']} frames handed in over {ctx['window_s']} s, "
        f"{len(ctx['call_ms'])} calls timed, slowest {max(ctx['call_ms'], default=0):.1f} ms, "
        f"{ctx.get('keyframes', 0)} keyframes made")
    if ctx.get("host_sections_s"):
        log(f"host sections over the window (s): "
            f"{ {k: round(v, 4) for k, v in ctx['host_sections_s'].items()} }")
    if args.trace:
        tr = ctx["trace"]
        log(f"trace: {tr['window_s']} s traced ({tr['frames']} frames), device busy "
            f"{tr['busy_s']} s; "
            f"ORB kernels' least ms per launch {ctx.get('least_ms')}; power limit {limit}")
    correct, checks = judge.verdict(numbers, limits)
    loaded = common.forbidden_modules()
    if loaded:
        log(f"portbench: the process holds {loaded} after the window; no result")
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": workload["chips"], "memory_peak_bytes": int(facts["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": int(facts["attempted"]),
              "failed": int(facts["failed"]), "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = ctx["trace"]["busy_s"]
        device["window_s"] = ctx["trace"]["window_s"]
        result["breakdown"] = ctx["trace"]["breakdown"]
    log(f"compared besides: {json.dumps({k: v for k, v in numbers.items() if k not in limits})}")
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
