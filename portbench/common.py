"""What every part of the benchmark shares: finding a cell's files by the
names ``BENCHMARK.json`` gives them, the process clock, the card's
identity, the check that no JAX module was loaded, and the statistics.

The files of a cell, each found by name:

- ``portbench/configs/<config>.json``: the deployment (the settings file's
  keys as the program runs them, and the entry it drives);
- ``portbench/traffic/<traffic>.json``: the traffic's parameters, read by
  the one generator of its entry;
- ``portbench/cells/<workload>.json``: the limits of the numbers that
  decide ``correct``;
- ``portbench/metrics/<metric>.py``: one reader per metric, ``read(ctx)``.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names the measured process may not hold (compared whole:
# the port, manhattanslam_tpu_torch, is another name)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "manhattanslam_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def data_file(kind: str, name: str, root: Path = ROOT) -> Path:
    """The data file of a config, traffic mix or cell, by its name."""
    return root / "portbench" / kind / f"{name}.json"


def load_data(kind: str, name: str, root: Path = ROOT) -> dict:
    path = data_file(kind, name, root)
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path} for the name {name!r}")
    with open(path) as f:
        return json.load(f)


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def cell_metrics(bench: dict, workload: str, section: str) -> list[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that the cell
    reports: those that list it under ``workloads``, and those without the
    key whose end-to-end metric (``moves``, or the metric itself) the cell
    reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if section == "end_to_end":
        return e2e
    e2e_names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e_names)]


def metric_reader(name: str):
    """``read(ctx)`` of portbench/metrics/<name>.py."""
    return importlib.import_module(f"portbench.metrics.{name}").read


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against /proc/uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it ("" if it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.splitlines()[0].strip() if out else ""


# ------------------------------------------------------------- statistics
def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), over all values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return count / seconds


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of the
    median (statistics.quantiles' default method)."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2
