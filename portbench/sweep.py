#!/usr/bin/env python3
"""Runs of one cell, one process each, one after another, for measuring the
spread of its metrics and the readings of its checks.

Usage, from the root of a checkout on a machine with the cell's chips:

    python3 portbench/sweep.py --workload NAME --seeds 11,12,13 --seconds 20 \\
        [--trace 0|1] [--out build/sweep.jsonl]

Each run is ``portbench/run.py`` with one seed; its result line goes to
`--out` (one JSON object per line, with the seed and the exit code).  At
the end: per metric the median and the spread (the distance between the
first and third quartiles over the median, statistics.quantiles), and per
compared number its largest reading beside its limit.  Each run's line
also keeps the card's SM clock, temperature and power draw before it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.common import spread  # noqa: E402


def card_state() -> str:
    """The card's SM clock, temperature and power draw as nvidia-smi reads
    them ("" if it cannot)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="build/sweep.jsonl")
    args = p.parse_args()
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        card = card_state()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", args.workload,
             "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        row = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": proc.returncode,
               "wall_s": wall, "card_before": card}
        row["info"] = [ln for ln in proc.stderr.splitlines()
                       if ln.startswith(("setup:", "window:", "trace:", "card:", "host sections"))]
        try:
            row["result"] = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            row["stderr_tail"] = proc.stderr[-3000:]
        rows.append(row)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        res = row.get("result", {})
        print(f"seed {seed}: rc {proc.returncode}, {wall:.1f} s, card before ({card}), "
              f"correct {res.get('correct')}, "
              f"{ {k: v['value'] for k, v in res.get('metrics', {}).items()} }", flush=True)
        if "stderr_tail" in row:
            print(row["stderr_tail"], flush=True)
    results = [r["result"] for r in rows if "result" in r]
    names = sorted({k for r in results for k in r["metrics"]})
    for name in names:
        vals = [r["metrics"][name]["value"] for r in results if name in r["metrics"]]
        print(f"metric {name}: median {statistics.median(vals)}, spread "
              f"{spread(vals) if len(vals) >= 2 else None}, values {vals}")
    for name in sorted({k for r in results for k in r.get("checks", {})}):
        vals = [r["checks"][name]["value"] for r in results if name in r.get("checks", {})]
        lim = results[0]["checks"][name]["limit"]
        print(f"check {name}: largest {max((v for v in vals if v is not None), default=None)}"
              f" (limit {lim}), values {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
