#!/usr/bin/env python3
"""The control of the check that decides ``correct``, and the sound
readings beside it: for each seed, a run of the cell's program (set-up
and a short window at the cell's own load), then at the frames the run
sampled, the plain reference against the program (the sound reading)
and the control against the plain reference, both read by the same
numbers and limits as the benchmark's runs.  The benchmark's own runs
never run the control.

The port computes in float32 with TF32 off (it pins
``torch.backends.cuda.matmul.allow_tf32 = False`` when imported), so the
nearest precision below is TF32 for its products (float32 on the tensor
cores with 10-bit mantissas) and bfloat16 for the float32 it holds (the
depth in metres, from which the keypoints' depths, the planes, the
lines' 3D points and the stereo rows of the pose solves come).  The
control is the plain reference computed with TF32 products and its depth
in bfloat16, put in the program's place: from the program's carry and
view at each sampled chunk, as the reference itself runs.  The program
has no lower-precision path of its own.

Usage, from the root of a checkout on a card:

    python3 portbench/control.py --workload NAME --seeds 1,2,3 --seconds 8 \
        [--control-seeds 1,2,3]

Prints one JSON line per seed: the sound numbers and, for the seeds in
``--control-seeds`` (all by default), the control's, each beside its
limit with ``correct`` as the benchmark would decide it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import common, judge  # noqa: E402


def set_tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def readings(workload: dict, cfg_file: dict, traffic: dict, seed: int, seconds: float,
             with_control: bool, device) -> tuple[dict, dict | None]:
    """(sound numbers, control numbers or None) of one seed: the program's
    window, then the reference and the control at its samples."""
    import importlib

    import torch

    ref = judge.reference_params(cfg_file)
    driver_cls = importlib.import_module(f"portbench.drivers.{cfg_file['entry']}").DRIVER
    driver = driver_cls(cfg_file, traffic, seed, device)
    driver.window(seconds)
    outputs = driver.free()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    sound, ctl = judge.FrameTally(), judge.FrameTally()
    for frames, (carry, view), prog in outputs:
        sensor = driver.sensor_steps(frames)
        exact = judge.reference_frames(sensor, carry, view, ref, device)
        for p, e in zip(prog, exact):
            sound.add(p, e)
        if with_control:
            set_tf32(True)
            try:
                low = judge.reference_frames(sensor, carry, view, ref, device,
                                             depth_dtype=torch.bfloat16)
            finally:
                set_tf32(False)
            for lo, e in zip(low, exact):
                ctl.add(lo, e)

    return judge.tally_numbers(sound), (judge.tally_numbers(ctl) if with_control else None)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control-seeds", default=None)
    args = p.parse_args()
    bench = common.load_benchmark()
    workload = common.find_workload(bench, args.workload)
    cfg_file = common.load_data("configs", workload["config"])
    traffic = common.load_data("traffic", workload["traffic"])
    limits = common.load_data("cells", workload["name"])["limits"]

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl_seeds = set(seeds if args.control_seeds is None
                    else [int(s) for s in args.control_seeds.split(",")])
    for seed in seeds:
        sound, ctl = readings(workload, cfg_file, traffic, seed, args.seconds,
                              seed in ctl_seeds, "cuda")
        line = {"workload": workload["name"], "seed": seed}
        for kind, numbers in (("sound", sound), ("control", ctl)):
            if numbers is not None:
                correct, checks = judge.verdict(numbers, limits)
                line[kind] = {"correct": correct, "numbers": numbers, "checks": checks}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
