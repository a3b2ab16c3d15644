#!/usr/bin/env python3
"""Find the first operator of the fused step whose output differs between
two runs on the same inputs.

Usage (from the repository root; CUDA unless --cpu):

    python3 tools/probe_determinism.py [--runs 2] [--cpu]

Builds tests/test_torch_cuda.py's small configuration (192x144) and the
shared view of keyframe 0 of the box room's orbit (parallel/replay.py),
then runs, each `--runs` times on the same inputs: the batched replay
body (the full body, 3 streams at frame offsets 1, 4 and 8, the inputs of
test_replay_step_matches_single_stream_step) and the single-stream frame
step (the full body, stream 1's frame).  A dispatch mode records every
aten operator's outputs (not those of the empty allocations and views); the runs are compared operator by operator, and
the tool prints, per step, the number of operators, how many differ
between runs, and the first few that do (index, name, largest
difference).  A step that is deterministic prints no differing operator.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from manhattanslam_tpu_torch.config import (  # noqa: E402
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig,
)
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence  # noqa: E402
from manhattanslam_tpu_torch.frontend import device_tracker as dt  # noqa: E402
from manhattanslam_tpu_torch.parallel import replay  # noqa: E402


def small_cfg() -> SlamConfig:
    return SlamConfig(
        camera=CameraConfig(fx=160.0, fy=160.0, cx=95.5, cy=71.5, k1=0, k2=0, p1=0, p2=0, k3=0,
                            width=192, height=144, bf=12.0),
        orb=OrbConfig(n_features=250),
        caps=CapacityConfig(max_keypoints=256, max_lines=32, max_map_points=8192,
                            max_map_lines=512, max_keyframes=64),
    )


class Recorder(TorchDispatchMode):
    """Keeps (operator name, clones of its tensor outputs) for every aten
    call."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # uninitialized buffers and views of them are not results
        if func.is_view or "empty" in str(func):
            return out
        flat = out if isinstance(out, (tuple, list)) else [out]
        self.ops.append((str(func), [t.detach().clone() for t in flat
                                     if isinstance(t, torch.Tensor)]))
        return out


def record(fn) -> list:
    with torch.no_grad(), Recorder() as rec:
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return rec.ops


def differ(a: torch.Tensor, b: torch.Tensor) -> float | None:
    """None when equal bit for bit (NaNs in the same places), else the
    largest absolute difference."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    if a.dtype.is_floating_point:
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        if bool(same.all()):
            return None
        return float((a.double() - b.double()).abs().nan_to_num(float("inf"))[~same].max())
    if torch.equal(a, b):
        return None
    return float((a.long() - b.long()).abs().max()) if a.dtype != torch.bool else 1.0


def compare(name: str, runs: list) -> None:
    base = runs[0]
    print(f"{name}: {len(base)} operators per run, {len(runs)} runs")
    for r, other in enumerate(runs[1:], 1):
        if len(other) != len(base):
            print(f"  run {r}: {len(other)} operators, not {len(base)}")
            continue
        bad = []
        for i, ((op, outs), (op2, outs2)) in enumerate(zip(base, other)):
            d = [differ(a, b) for a, b in zip(outs, outs2)]
            d = [x for x in d if x is not None]
            if op != op2 or d:
                bad.append((i, op, max(d) if d else None))
        print(f"  run {r} against run 0: {len(bad)} operators differ")
        for i, op, d in bad[:8]:
            print(f"    #{i} {op}: largest difference {d}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    dev = torch.device("cpu" if args.cpu else "cuda")
    cfg = small_cfg()
    seq = SyntheticSequence(n_frames=30, cam=cfg.camera)
    first = [1, 4, 8]
    frames = [seq.frame(i) for i in range(max(first) + 3)]
    view, _ = replay.shared_view(cfg, frames[0], dev)
    native = [dt.to_native(g, d) for _, g, d in frames]
    carry = replay.start_carry(cfg, seq, first, dev)
    g8, d16 = replay.step_frames(native, first, 0, dev)
    body = dt.build_batched_body(cfg, dev, enable_planes=True, enable_lines=True)
    gray, depth = dt.frame_to_float(g8, d16)
    compare("replay body (B = 3)",
            [record(lambda: body(gray, depth, carry, view)) for _ in range(args.runs)])
    single = dt.build_frame_step(cfg, dev, enable_planes=True, enable_lines=True)
    one = {k: v[1] for k, v in carry.items()}
    compare("frame step (stream 1)",
            [record(lambda: single(g8[1], d16[1], one, view)) for _ in range(args.runs)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
