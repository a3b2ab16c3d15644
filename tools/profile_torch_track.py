#!/usr/bin/env python3
"""Where a frame's time goes in the PyTorch port's tracker.

Usage (one CUDA card, from the repository root):

    python3 tools/profile_torch_track.py [--planes] [--lines] [--frames 10] [--warmup 5] [--trace PATH]
    python3 tools/profile_torch_track.py --replay 8 [--frames 10] [--warmup 2]
    python3 tools/profile_torch_track.py --backend
    python3 tools/profile_torch_track.py --chunk 16 [--frames 64]

Tracks the synthetic 640x480 box room at the TUM1 camera with the port's
System (points only: the orbit view), then profiles `--frames` frames with
torch.profiler (CPU and CUDA activity) and prints: wall ms per frame,
device kernel ms per frame and the device's busy share, the host-device
synchronizations per frame, the kernel launches per frame, and the
operators and kernels that take the most time.  `--trace` also writes a
Chrome trace.

`--planes` turns the plane and Manhattan branch on and tracks the
"near_corner" view instead, where the Manhattan frame is found and used
(chip_smoke.py's planes phase); `--lines` adds the line branch (with
`--planes`: the full body, chip_smoke.py's full phase).  With `--replay
B` it profiles the batched multi-sequence replay (parallel/mesh.py, which
runs the full body): B streams of the near_corner view, stream s at frame
offset s,
against the shared view of keyframe 0, as chip_smoke.py's replay phase.
Every "per frame" figure is then per batched step of B frames.

`--chunk C` profiles bench.py's phase 1 instead (chip_smoke.py's chunk
phase): System(cfg, fast=True, pipeline=True, chunk=C,
enable_surfels=False) with bench.py's cfg (640x480, the full body) on the
"corner" view, 1 + 2C warm-up frames with a keyframe forced at frame
1 + C, a flush and warmup(), then `--frames` frames (rounded up to whole
chunks) and the final flush under the profiler; every figure is per
frame, the wall time that of the whole region.  With `--chunk 1` the
pipeline is off (the graphed frame step one frame at a time).  Graph
launches (``cudaGraphLaunch``) are counted apart from kernel launches.

`--backend` profiles the mapping back end and the relocalizer instead, on
chip_smoke.py's mapping and reloc traffic (full body: 120 frames of the
640x480 walk, frames 120..199 of a 200-frame walk, 5 clones of keyframe
0, a black frame, frames 5..0): for each keyframe event (``System._on_keyframe``) and each
``Relocalizer.relocalize`` call, the kernel launches, the host-device
synchronizations and copies, the device kernel ms and the wall ms under
the profiler.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from manhattanslam_tpu_torch.config import load_config  # noqa: E402
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence  # noqa: E402
from manhattanslam_tpu_torch.frontend import device_tracker as dt  # noqa: E402
from manhattanslam_tpu_torch.parallel import mesh, replay  # noqa: E402
from manhattanslam_tpu_torch.system import System  # noqa: E402

import chip_smoke  # noqa: E402


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _replay_steps(cfg, seq, frames, batch: int, dev):
    """One callable per replay step of `batch` streams (upload + step),
    sharing a carry: the traffic of chip_smoke.py's replay phase
    (parallel/replay.py)."""
    view, _ = replay.shared_view(cfg, frames[0], dev)
    native = [dt.to_native(g, d) for _, g, d in frames]
    step = mesh.build_throughput_step(cfg, batch, dev)
    first = list(range(batch))
    state = {"carry": replay.start_carry(cfg, seq, first, dev)}

    def run(i):
        g8, d16 = replay.step_frames(native, first, i, dev)
        _, state["carry"] = step(g8, d16, state["carry"], view)

    return run


def _summary(events) -> str:
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    syncs = sum(e.count for e in events if "Synchronize" in e.key)
    copies = sum(e.count for e in events if "cudaMemcpy" in e.key)
    dev_ms = sum(_device_us(e) for e in events) / 1e3
    return f"{launches} launches, {syncs} syncs, {copies} copies, device {dev_ms:.3f} ms"


def backend(cfg) -> None:
    """Profile each keyframe event and each relocalization (--backend)."""
    system = System(cfg, fast=True, enable_planes=True, enable_lines=True, enable_surfels=False)
    rows = []

    def profiled(name, fn):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = fn(*args)
                torch.cuda.synchronize()
            rows.append(f"{name}: {(time.perf_counter() - t) * 1e3:.1f} ms profiled, "
                        f"{_summary(prof.key_averages())}")
            return out
        return call

    system.tracker.on_keyframe = profiled("keyframe event", system.tracker.on_keyframe)
    system.reloc_module.relocalize = profiled("relocalize", system.reloc_module.relocalize)
    walk = SyntheticSequence(n_frames=120, cam=cfg.camera, view="walk")
    longer = SyntheticSequence(n_frames=200, cam=cfg.camera, view="walk")
    frames = [walk.frame(i) for i in range(120)] + [longer.frame(i) for i in range(120, 200)]
    for ts, gray, depth in frames:
        system.track(gray, depth, ts)
    chip_smoke.pad_with_clones(system, 5)
    system.track(gray * 0, depth * 0, 100.0)
    for i in range(5, -1, -1):
        system.track(frames[i][1], frames[i][2], 100.1 + 0.03 * (5 - i))
    print(f"device: {torch.cuda.get_device_name(0)}")
    print("\n".join(rows))
    print(f"relocalized frame {system.tracker.last_reloc_frame_id}, "
          f"keyframe {system.reloc_module.last_kf}, path {system.reloc_module.last_path}")


def chunk_path(args) -> int:
    """Profile bench.py's phase 1 at chunk C (--chunk)."""
    C = args.chunk
    cfg = chip_smoke.bench_cfg()
    f = -(-args.frames // C) * C
    warm = 1 + 2 * C
    seq = SyntheticSequence(n_frames=warm + f, cam=cfg.camera, view="corner")
    frames = [(ts, *dt.to_native(g, d)) for ts, g, d in (seq.frame(i) for i in range(warm + f))]
    system = System(cfg, fast=True, pipeline=C > 1, chunk=C, enable_surfels=False)
    for i in range(warm):
        if i == 1 + C:
            system.tracker.force_keyframe = True
        system.track(frames[i][1], frames[i][2], frames[i][0])
    system.tracker.flush()
    system.warmup()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for ts, g8, d16 in frames[warm:]:
            system.track(g8, d16, ts)
        system.tracker.flush()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / f
    events = prof.key_averages()
    dev_ms = sum(_device_us(e) for e in events) / 1e3 / f
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"chunk {C}, pipeline {C > 1}, {f} frames, per frame: wall {wall:.2f} ms "
          f"(profiled), device kernels {dev_ms:.3f} ms, busy share {dev_ms / wall:.3f}")
    def per_frame(*keys):
        return sum(e.count for e in events if any(k in e.key for k in keys)) / f

    print(f"per frame: kernel launches from the host "
          f"{per_frame('cudaLaunchKernel', 'cuLaunchKernel'):.2f}, graph launches "
          f"{per_frame('cudaGraphLaunch'):.3f}, syncs {per_frame('Synchronize'):.3f}, copies "
          f"{per_frame('cudaMemcpy'):.2f}; keyframes {system.tracker.counts['keyframes']}")
    syncs = {e.key: round(e.count / f, 3) for e in events
             if any(s in e.key for s in ("Synchronize", "cudaMemcpy", "cudaStreamWaitEvent",
                                         "cudaEventSynchronize"))}
    print("host-device sync and copy calls per frame:", syncs)
    print("top device kernels by time (ms and calls per frame):")
    for e in sorted(events, key=lambda e: -_device_us(e))[:12]:
        if _device_us(e) > 0:
            print(f"  {_device_us(e) / 1e3 / f:8.3f}  {e.count / f:7.1f}  {e.key[:90]}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--replay", type=int, default=0, metavar="B",
                    help="profile the batched replay of B streams instead")
    ap.add_argument("--planes", action="store_true",
                    help="the plane and Manhattan branch on, on the near_corner view")
    ap.add_argument("--lines", action="store_true",
                    help="the line branch on, on the near_corner view")
    ap.add_argument("--backend", action="store_true",
                    help="profile the keyframe events and relocalizations instead")
    ap.add_argument("--chunk", type=int, default=0, metavar="C",
                    help="profile bench.py's phase 1 at chunk C instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_track: needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "TUM1.yaml"))
    if args.backend:
        backend(cfg)
        return 0
    if args.chunk:
        return chunk_path(args)
    n = args.warmup + args.frames
    dev = torch.device("cuda")
    view = "near_corner" if args.planes or args.lines or args.replay else "wall"
    if args.replay:
        # a sequence long enough that no stream wraps around
        seq = SyntheticSequence(n_frames=max(30, n + args.replay), cam=cfg.camera, view=view)
        frames = [seq.frame(i) for i in range(n + args.replay)]
        run = _replay_steps(cfg, seq, frames, args.replay, dev)
        unit = f"step of {args.replay} frames"
    else:
        seq = SyntheticSequence(n_frames=n, cam=cfg.camera, view=view)
        frames = [seq.frame(i) for i in range(n)]
        system = System(cfg, fast=True, enable_planes=args.planes, enable_lines=args.lines,
                        enable_surfels=False)

        def run(i):
            ts, gray, depth = frames[i]
            system.track(gray, depth, ts)

        unit = "frame"
    for i in range(args.warmup):
        run(i)
    torch.cuda.synchronize()
    wall = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.warmup, n):
            t = time.perf_counter()
            run(i)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
    f = args.frames
    events = prof.key_averages()
    dev_ms = sum(_device_us(e) for e in events) / 1e3 / f
    med = statistics.median(wall)
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"per {unit}:")
    print(f"wall: median {med:.2f} ms over {f} (min {min(wall):.2f}, max {max(wall):.2f})")
    print(f"device kernels: {dev_ms:.3f} ms, busy share {dev_ms / med:.3f}")
    syncs = {
        e.key: e.count / f for e in events
        if any(s in e.key for s in ("Synchronize", "cudaMemcpy", "cudaStreamWaitEvent"))
    }
    print("host-device sync and copy calls:", {k: round(v, 1) for k, v in syncs.items()})
    n_launch = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    print(f"kernel launches: {n_launch / f:.0f}, graph launches: "
          f"{sum(e.count for e in events if e.key == 'cudaGraphLaunch') / f:.2f}")
    print(f"top operators by self CPU time (ms and calls per {unit}):")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:20]:
        print(f"  {e.self_cpu_time_total / 1e3 / f:8.3f}  {e.count / f:7.1f}  {e.key[:90]}")
    print(f"top device kernels by time (ms and calls per {unit}):")
    for e in sorted(events, key=lambda e: -_device_us(e))[:20]:
        if _device_us(e) > 0:
            print(f"  {_device_us(e) / 1e3 / f:8.3f}  {e.count / f:7.1f}  {e.key[:90]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
