#!/usr/bin/env python3
"""Count the PyTorch operators of the port's frame step on the CPU.

Usage (from the repository root; no GPU needed):

    python3 tools/count_torch_ops.py

A count, not a time: torch.profiler (CPU activity) over two frames of the
box room's "corner" view at 192x144 (the parity tests' small config),
through System on the CPU with planes off, planes on, and planes and
lines on (the full body), prints the aten operators per frame, and those
of the line branch alone (detection, descriptors, lifting) at 192x144 and
at 640x480 (TUM1, the half-resolution branch); then the operators of one
evaluation of the plane rows and of one linearization of them (ops/lm.py
``_plane_rows``) for one stream with 8 planes in each family; then the
mapping back end's operators per keyframe event (``System._on_keyframe``:
the LocalMapper's stages and the relocalization index) and those of
each ``Relocalizer.relocalize`` call, over the relocalization traffic of
tests/test_torch_reloc.py (60 frames of the "walk" view, one noise frame,
frames 5..0) at 192x144, points only.  On the card
each operator that computes is about one kernel launch; launches
themselves are counted on the card by tools/profile_torch_track.py.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from manhattanslam_tpu_torch.config import (  # noqa: E402
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig,
)
from manhattanslam_tpu_torch.config import load_config  # noqa: E402
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence  # noqa: E402
from manhattanslam_tpu_torch.ops import lines, lm  # noqa: E402
from manhattanslam_tpu_torch.system import System  # noqa: E402


def aten_ops(fn, repeat: int = 1) -> float:
    """aten operators per call of fn, after one call outside the count."""
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(repeat):
            fn()
    return sum(e.count for e in prof.key_averages() if e.key.startswith("aten::")) / repeat


def main() -> int:
    cfg = SlamConfig(
        camera=CameraConfig(fx=160.0, fy=160.0, cx=95.5, cy=71.5, k1=0, k2=0, p1=0, p2=0,
                            k3=0, width=192, height=144, bf=12.0),
        orb=OrbConfig(n_features=250),
        caps=CapacityConfig(max_keypoints=256, max_lines=32, max_map_points=8192,
                            max_map_lines=512, max_keyframes=64),
    )
    seq = SyntheticSequence(n_frames=12, cam=cfg.camera, view="corner")
    frames = [seq.frame(i) for i in range(5)]
    for planes, lines_on in ((False, False), (True, False), (True, True)):
        system = System(cfg, enable_planes=planes, enable_lines=lines_on, device="cpu")
        for ts, gray, depth in frames[:3]:
            system.track(gray, depth, ts)
        it = iter(frames[3:])

        def one():
            ts, gray, depth = next(it)
            system.track(gray, depth, ts)

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            one()
            one()
        n = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::")) / 2
        print(f"frame step, planes {'on' if planes else 'off'}, lines {'on' if lines_on else 'off'}: "
              f"{n:.0f} aten operators per frame")

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for c in (cfg, load_config(os.path.join(root, "configs", "TUM1.yaml"))):
        _, gray, depth = SyntheticSequence(n_frames=2, cam=c.camera, view="near_corner").frame(0)
        g, d = torch.from_numpy(gray.round()), torch.from_numpy(depth)
        K = torch.from_numpy(c.camera.K)

        def branch():
            det = lines.detect_lines(g, c.caps.max_lines)
            lines.line_descriptors(g, det["sp"], det["ep"])
            lines.lift_lines_3d(d, K, det["sp"], det["ep"], det["valid"])

        print(f"line detection, descriptors and lifting at {c.camera.width}x{c.camera.height}: "
              f"{aten_ops(branch):.0f} aten operators")

    gen = torch.Generator().manual_seed(0)

    def planes_():
        nrm = torch.randn(1, 8, 3, generator=gen)
        return torch.cat([nrm / nrm.norm(dim=-1, keepdim=True), torch.randn(1, 8, 1, generator=gen)], -1)

    on = torch.ones(1, 8, dtype=torch.bool)
    none = [torch.zeros(1, 0, 3)] * 2 + [torch.zeros(1, 0)] + [torch.zeros(1, 0, dtype=torch.bool)] * 2
    prob = lm.PoseProblem(*none, planes_(), planes_(), on, planes_(), planes_(), on,
                          planes_(), planes_(), on)
    T = torch.eye(4)[None]
    masks = (on, on, on)
    print(f"plane rows: {aten_ops(lambda: lm._plane_rows(T, prob, masks)):.0f} aten operators")
    print(f"plane rows and their Jacobian: "
          f"{aten_ops(lambda: lm._plane_rows(T, prob, masks, False)):.0f} aten operators")
    backend_ops(cfg)
    return 0


def backend_ops(cfg) -> None:
    """aten operators of each keyframe event's back end and of each
    relocalize call on the relocalization traffic."""
    system = System(cfg, device="cpu")
    counts = {"keyframe event": [], "relocalize": []}

    def counted(name, fn):
        def call(*args):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                out = fn(*args)
            counts[name].append(
                sum(e.count for e in prof.key_averages() if e.key.startswith("aten::")))
            return out
        return call

    system.tracker.on_keyframe = counted("keyframe event", system.tracker.on_keyframe)
    system.reloc_module.relocalize = counted("relocalize", system.reloc_module.relocalize)
    seq = SyntheticSequence(n_frames=60, cam=cfg.camera, view="walk")
    for i in range(60):
        ts, gray, depth = seq.frame(i)
        system.track(gray, depth, ts)
    gen = np.random.default_rng(0)
    system.track(gen.uniform(0, 255, gray.shape).astype(np.float32),
                 gen.uniform(0.5, 6.0, depth.shape).astype(np.float32), 2.0)
    for i in range(5, -1, -1):
        ts, gray, depth = seq.frame(i)
        system.track(gray, depth, 2.1 + 0.03 * (5 - i))
    for name, c in counts.items():
        print(f"{name}: aten operators per call {c}")
    print(f"relocalized frame: {system.tracker.last_reloc_frame_id}, "
          f"path {system.reloc_module.last_path}")


if __name__ == "__main__":
    sys.exit(main())
