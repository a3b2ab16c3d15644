#!/usr/bin/env python3
"""Which shared map view the batched replay can track against, at 640x480 TUM1.

Usage (one CUDA card, from the repository root):

    python3 tools/probe_replay_view.py [--batch 8] [--steps 12]

Runs the port's build_throughput_step (the plane and Manhattan branch on)
with two shared views and two kinds of traffic, and prints, for each of
the four runs, how many of the B streams were tracked on each step, on how
many a Manhattan frame was found, and the median inlier count.

Views:
- ``bench``: bench.py's replay map (bench.py:47-71), built with the port:
  frame 0 through the step against an empty map, then up to 1000 of its
  back-projected depth keypoints as map points with normal (0, 0, 1),
  distance bounds [0, 30] m and no keyframe matches.
- ``keyframe0``: keyframe 0 of the port's tracker with planes on
  (parallel/replay.py: its points, map planes and Manhattan registries),
  the view chip_smoke.py's replay phase uses.

Traffic:
- ``bench``: bench.py's, the "corner" box-room sequence of 12 frames,
  stream s at frame (i + s) mod 12, every stream starting at the identity.
- ``smoke``: chip_smoke.py's, the near_corner sequence of steps + batch
  frames, stream s at frame s + i, starting at the ground-truth pose of
  frame s.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from manhattanslam_tpu_torch.config import load_config  # noqa: E402
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence  # noqa: E402
from manhattanslam_tpu_torch.frontend import device_tracker as dt  # noqa: E402
from manhattanslam_tpu_torch.frontend.frame import backproject_keypoints  # noqa: E402
from manhattanslam_tpu_torch.parallel import mesh, replay  # noqa: E402
from manhattanslam_tpu_torch.slam_map import SlamMap  # noqa: E402

BENCH_FRAMES = 12  # bench.py's sequence length


def bench_view(cfg, frame0, dev) -> tuple[dict, int]:
    """bench.py's shared view, built with the port; returns (view, points)."""
    m = SlamMap(cfg)
    step = dt.build_frame_step(cfg, dev)
    view0 = dt.set_ref_kf(dt.build_map_view(cfg, m, dev), m, 0)
    g8, d16 = dt.to_native(*frame0[1:])
    r0, _ = step(torch.from_numpy(g8).to(dev), torch.from_numpy(d16.astype(np.int32)).to(dev),
                 dt.init_carry(cfg, dev), view0)
    feats = dt.pull_feats(r0)
    kf = m.add_keyframe(np.eye(4, dtype=np.float32), 0.0, 0, feats)
    pts_c = backproject_keypoints(r0["feats"], cfg).cpu().numpy()
    sel = np.nonzero(feats["valid"] & (feats["depth"] > 0))[0][:1000]
    m.add_points(
        pts_c[sel], feats["desc"][sel], np.tile(np.float32([0, 0, 1]), (len(sel), 1)),
        np.zeros(len(sel), np.float32), np.full(len(sel), 30.0, np.float32),
        feats["level"][sel], kf,
    )
    return dt.set_ref_kf(dt.build_map_view(cfg, m, dev), m, kf), len(sel)


def run(cfg, dev, view, native, frame_at, carry, batch: int, steps: int) -> list[tuple]:
    """(streams tracked, streams with a Manhattan frame, median inliers)
    per step; frame_at(s, i) is the frame index of stream s at step i."""
    step = mesh.build_throughput_step(cfg, batch, dev)
    per_step = []
    for i in range(steps):
        idx = [frame_at(s, i) for s in range(batch)]
        g8 = torch.from_numpy(np.stack([native[j][0] for j in idx])).to(dev)
        d16 = torch.from_numpy(np.stack([native[j][1].astype(np.int32) for j in idx])).to(dev)
        out, carry = step(g8, d16, carry, view)
        per_step.append((int(out["tracked_ok"].sum()), int(out["manhattan_found"].sum()),
                         int(statistics.median(out["n_inliers"].tolist()))))
    return per_step


def probe(cfg, dev, batch: int, steps: int) -> dict:
    seqs = {
        "bench": SyntheticSequence(n_frames=BENCH_FRAMES, cam=cfg.camera, view="corner"),
        "smoke": SyntheticSequence(n_frames=steps + batch, cam=cfg.camera, view="near_corner"),
    }
    frames = {k: [s.frame(i) for i in range(len(s.poses))] for k, s in seqs.items()}
    native = {k: [dt.to_native(g, d) for _, g, d in f] for k, f in frames.items()}
    results = {}
    for traffic in ("bench", "smoke"):
        f0 = frames[traffic][0]
        views = {"bench": bench_view(cfg, f0, dev)}
        kf_view, tracker = replay.shared_view(cfg, f0, dev)
        views["keyframe0"] = (kf_view, int(tracker.map.mp_valid.sum()))
        for vname, (view, n_points) in views.items():
            if traffic == "bench":
                carry = mesh.init_batched_carry(cfg, batch, dev)
                frame_at = lambda s, i: (i + s) % BENCH_FRAMES  # noqa: E731
            else:
                carry = replay.start_carry(cfg, seqs["smoke"], list(range(batch)), dev)
                frame_at = lambda s, i: s + i  # noqa: E731
            per_step = run(cfg, dev, view, native[traffic], frame_at, carry, batch, steps)
            results[(vname, traffic)] = per_step
            print(f"view {vname} ({n_points} points), traffic {traffic}: streams tracked "
                  f"per step {[t for t, _, _ in per_step]} of {batch}; Manhattan found "
                  f"{[m for _, m, _ in per_step]}; median inliers "
                  f"{[n for _, _, n in per_step]}", flush=True)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_replay_view: needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "TUM1.yaml"))
    print(f"device: {torch.cuda.get_device_name(0)}; camera {cfg.camera.width}x"
          f"{cfg.camera.height}, {cfg.orb.n_features} features, batch {args.batch}", flush=True)
    probe(cfg, torch.device("cuda"), args.batch, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
