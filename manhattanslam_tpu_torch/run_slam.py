"""CLI sequence runner, the counterpart of examples/run_slam.py (the
reference's Example/manhattan_slam.cc).

Usage:
  python -m manhattanslam_tpu_torch.run_slam --settings configs/TUM1.yaml \\
      --sequence /path/to/rgbd_dataset --associations assoc.txt
  python -m manhattanslam_tpu_torch.run_slam --synthetic 60      # built-in box room
  python -m manhattanslam_tpu_torch.run_slam --synthetic 12 --width 192 --height 144 \\
      --device cpu

Runs the full SLAM pipeline over the sequence (on CUDA unless --device
says otherwise), prints the median and mean per-frame tracking time
(manhattan_slam.cc:106-113) and the frames tracked, and saves
CameraTrajectory.txt / KeyFrameTrajectory.txt (TUM format) and
Surfels.ply under --out-prefix; with --synthetic, the ATE against the
renderer's poses.  A TUM sequence's frames are loaded before each
``track`` call, outside its timing.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m manhattanslam_tpu_torch.run_slam",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--settings", help="reference-format YAML settings file")
    ap.add_argument("--sequence", help="TUM sequence directory")
    ap.add_argument("--associations", help="associations file")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="run N frames of the built-in synthetic box room instead")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--no-planes", action="store_true")
    ap.add_argument("--no-lines", action="store_true")
    ap.add_argument("--no-surfels", action="store_true")
    ap.add_argument("--modular", action="store_true",
                    help="use the modular per-stage tracker instead of the fused step")
    ap.add_argument("--pipeline", action="store_true",
                    help="overlap the card's work with the result pulls (1-frame latency)")
    ap.add_argument("--chunk", type=int, default=1, metavar="C",
                    help="C frames per dispatch (one upload and one pull per chunk)")
    ap.add_argument("--photo", action="store_true",
                    help="with --synthetic: real-photograph textures and depth noise "
                         "(datasets/phototex.py; needs matplotlib and PIL)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of the tracking loop into DIR")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--out-prefix", default="")
    return ap


def _profiler(device_type: str):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)

    from manhattanslam_tpu_torch import resolve_device
    from manhattanslam_tpu_torch.config import CameraConfig, SlamConfig, load_config
    from manhattanslam_tpu_torch.system import System

    device = resolve_device(args.device)
    if args.synthetic:
        from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence

        if args.settings:
            cfg = load_config(args.settings)
        else:
            f = 525.0 * args.width / 640.0
            cfg = SlamConfig(camera=CameraConfig(
                fx=f, fy=f, cx=args.width / 2 - 0.5, cy=args.height / 2 - 0.5,
                k1=0, k2=0, p1=0, p2=0, k3=0,
                width=args.width, height=args.height, bf=f * 0.075,
            ))
        if args.photo:
            from manhattanslam_tpu_torch.datasets.phototex import PhotoSequence

            seq = PhotoSequence(n_frames=args.synthetic, cam=cfg.camera)
        else:
            seq = SyntheticSequence(n_frames=args.synthetic, cam=cfg.camera)
        frames = (seq.frame(i) for i in range(len(seq)))
        n_frames = len(seq)
        gt_rows = seq.gt_rows()
    else:
        if not (args.settings and args.sequence and args.associations):
            ap.error("need --settings, --sequence and --associations (or --synthetic N)")
        from manhattanslam_tpu_torch.datasets.tum import TumSequence, to_gray

        cfg = load_config(args.settings)
        tum = TumSequence(args.sequence, args.associations, cfg.depth_map_factor)
        n_frames = len(tum)
        frames = ((fr.timestamp, to_gray(fr.rgb, cfg.camera.rgb), fr.depth) for fr in tum)
        gt_rows = None

    slam = System(
        cfg,
        enable_planes=not args.no_planes,
        enable_lines=not args.no_lines,
        enable_surfels=not args.no_surfels,
        fast=not args.modular,
        pipeline=args.pipeline and not args.modular,
        chunk=args.chunk if not args.modular else 1,
        device=device,
    )

    print(f"Tracking {n_frames} frames ({cfg.camera.width}x{cfg.camera.height}) on {device} ...")
    times = []
    prof = _profiler(device.type) if args.trace else contextlib.nullcontext()
    with prof:
        for i, (t, gray, depth) in enumerate(frames):
            t0 = time.perf_counter()
            slam.track(gray, depth, t)
            times.append(time.perf_counter() - t0)
            if (i + 1) % 50 == 0:
                print(f"  frame {i+1}/{n_frames}  ({1.0/np.mean(times[-50:]):.1f} fps)")
        slam.shutdown()
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "track_trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}")
    n_ok = sum(not r.lost for r in slam.tracker.records)
    times = np.array(times)
    # manhattan_slam.cc:106-113 report format
    print("-------")
    print(f"median tracking time: {np.median(times):.6f}")
    print(f"mean tracking time: {np.mean(times):.6f}")
    print(f"tracked: {n_ok}/{n_frames} frames")

    pf = args.out_prefix
    slam.save_trajectory_tum(pf + "CameraTrajectory.txt")
    slam.save_keyframe_trajectory_tum(pf + "KeyFrameTrajectory.txt")
    print(f"saved {pf}CameraTrajectory.txt, {pf}KeyFrameTrajectory.txt")
    if not args.no_surfels and slam.surfel_mapper is not None:
        slam.save_surfels(pf + "Surfels.ply")
        print(f"saved {pf}Surfels.ply")

    if gt_rows is not None:
        from manhattanslam_tpu_torch.io.trajectory import ate_rmse, load_trajectory_tum

        ts, pos, _ = load_trajectory_tum(pf + "CameraTrajectory.txt")
        gt_ts = np.array([r[0] for r in gt_rows])
        gt_pos = np.array([r[1] for r in gt_rows])
        print(f"ATE RMSE vs synthetic ground truth: {ate_rmse((ts, pos), (gt_ts, gt_pos)):.4f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
