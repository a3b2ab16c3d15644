#!/usr/bin/env python3
"""Triangulation yield of the mapping back end, the reference against the
port, at 640x480 on the CPU.

Usage (from any directory; CPU only, outside the tier-1 tests; the
reference's full-body step compiles for minutes):

    MSLAM_JAX_CACHE="" JAX_PLATFORMS=cpu python3 tools/compare_mapping_yield.py [--frames 61]

Runs the reference's ``System(fast=True, enable_surfels=False)`` (planes
and lines on, its defaults) and the port's ``System(device="cpu")`` with
the same flags over the first `--frames` frames of chip_smoke.py's mapping
walk (configs/TUM1.yaml, the 640x480 "walk" view of a 120-frame
sequence; 61 frames give two keyframe events with neighbours), and
prints for each package the keyframes made and the map points made from
depth, triangulated, fused and erased by the back end.  The counts come
from the same wrappers around the back end's stages in both packages
(``_tri_apply``: points that became valid; ``_fuse_apply``: keyframe
observations set, and points merged away; ``cull_map_points``: points
erased), so they do not depend on either package's own counters.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def instrument(system) -> Counter:
    """Wrap the back end's stages of `system` to count what they change."""
    lm = system.local_mapper
    counts = Counter()

    def wrap(name, fn):
        def call(*args, **kwargs):
            m = lm.map
            valid0, obs0 = m.mp_valid.copy(), m.kf_mp_idx.copy()
            out = fn(*args, **kwargs)
            gone = int((valid0 & ~m.mp_valid).sum())
            if name == "_tri_apply":
                counts["triangulated"] += int((m.mp_valid & ~valid0).sum())
            elif name == "_fuse_apply":
                counts["fused observations"] += int((m.kf_mp_idx != obs0).sum())
                counts["merged"] += gone
            else:
                counts["erased"] += gone
            return out
        return call

    for name in ("_tri_apply", "_fuse_apply", "cull_map_points"):
        setattr(lm, name, wrap(name, getattr(lm, name)))
    process = lm.process_keyframe

    def events(kf_id):
        counts["keyframe events"] += 1
        return process(kf_id)

    lm.process_keyframe = events
    return counts


def run(name, system, seq, n) -> None:
    counts = instrument(system)
    t0 = time.perf_counter()
    lost = 0
    for i in range(n):
        ts, gray, depth = seq.frame(i)
        if system.track(gray, depth, ts) is None:
            lost += 1
    system.shutdown()
    m = system.map
    kf = [int(f) for f, v in zip(m.kf_frame_id[: m.n_kf], m.kf_valid[: m.n_kf]) if v]
    print(f"{name}: {n} frames ({lost} lost) in {time.perf_counter() - t0:.1f} s; keyframes "
          f"{m.n_kf} made, live at frames {kf}; {dict(counts)}; live map points "
          f"{int(m.mp_valid.sum())}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=61)
    args = ap.parse_args()
    import manhattanslam_tpu  # noqa: F401  (the reference's float32 matmul precision)
    from manhattanslam_tpu.config import load_config as jax_load_config
    from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
    from manhattanslam_tpu.system import System as JaxSystem
    from manhattanslam_tpu_torch.config import load_config
    from manhattanslam_tpu_torch.system import System

    path = os.path.join(ROOT, "configs", "TUM1.yaml")
    jcfg, pcfg = jax_load_config(path), load_config(path)
    seq = SyntheticSequence(n_frames=120, cam=jcfg.camera, view="walk")
    run("port", System(pcfg, fast=True, enable_surfels=False, device="cpu"), seq, args.frames)
    run("reference", JaxSystem(jcfg, fast=True, enable_surfels=False), seq, args.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
