#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (manhattanslam_tpu_torch) on one CUDA card.

Usage: python3 chip_smoke.py   (from the root of a checkout; needs one GPU)

Phases, each printing one line with its elapsed seconds:

1. build   - compile the CUDA kernels in manhattanslam_tpu_torch/csrc (one
             nvcc per source, in parallel, into build/torch_kernels/) and
             print the card's name and power limit from nvidia-smi.
2. kernels - at the shapes of all 8 pyramid levels of a TUM1 frame (640x480,
             1000 ORB features), hold each kernel against its plain PyTorch
             version on the card: FAST scores and BRIEF words equal, angles
             within 1e-4 rad at the valid keypoints; time both (CUDA events
             around 20 back-to-back calls, median of 5 such windows) and
             compute each kernel's bound.
3. track   - the points-only System over 30 synthetic 640x480 frames at the
             TUM1 camera, with every kernel's launch count set to 0 first:
             all frames tracked, ATE against the renderer's ground truth
             below 0.05 m, every kernel launched.

Any failure raises and the script exits nonzero.  It writes only into a
temporary directory and the kernel build directory, and starts no thread.
The last two lines are the kernels JSON and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from manhattanslam_tpu_torch.config import load_config
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu_torch.frontend import device_tracker as dt
from manhattanslam_tpu_torch.frontend import frame
from manhattanslam_tpu_torch.io import trajectory as traj_io
from manhattanslam_tpu_torch.ops import fast as fast_ops
from manhattanslam_tpu_torch.ops import image as image_ops
from manhattanslam_tpu_torch.ops import kernel_build
from manhattanslam_tpu_torch.ops import orb as orb_ops
from manhattanslam_tpu_torch.system import System

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 30
ATE_LIMIT = 0.05
ANGLE_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# float ops per interior pixel of the FAST score: 16 differences,
# 2 x 16 arcs x 8 mins, 2 x 16 maxes, 2 final maxes
FAST_OPS_PER_PIXEL = 16 + 2 * 16 * 8 + 2 * 16 + 2
# per disc pixel: 2 multiplies + 2 adds (m01, m10)
IC_OPS_PER_PIXEL = 4
# per pattern point: 4 multiplies, 2 add/sub, 2 adds, 2 roundings,
# 4 clamps; per pair 2 points + 1 compare
BRIEF_OPS_PER_PAIR = 2 * 14 + 1

KERNELS = {
    "fast_score": dict(
        source="manhattanslam_tpu_torch/csrc/fast.cu",
        replaces="manhattanslam_tpu/ops/fast_pallas.py:33 (_fast_kernel; batched twin :92)",
        wrapper=fast_ops.fast_score_map,
    ),
    "ic_angle": dict(
        source="manhattanslam_tpu_torch/csrc/ic_angle.cu",
        replaces="manhattanslam_tpu/ops/orb_pallas.py:235 (_make_moments_kernel; batched twin :299)",
        wrapper=orb_ops.ic_angle,
    ),
    "brief": dict(
        source="manhattanslam_tpu_torch/csrc/brief.cu",
        replaces="manhattanslam_tpu/ops/orb_pallas.py:66 (_make_brief_kernel; batched twin :133)",
        wrapper=orb_ops.brief_descriptors,
    ),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Device time of one fn() call: `reps` back-to-back calls between two
    CUDA events, divided by reps; the median of `trials` such windows,
    after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> str:
    t0 = time.perf_counter()
    kernel_build.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"phase build: {len(kernel_build.SIGNATURES)} kernels built, "
        f"{time.perf_counter() - t0:.1f} s")
    return smi


def phase_kernels(cfg, dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    t0 = time.perf_counter()
    seq = SyntheticSequence(n_frames=N_FRAMES, cam=cfg.camera)
    _, gray, depth = seq.frame(0)
    g8, _ = dt.to_native(gray, depth)
    img = torch.from_numpy(g8).to(dev).to(torch.float32)
    ops = image_ops.pyramid_operators(
        cfg.camera.height, cfg.camera.width, cfg.orb.n_levels, cfg.orb.scale_factor, dev
    )
    levels = image_ops.build_pyramid(img, ops)
    budgets = cfg.orb.features_per_level()
    stream = torch.cuda.current_stream(dev).cuda_stream
    fns = kernel_build.build()
    pattern = orb_ops.device_constant("PATTERN", dev)
    umax = orb_ops.device_constant("UMAX", dev)
    circ = orb_ops.device_constant("CIRC_MASK", dev)
    stats = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                     bytes=0.0, ops=0.0) for k in KERNELS}
    for li, level in enumerate(levels):
        h, w = level.shape
        n = budgets[li]
        # FAST: bit-identical scores
        score = fast_ops.fast_score_map(level)
        plain = fast_ops.fast_score_map_plain(level)
        if not torch.equal(score, plain):
            raise RuntimeError(f"fast_score level {li}: kernel != plain version")
        out = torch.empty_like(level)
        st = stats["fast_score"]
        st["ms"] += median_ms(lambda: fns["fast"](level.data_ptr(), out.data_ptr(), h, w, stream))
        st["plain_ms"] += median_ms(lambda: fast_ops.fast_score_map_plain(level))
        st["bytes"] += 2 * h * w * 4
        st["ops"] += FAST_OPS_PER_PIXEL * (h - 6) * (w - 6)

        # the level's keypoints, as the extractor picks them
        xy, _, valid = frame.level_keypoints(level, n, cfg)

        # IC angle: within ANGLE_TOL at the valid keypoints (wrapped)
        ang = orb_ops.ic_angle(level, xy)
        ang_p = orb_ops.ic_angle_plain(level, xy)
        dang = torch.remainder(ang - ang_p + math.pi, 2 * math.pi) - math.pi
        err = float(dang[valid].abs().max()) if bool(valid.any()) else 0.0
        if not err <= ANGLE_TOL:
            raise RuntimeError(f"ic_angle level {li}: max error {err} rad > {ANGLE_TOL}")
        st = stats["ic_angle"]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        ang_out = torch.empty(n, dtype=torch.float32, device=dev)
        st["ms"] += median_ms(lambda: fns["ic_angle"](
            level.data_ptr(), xy.data_ptr(), umax.data_ptr(), ang_out.data_ptr(), n, h, w, stream))
        st["plain_ms"] += median_ms(lambda: orb_ops.ic_angle_plain(level, xy))
        disc_px = orb_ops.ic_patch_index(xy, h, w)[circ.expand(n, -1, -1)]
        n_uniq = int(torch.unique(disc_px).numel())
        st["bytes"] += 4 * n_uniq + 8 * n + 4 * umax.numel() + 4 * n
        st["ops"] += IC_OPS_PER_PIXEL * float(circ.sum()) * n

        # BRIEF: bit-exact words from the kernel's angles
        blurred = torch.round(image_ops.gaussian_blur(level, 7, 2.0))
        desc = orb_ops.brief_descriptors(blurred, xy, ang)
        desc_p = orb_ops.brief_descriptors_plain(blurred, xy, ang)
        if not torch.equal(desc, desc_p):
            bad = int((desc != desc_p).any(dim=1).sum())
            raise RuntimeError(f"brief level {li}: {bad} keypoints differ from the plain version")
        ca, sa = torch.cos(ang), torch.sin(ang)
        desc_out = torch.empty((n, 8), dtype=torch.int32, device=dev)
        st = stats["brief"]
        st["ms"] += median_ms(lambda: fns["brief"](
            blurred.data_ptr(), xy.data_ptr(), ca.data_ptr(), sa.data_ptr(),
            pattern.data_ptr(), desc_out.data_ptr(), n, h, w, stream))
        st["plain_ms"] += median_ms(lambda: orb_ops.brief_descriptors_plain(blurred, xy, ang))
        n_uniq = int(torch.unique(orb_ops.brief_sample_index(xy, ca, sa, h, w)).numel())
        st["bytes"] += 4 * n_uniq + 8 * n + 8 * n + 4 * pattern.numel() + 32 * n
        st["ops"] += BRIEF_OPS_PER_PAIR * 256 * n

    for name, st in stats.items():
        st["bound_ms"], st["bound_by"] = bound(st.pop("bytes"), st.pop("ops"))
        log(f"kernels {name}: max_abs_err {st['max_abs_err']:.3g}, "
            f"{st['ms']:.4f} ms/frame ({len(levels)} launches), plain {st['plain_ms']:.4f} ms, "
            f"bound {st['bound_ms']:.6f} ms ({st['bound_by']})")
    log(f"phase kernels: {len(levels)} levels, all kernels agree with their plain "
        f"versions, {time.perf_counter() - t0:.1f} s")
    return stats


def phase_track(cfg, tmp: str) -> dict:
    """The points-only System over N_FRAMES frames; returns launch counts."""
    t0 = time.perf_counter()
    seq = SyntheticSequence(n_frames=N_FRAMES, cam=cfg.camera)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    system = System(cfg)  # CUDA by default
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    ms, tracked = [], 0
    for ts, gray, depth in frames:
        t = time.perf_counter()
        T = system.track(gray, depth, ts)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        if T is not None and np.isfinite(T).all():
            tracked += 1
    launches = {name: k["wrapper"].launches for name, k in KERNELS.items()}
    system.shutdown()
    traj = os.path.join(tmp, "CameraTrajectory.txt")
    system.save_trajectory_tum(traj)
    system.save_keyframe_trajectory_tum(os.path.join(tmp, "KeyFrameTrajectory.txt"))
    ts_e, pos_e, _ = traj_io.load_trajectory_tum(traj)
    gt = seq.gt_rows()
    ate = traj_io.ate_rmse(
        (ts_e, pos_e), (np.array([r[0] for r in gt]), np.array([r[1] for r in gt]))
    )
    med = statistics.median(ms[1:])
    log(f"track: {tracked}/{N_FRAMES} frames tracked, {system.map.n_kf} keyframes, "
        f"ATE {ate:.4f} m, median {med:.1f} ms/frame (first frame {ms[0]:.0f} ms), "
        f"launches {launches}")
    if tracked != N_FRAMES:
        raise RuntimeError(f"only {tracked} of {N_FRAMES} frames tracked")
    if not ate < ATE_LIMIT:
        raise RuntimeError(f"ATE {ate} m is not below {ATE_LIMIT} m")
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the main path")
    log(f"phase track: {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = load_config(os.path.join(HERE, "configs", "TUM1.yaml"))
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    phase_build()
    stats = phase_kernels(cfg, dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_track(cfg, tmp)
    rows = []
    for name, k in KERNELS.items():
        st = stats[name]
        rows.append({
            "name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": launches[name], "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
