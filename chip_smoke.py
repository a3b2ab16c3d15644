#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (manhattanslam_tpu_torch) on one CUDA card.

Usage: python3 chip_smoke.py   (from the root of a checkout; needs one GPU)

Phases, each printing one line with its elapsed seconds:

1. build   - compile the CUDA kernels and the host C++ AHC merge in
             manhattanslam_tpu_torch/csrc (one nvcc or g++ per source, in
             parallel, into build/torch_kernels/) and print the card's name
             and power limit from nvidia-smi.
2. kernels - at the shapes of all 8 pyramid levels of a TUM1 frame (640x480,
             1000 ORB features), hold each kernel against its plain PyTorch
             version on the card, launched as the extractor launches it
             (each once for all levels; BRIEF blurs the raw levels itself):
             FAST scores and BRIEF words equal, angles within 1e-4 rad at
             the valid keypoints, and the all-level launches equal to one
             launch per level (BRIEF also to its other thread layout).
             Time each kernel twice: `ms`, CUDA events around 20
             back-to-back calls from Python (median of 5 such windows), and
             `device_ms`, the same 20 launches captured once in a CUDA
             graph and replayed between two events, which leaves out the
             host's issue rate; compute each kernel's bound.  Log BRIEF's
             `device_ms` in both thread layouts and that of the eager blur
             chain its kernel replaced.  Then the same for B = 8 different
             frames in one launch, each also held equal to B single-image
             launches, with the bound recomputed for the B frames; and the
             batched pyramid and features against single-frame extraction
             (reported).  The pose solve (csrc/lm_solve.cu, which replaces
             no TPU kernel) on the three solves of one full-body step of
             640x480 near_corner frames, at B = 1 (its row) and B = 8:
             within 1e-5 m and rad of the plain solve, two launches bit
             for bit equal, timed the same way.
Every System phase runs the mapping back end and the relocalizer on each
keyframe (inside track, on the calling thread) and prints, besides its
median ms per frame, the largest and the back end's host ms per keyframe
event and stage.  Every System's step runs from a CUDA graph: the first
frame eagerly, the second captures, every later one replays; the launch
counts go up by the captured launches on every replay.

3. chunk   - bench.py's phase 1 on the port: System(cfg, fast=True,
             pipeline=True, chunk=16, enable_surfels=False) with bench.py's
             cfg (640x480, fx 525, bf 40, default caps; the full body) on
             the "corner" view, sensor-native frames: 1 + 2 x 16 warm-up
             frames with a keyframe forced at frame 17, a flush and
             warmup(), then 5 timed windows of 32 frames in one region.
             Prints the median ms per frame over the windows, the frames
             tracked (>= 90% of the timed ones, bench.py's bar), the ATE
             (< 0.05 m), the keyframes made (at least one event besides
             keyframe 0 and the forced one), the tracker's host ms by
             section (summary pull, the deferred back end, and at a
             keyframe the payload pull, bookkeeping, the two view row
             diffs and the back end), graph replays and kernel launches
             per frame (each kernel once per frame, the pose solve three
             times, counted through the replays) and the step's device ms
             per frame (its graph
             replayed back to back) with the busy share it gives.  The same
             frames then run at chunk=1 without the pipeline (the graphed
             frame step), printed beside it with the card's name and power
             limit.  The corner traffic mints no keyframe past the forced
             one, so the same chunk-16 pipelined System then runs the
             mapping phase's 120-frame walk, where keyframes come from the
             policy at chunk boundaries: every frame recorded, >= 90%
             tracked, ATE < 0.05 m, at least one keyframe event besides
             keyframe 0, each kernel once per frame run on the card (the
             flushed partial chunk's padding included).  Last, the graphed
             frame step against the eager step
             on the same frames, carry and view, bit for bit: after the
             capture, after a view update written in place and after a
             carry reset in place (a relocalization's).
3a. surfels - bench.py's phase 2 on the port: System(cfg, fast=True,
             pipeline=True, chunk=16, enable_surfels=True) with bench.py's
             cfg on the 640x480 "walk", uint16 frames as bench.py makes
             them: 1 + 2 x 16 warm-up frames with a keyframe forced at
             frame 17, a flush and warmup(), then 3 timed windows of 96
             frames.  Prints ms per frame by window, the keyframes and
             surfel inserts in the timed windows, host ms per surfel
             insert and one insert's launches, syncs and copies (the
             profiler, into a fresh mapper over the same map), what the
             inserted keyframes' plane masks left to the superpixels
             (pixels, valid superpixels), live and fused surfels, and the
             exported vertices split into surfels and the map planes'
             flattened clouds, with their share inside the room.  On the
             walk the plane masks claim every pixel, so no surfel is made
             and the exported vertices are the map planes' alone.
             Holds >= 90% of the frames tracked, >= 1 surfel insert in the
             timed windows, > 90% of the vertices inside the padded room
             (tests/test_surfels.py; depth reaches the mapper in metres),
             live surfels exactly when some insert had a valid
             superpixel, every keyframe inserted with its own depth
             array, each kernel once per frame run; then the last
             keyframe's superpixels twice on the card (equal), against
             the CPU, and fusion and new surfels on the card against the
             CPU given the same superpixels and state (the SP_* and
             SURFEL_STATE_TOL tolerances).  Last, "surfels_corner": the
             same System, warm-up and forced keyframe over phase 1's 33
             corner frames, where the plane mask leaves most pixels: its
             two inserts must leave live surfels, some fused into, > 90%
             inside the room, and as many live and fused surfels as a
             CPU mapper given the same inserts (within 1%).
3b. modular - System(cfg) with the reference's defaults (the modular
             tracker, planes, lines and surfels) over 30 near_corner frames
             at 640x480: all tracked, ATE below 0.05 m, the Manhattan
             frame on >= 3 frames, vertices exported, live surfels
             exactly when some insert had a valid superpixel (near_corner's
             three planes claim every pixel: none), each kernel once per
             frame.  Prints ms per frame, the last frame's launches, syncs
             and copies (the profiler), and the surfel yield as 3a.

4. track   - the points-only System over 30 synthetic 640x480 frames at the
             TUM1 camera (the orbit view), with every kernel's launch
             count set to 0 first: all frames tracked, ATE against the
             renderer's ground truth below 0.05 m, FAST, IC angle and BRIEF
             each launched once per frame.
5. planes  - System(TUM1, enable_planes=True) over 30 frames of two
             640x480 views of the box room, the launch counts set to 0
             before each: every frame tracked, ATE below 0.05 m, each
             kernel launched once per frame.  First the "corner" view (a
             floor and two perpendicular walls at 3-7 m; BASELINE config
             2's analog): at least one plane on every frame.  At that
             depth the device merge (the reference's as well) joins floor
             and walls into one plane, so no Manhattan frame exists there.
             Then the "near_corner" view (the same floor corner from 1.8 m,
             the camera 0.54 m above the floor: planes at 0.9-2.2 m), which
             holds the reference's own Manhattan bar
             (tests/test_planes_e2e.py): three planes on every frame, the
             Manhattan frame found on >= 3 frames and used on >= 1, >= 2
             map planes and >= 1 Manhattan pair.  Prints ms per frame, the
             launches per frame, the planes per frame, the frames on which
             a Manhattan frame was found and used, and the map's planes,
             pairs and triples.
6. full    - System(TUM1, enable_planes=True, enable_lines=True), the
             reference's full body (BASELINE config 3's analog: points,
             planes, Manhattan frames and lines), over 30 frames of the
             640x480 near_corner view, the launch counts set to 0 first:
             every frame tracked, ATE below 0.05 m, each kernel launched
             once per frame; the reference's line bar
             (tests/test_lines_e2e.py): >= 3 map lines, each longer than
             0.05 m, and >= 1 frame line associated on the last frame; and
             the Manhattan bar of the planes phase.  Prints ms per frame,
             the launches per frame, the lines per frame (valid and lifted
             to 3D), the associated lines per frame, the map lines and the
             Manhattan counts.
7. replay  - the batched multi-sequence replay (BASELINE config 5) through
             parallel/mesh.py, which runs the full body: B = 8 streams
             of the 640x480 near_corner view, stream s at frame offset s,
             against the one shared map view of keyframe 0 (with its map
             planes, Manhattan registries and map lines), for 12 steps (the
             first not timed), with the launch counts set to 0 first: every
             stream tracked and its Manhattan frame found on every step,
             FAST, IC angle and BRIEF each launched once per step, each
             stream's pose within 1e-3 m / 1e-3 rad of the single-stream
             step run on the same frame and carry, and the poses' RMS error
             against ground truth below 0.05 m.  Prints ms per step,
             aggregate frames/s at B = 8 and B = 1 (the same entry point),
             the peak memory, each stream's manhattan_found and
             use_manhattan and its associated lines per step.
8. mapping - System(TUM1, enable_planes=True, enable_lines=True) over 120
             frames of the 640x480 "walk" view (a sweep along the room's
             walls at 2 cm a frame, about one keyframe per 20-30 frames:
             bench.py's mapping regime, surfels off, one frame per step),
             the launch
             counts set to 0 first: ATE below 0.05 m, no reset, every lost
             frame recovered within 5 frames, >= 3 keyframes, >= 1 point
             triangulated by the LocalMapper, every keyframe's map point
             valid and the covisibility symmetric
             (tests/test_local_mapping.py), each kernel launched once per
             frame.  Prints frames tracked and relocalized, keyframes made
             and culled, slots reused, points made from depth,
             triangulated, fused, merged and erased, map planes and lines
             with those culled, the back end's ms per stage and event,
             median and largest ms per frame and launches per frame.
9. reloc   - frames 120..199 of a 200-frame walk (tracked; a walk's
             poses scale with its length, and these go on from the
             120-frame walk's last pose with a 0.4 degree step), then the
             forced-loss
             traffic of tests/test_reloc.py:71-113, the launch counts set
             to 0 first: the map padded with 5 clones of keyframe 0, each
             indexed by the relocalizer (the 5 that traffic adds to its
             one-keyframe map), one lost frame, then frames 5, 4, ..., 0, which
             the camera left ~127 degrees of turn ago (after the mapping
             phase's 120 frames, ~78 degrees, the tracker still found
             frame 5 itself on the card): one of them relocalized, every
             later one tracked under the post-relocalization gate; then
             frames 1..5 in localization mode, under that gate: tracked,
             no keyframe added.  Each kernel launched once per frame.
             Prints each relocalize call's ms and its path (3D-3D or EPnP)
             and the keyframe matched.  Without the clones the word
             index's covisibility-accumulated score ranks the walk's late,
             mutually covisible keyframes above the start (keyframe 0
             keeps ~130 of its 1000 points after point culling), and no
             frame of 5..0 was relocalized in 2 of 3 runs on the card.  Two
             changes to that
             traffic: on the "wall" orbit the tracker itself finds frame 5
             again, so no relocalization would run; and the lost frame is
             black with no depth (a covered lens), because with planes and
             lines on, the test's noise frame passed the success gate with
             16 point inliers on the mapped walk at 192x144.  Last, a
             keyframe slot retired (by the back end, or a clone retired
             here) is reused by a forced keyframe: the view written in
             place equals a full upload of the map, and the graphed step
             tracks the next frame against it.

10. persist - 90 frames of the 640x480 "walk" written as a TUM-format
             sequence (io/png.py: RGB from the gray frame, 16-bit depth at
             DepthMapFactor, an associations file) and read back with
             TumSequence: RGB equal, depth within one quantum.  The runner,
             run_slam.main, over it with the reference's defaults (fused,
             chunk 1, planes, lines, surfels): 90/90 tracked, ATE below
             0.05 m against the renderer, 8 fields on every trajectory
             line, each kernel once per frame; median and largest ms per
             frame.  System(cfg, fast=True, use_viewer=True) over the same
             frames, saved; a fresh System loads it (every table and
             scalar equal), then in localization mode with its state
             forced to LOST relocalizes one of 3 frames from the frame of
             its best-covisible keyframe on, and tracks the next 10 from
             the graphed step (ATE below 0.05 m; the largest distance to
             the first System's poses printed).  The exact
             AHC merge at 640x480 on a corner and a near_corner frame: on
             the card; the C++ and Python merges on the same pulled stats
             (the same partition, both timed); the card's planes against
             the CPU's (equal counts, AHC_NORMAL_TOL / AHC_D_TOL); the
             device method's and AHC's plane counts.  The mesh entries:
             make_mesh() is the one card; build_batched_track_step at B = 8
             (a bank of frame 0's back-projected keypoints, each stream
             seeded at the ground-truth pose of the frame before) against
             B = 1 per stream within 1e-3 m / 1e-3 rad with equal inliers
             above the tracker's acceptance, each kernel once per step (ms
             per step, frames/s, peak memory); sharded_hamming_argmin on a
             4096-entry bank and 1000 queries over meshes of one and four
             entries of the card, equal to the single-bank argmin.

Any failure raises and the script exits nonzero.  It writes only into a
temporary directory and the kernel build directory, and starts no thread.
The last two lines are the kernels JSON (one row per TPU kernel and one for
the pose solve) and
{"ok": true, "device": ...}.
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
from torch.profiler import ProfilerActivity, profile

from manhattanslam_tpu_torch import tracing
from manhattanslam_tpu_torch.config import CameraConfig, SlamConfig, load_config
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu_torch.frontend import device_tracker as dt
from manhattanslam_tpu_torch.frontend import frame
from manhattanslam_tpu_torch.frontend.fast_tracking import SECTIONS
from manhattanslam_tpu_torch.frontend.graphed_step import GraphedStep, clone_tree
from manhattanslam_tpu_torch.io import trajectory as traj_io
from manhattanslam_tpu_torch.mapping.surfel_mapping import SurfelMapper, plane_mask
from manhattanslam_tpu_torch.ops import fast as fast_ops
from manhattanslam_tpu_torch.ops import image as image_ops
from manhattanslam_tpu_torch.ops import kernel_build, matching
from manhattanslam_tpu_torch.ops import lm as lm_ops
from manhattanslam_tpu_torch.ops import orb as orb_ops
from manhattanslam_tpu_torch.ops import surfels as surf_ops
from manhattanslam_tpu_torch.parallel import mesh, replay
from manhattanslam_tpu_torch.system import System

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 30
ATE_LIMIT = 0.05
N_MAP = 120  # walk frames of the mapping phase
N_WALK = 200  # the reloc phase walks on to frame N_WALK - 1 of this long a walk
RELOC_WITHIN = 5  # frames a lost frame may take to be recovered
ANGLE_TOL = 1e-4
BATCH = 8  # replay streams (BASELINE config 5)
REPLAY_STEPS = 12  # the first is not timed; frames up to REPLAY_STEPS + BATCH - 2 < N_FRAMES
POSE_TOL_M = 1e-3  # replay stream vs the single-stream step, per step
POSE_TOL_RAD = 1e-3
BENCH_CHUNK = 16  # bench.py phase 1: System(cfg, fast=True, pipeline=True, chunk=16, ...)
CHUNK_WARM = 1 + 2 * BENCH_CHUNK  # bench.py's warm-up frames, a keyframe forced at 1 + chunk
CHUNK_WINDOWS = 5  # timed windows (bench.py: median of 5)
CHUNK_WINDOW = 2 * BENCH_CHUNK  # frames per timed window
TRACKED_SHARE = 0.9  # bench.py's own bar on the timed frames
SURFEL_WINDOWS = 3  # bench.py phase 2: 3 timed windows of 6 chunks on the walk
SURFEL_WINDOW = 6 * BENCH_CHUNK
INSIDE_SHARE = 0.9  # tests/test_surfels.py: surfels inside the padded room
# superpixels of one 640x480 keyframe, card against CPU: labels equal on
# SP_LABEL_SHARE of the pixels and the valid flags on SP_VALID_SHARE of the
# superpixels with the same members.  Their planes are held against a
# float64 run on the CPU: each float32 covariance is E[xx^T] - mean mean^T
# (the reference's), which cancels at a few metres, so a normal's float32
# error depends on the summation order (the card's and the CPU's were
# 0.0635 and 0.0308 rad off float64 at worst on the walk's last keyframe,
# means 4.3e-7 and 4.8e-7 m).  The card's 99th percentile of error must
# be within SP_ERR_RATIO of the CPU's (floors SP_ANGLE_FLOOR rad and
# SP_MEAN_FLOOR m), its worst within SP_MAX_ANGLE rad and SP_MAX_MEAN m.
# SP_MAX_ANGLE is 1.5 times the card's worst normal on the walk's last
# keyframe in the two runs that read it (both 0.0635 rad); the CPU
# float32's worst in the same runs was 0.0308 rad, so a bound on the CPU's
# worst would not hold for another order of summation.
# Fusion given the same superpixels and state: integer and flag fields
# equal, floats within SURFEL_STATE_TOL.
SP_LABEL_SHARE = 0.995
SP_VALID_SHARE = 0.99
SP_ERR_RATIO = 2.0
SP_ANGLE_FLOOR = 1e-3
SP_MEAN_FLOOR = 1e-4
SP_WORST_SEEN = 0.0635  # rad
SP_MAX_ANGLE = 1.5 * SP_WORST_SEEN
SP_MAX_MEAN = 0.01
SURFEL_STATE_TOL = 1e-5
N_MODULAR = 30  # near_corner frames through System(cfg), the reference's defaults
MANHATTAN_FRAMES = 3  # tests/test_planes_e2e.py: the Manhattan frame on >= 3 frames
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# float ops per interior pixel of the FAST score as csrc/fast.cu does it:
# per polarity 42 min (max) for the 16 arcs and 15 to reduce the
# rotations; 2 subtractions of the centre; 2 final maxes
FAST_OPS_PER_PIXEL = 2 * (42 + 15) + 2 + 2
# per disc pixel: 2 multiplies + 2 adds (m01, m10)
IC_OPS_PER_PIXEL = 4
# per pattern point: 4 multiplies, 2 add/sub, 2 adds, 2 roundings,
# 4 clamps; per pair 2 points + 1 compare
BRIEF_OPS_PER_PAIR = 2 * 14 + 1
# per blurred pixel: 7 multiplies and 6 adds in each of the two passes
BLUR_OPS_PER_PIXEL = 2 * (7 + 6)
# float ops of csrc/lm_solve.cu per row and pass, counted from its source
# and rounded up: (a system pass at 6 dof, at 3 dof, a cost-only pass, a
# chi2 pass) for a point row (3 residuals), a line endpoint and a plane
# observation (with its normal's tangents at 6 dof)
SOLVE_OPS = {"pt": (290, 135, 60, 45), "ln": (116, 70, 35, 30), "pl": (600, 200, 160, 150)}
SOLVE_TOL = 1e-5  # m and rad: the kernel against the plain solve (tests/test_torch_cuda.py)

# One row per TPU kernel (each function that reaches pl.pallas_call), and
# one for the pose solve, which replaces none.  A single kernel and its
# batched twin are served by one CUDA kernel, one launch for all pyramid
# levels and streams; the single rows count launches on the chunk phase's
# path, bench.py's phase 1 (and list every other System phase beside it),
# the batched rows on the replay's.
_FAST = "manhattanslam_tpu_torch/csrc/fast.cu"
_IC = "manhattanslam_tpu_torch/csrc/ic_angle.cu"
_BRIEF = "manhattanslam_tpu_torch/csrc/brief.cu"
KERNELS = {
    "fast_score": dict(
        source=_FAST, path="chunk", wrapper=fast_ops.fast_score_levels,
        replaces="manhattanslam_tpu/ops/fast_pallas.py:33 (_fast_kernel, pallas_call :79)",
    ),
    "ic_angle": dict(
        source=_IC, path="chunk", wrapper=orb_ops.ic_angle_levels,
        replaces="manhattanslam_tpu/ops/orb_pallas.py:235 (_make_moments_kernel, pallas_call :285)",
    ),
    "brief": dict(
        source=_BRIEF, path="chunk", wrapper=orb_ops.brief_levels,
        replaces="manhattanslam_tpu/ops/orb_pallas.py:66 (_make_brief_kernel, pallas_call :117)",
    ),
    "fast_score_batched": dict(
        source=_FAST, path="replay", wrapper=fast_ops.fast_score_levels,
        replaces="manhattanslam_tpu/ops/fast_pallas.py:92 (_fast_kernel_batched, pallas_call :127)",
    ),
    "ic_angle_batched": dict(
        source=_IC, path="replay", wrapper=orb_ops.ic_angle_levels,
        replaces="manhattanslam_tpu/ops/orb_pallas.py:299 "
        "(_make_moments_kernel_batched, pallas_call :341)",
    ),
    "brief_batched": dict(
        source=_BRIEF, path="replay", wrapper=orb_ops.brief_levels,
        replaces="manhattanslam_tpu/ops/orb_pallas.py:133 "
        "(_make_brief_kernel_batched, pallas_call :176)",
    ),
    "lm_solve": dict(
        source="manhattanslam_tpu_torch/csrc/lm_solve.cu", path="chunk",
        wrapper=lm_ops.solve_pose_cuda,
        replaces="none: XLA's fusion of solve_pose (manhattanslam_tpu/ops/lm.py); added for "
        "the ~15.7k launches a frame of its plain version",
    ),
}
# the extractor's kernels: once per frame (or batched step) on every path
WRAPPERS = (fast_ops.fast_score_levels, orb_ops.ic_angle_levels, orb_ops.brief_levels)
# the full body's pose solves a frame, one launch each: candidates, Manhattan, final
SOLVES_PER_FRAME = 3


def reset_launches() -> None:
    for fn in WRAPPERS + (lm_ops.solve_pose_cuda,):
        fn.launches = 0


def read_launches() -> dict:
    """Launches of every hand kernel; the pose solve's count per frame
    depends on the tracker and its branches, so only the chunk phase
    checks it."""
    return {fn.__name__: fn.launches for fn in WRAPPERS + (lm_ops.solve_pose_cuda,)}


def launches_per_frame() -> dict:
    """Wrapper launches of one frame's (or one batched step's) extraction:
    each kernel once for all levels."""
    return {fn.__name__: 1 for fn in WRAPPERS}


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


def graph_ms(launch, reps: int = 20, trials: int = 5) -> float:
    """Device time of one launch(stream) call: `reps` launches captured
    once in a CUDA graph on a side stream, the graph replayed between two
    CUDA events, divided by reps; the median of `trials` replays after one
    warm-up replay.  Unlike median_ms it does not time the host's issue
    rate (ctypes calls from Python)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            launch(side.cuda_stream)
    graph.replay()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
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
    log(f"phase build: {len(kernel_build.SIGNATURES)} kernels and "
        f"{len(kernel_build.HOST_SIGNATURES)} host C++ library built, "
        f"{time.perf_counter() - t0:.1f} s")
    return smi


def _measure_levels(cfg, dev, imgs: torch.Tensor, stats: dict, names: tuple) -> None:
    """Every kernel over the pyramid of the (B, H, W) stack `imgs`, as the
    extractor launches it (each once for all levels and all B images),
    against its plain version, against one launch per level and, for
    B > 1, against B single-image launches.  Adds
    the times, error and bound terms to stats[name] for the (fast,
    ic_angle, brief) names."""
    b = imgs.shape[0]
    ops = image_ops.pyramid_operators(
        cfg.camera.height, cfg.camera.width, cfg.orb.n_levels, cfg.orb.scale_factor, dev
    )
    pyramid = image_ops.build_pyramid(imgs, ops)
    active = frame.active_levels(cfg)
    levels = [pyramid[li] for li in active]
    budgets = [cfg.orb.features_per_level()[li] for li in active]
    stream = torch.cuda.current_stream(dev).cuda_stream
    fns = kernel_build.build()
    pattern = orb_ops.device_constant("PATTERN", dev)
    circ = orb_ops.device_constant("CIRC_MASK", dev)
    st_fast, st_ic, st_brief = (stats[k] for k in names)

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise RuntimeError(f"{what} (B = {b})")

    # FAST: one launch for all levels, bit-identical with the plain version
    # per level, with one launch per level and with B single-image launches
    scores = fast_ops.fast_score_levels(levels)
    plain = fast_ops.fast_score_levels_plain(levels)
    for li, lv, sc, pl in zip(active, levels, scores, plain):
        check(torch.equal(sc, pl), f"{names[0]} level {li}: kernel != plain version")
        check(torch.equal(sc, fast_ops.fast_score_map(lv)),
              f"{names[0]} level {li}: all-level launch != per-level launch")
    for i in range(b if b > 1 else 0):
        for li, sc, single in zip(active, scores, fast_ops.fast_score_levels([lv[i] for lv in levels])):
            check(torch.equal(sc[i], single), f"{names[0]} level {li}: image {i} != single launch")
    outs = kernel_build.level_views(
        torch.empty(sum(lv.numel() for lv in levels), device=dev), [lv.shape for lv in levels])
    fast_args = fast_ops.kernel_args(levels, outs)

    def fast_launch(s):
        fns["fast"](*fast_args, s)

    st_fast["ms"] += median_ms(lambda: fast_launch(stream))
    st_fast["device_ms"] += graph_ms(fast_launch)
    st_fast["plain_ms"] += median_ms(lambda: fast_ops.fast_score_levels_plain(levels))
    for lv in levels:
        h, w = lv.shape[-2:]
        st_fast["bytes"] += 2 * b * h * w * 4
        st_fast["ops"] += FAST_OPS_PER_PIXEL * b * (h - 6) * (w - 6)

    # each level's keypoints, as the extractor picks them, level-major
    kps = [frame.keypoints_from_score(sc, n, cfg) for sc, n in zip(scores, budgets)]
    xy_flat = torch.cat([xy.reshape(-1, 2) for xy, _, _ in kps])
    valid_flat = torch.cat([valid.reshape(-1) for _, _, valid in kps])

    # IC angle: one launch for all levels, within ANGLE_TOL of the plain
    # version at the valid keypoints (wrapped), and bitwise equal to one
    # launch per level and to B single-image launches
    ang = orb_ops.ic_angle_levels(levels, xy_flat, budgets)
    dang = orb_ops.ic_angle_levels_plain(levels, xy_flat, budgets) - ang
    dang = torch.remainder(dang + math.pi, 2 * math.pi) - math.pi
    err = float(dang[valid_flat].abs().max()) if bool(valid_flat.any()) else 0.0
    check(err <= ANGLE_TOL, f"{names[1]}: max error {err} rad > {ANGLE_TOL}")
    st_ic["max_abs_err"] = max(st_ic["max_abs_err"], err)
    angles = orb_ops.level_keypoint_views(ang, budgets, (b,))
    for li, lv, (xy, _, _), a in zip(active, levels, kps, angles):
        check(torch.equal(a, orb_ops.ic_angle(lv, xy)),
              f"{names[1]} level {li}: all-level launch != per-level launch")
    for i in range(b if b > 1 else 0):
        single = orb_ops.ic_angle_levels(
            [lv[i] for lv in levels], torch.cat([xy[i] for xy, _, _ in kps]), budgets)
        check(torch.equal(torch.cat([a[i] for a in angles]), single),
              f"{names[1]}: image {i} != single-image launch")
    ang_out = torch.empty_like(ang)
    ic_args = orb_ops.kernel_args(levels, budgets)

    def ic_launch(s):
        fns["ic_angle"](*ic_args, xy_flat.data_ptr(), ang_out.data_ptr(), s)

    st_ic["ms"] += median_ms(lambda: ic_launch(stream))
    st_ic["device_ms"] += graph_ms(ic_launch)
    st_ic["plain_ms"] += median_ms(lambda: orb_ops.ic_angle_levels_plain(levels, xy_flat, budgets))
    st_ic["bytes"] += 4 * len(orb_ops.IC_ROW_EXTENT) + 8 * xy_flat.shape[0] + 4 * ang.numel()
    st_ic["ops"] += IC_OPS_PER_PIXEL * float(circ.sum()) * ang.numel()

    for lv, (xy, _, _) in zip(levels, kps):
        h, w = lv.shape[-2:]
        n = xy.shape[-2]
        # offsets that keep the B images' pixel indices apart when counting
        # the distinct pixels a launch reads
        img_off = (torch.arange(b, device=dev) * h * w)[:, None, None]
        disc_px = orb_ops.ic_patch_index(xy, h, w).reshape(b, n, -1)[..., circ.reshape(-1)]
        st_ic["bytes"] += 4 * int(torch.unique(disc_px + img_off).numel())

    # BRIEF: one launch for all levels, the blur inside, bit-exact with the
    # plain version (blur, round, samples) from the kernel's angles, and
    # bitwise equal to one launch per level, to B single-image launches and
    # in both thread layouts (a warp or a block per keypoint); `ms` and
    # `device_ms` time the kernel alone, without the wrapper's cos/sin
    words = orb_ops.brief_levels(levels, xy_flat, ang, budgets)
    bad = int((words != orb_ops.brief_levels_plain(levels, xy_flat, ang, budgets)).any(-1).sum())
    check(bad == 0, f"{names[2]}: {bad} keypoints differ from the plain version")
    views = orb_ops.level_keypoint_views(words, budgets, (b,))
    for li, lv, (xy, _, _), a, v in zip(active, levels, kps, angles, views):
        check(torch.equal(v, orb_ops.brief_level(lv, xy, a)),
              f"{names[2]} level {li}: all-level launch != per-level launch")
    for i in range(b if b > 1 else 0):
        single = orb_ops.brief_levels([lv[i] for lv in levels],
                                      torch.cat([xy[i] for xy, _, _ in kps]),
                                      torch.cat([a[i] for a in angles]), budgets)
        check(torch.equal(torch.cat([v[i] for v in views]), single),
              f"{names[2]}: image {i} != single-image launch")
    ca, sa = torch.cos(ang), torch.sin(ang)
    words_out = torch.empty_like(words)
    layouts = {t: orb_ops.brief_kernel_args(levels, budgets, threads=t) for t in (32, 128)}

    def brief_launcher(threads):
        def launch(s):
            err = fns["brief"](*layouts[threads], xy_flat.data_ptr(), ca.data_ptr(),
                               sa.data_ptr(), pattern.data_ptr(), words_out.data_ptr(), s)
            kernel_build.check_launch("brief", err)
        return launch

    for threads in layouts:
        brief_launcher(threads)(stream)
        check(torch.equal(words_out, words), f"{names[2]}: layout of {threads} threads differs")
    brief_launch = brief_launcher(orb_ops.brief_threads(b))
    st_brief["ms"] += median_ms(lambda: brief_launch(stream))
    st_brief["device_ms"] += graph_ms(brief_launch)
    st_brief["plain_ms"] += median_ms(
        lambda: orb_ops.brief_levels_plain(levels, xy_flat, ang, budgets))
    layout_ms = {t: graph_ms(brief_launcher(t)) for t in layouts}

    def blur_launch(s):
        for lv in levels:
            torch.round(image_ops.gaussian_blur(lv, orb_ops.BLUR_KSIZE, orb_ops.BLUR_SIGMA))

    log(f"kernels {names[2]}: device ms by threads per keypoint {layout_ms}; the eager "
        f"integer-rounded blur of all {len(levels)} levels that the kernel replaces, in one "
        f"graph: device {graph_ms(blur_launch)} ms")
    # the bound: each level pixel within the blur's radius of a sample read
    # once, keypoints and angles in, words out; the pairs' float ops and
    # 26 per distinct blurred pixel sampled
    sampled = blurred_px = 0
    for lv, (xy, _, _), a in zip(levels, kps, angles):
        h, w = lv.shape[-2:]
        mask = torch.zeros(b * h * w, device=dev)
        img_off = (torch.arange(b, device=dev) * h * w)[:, None, None]
        idx = orb_ops.brief_sample_index(xy, torch.cos(a), torch.sin(a), h, w)
        mask[(idx.reshape(b, xy.shape[-2], -1) + img_off).reshape(-1)] = 1.0
        sampled += int(mask.sum())
        r = orb_ops.BLUR_KSIZE // 2
        near = torch.nn.functional.max_pool2d(mask.view(b, 1, h, w), 2 * r + 1, 1, r)
        blurred_px += int(near.sum())
    n_kp = xy_flat.shape[0]
    st_brief["bytes"] += 4 * blurred_px + 12 * n_kp + 4 * pattern.numel() + 32 * n_kp
    st_brief["ops"] += BRIEF_OPS_PER_PAIR * 256 * n_kp + BLUR_OPS_PER_PIXEL * sampled


def _compare_extraction(cfg, dev, gray: torch.Tensor, depth: torch.Tensor) -> None:
    """Report (not gate) how far one batched extraction of B frames is from
    B single-frame extractions on the card: the pyramid products change
    shape with B, and a one-ulp change can move a keypoint."""
    ops = image_ops.pyramid_operators(
        cfg.camera.height, cfg.camera.width, cfg.orb.n_levels, cfg.orb.scale_factor, dev
    )
    lv_b = image_ops.build_pyramid(gray, ops)
    extract = frame.build_extractor(cfg, dev)
    fb = extract(gray, depth)
    pyr_diff, moved, desc_diff, n_kp = 0.0, 0, 0, 0
    differ = set()
    for i in range(gray.shape[0]):
        lv_s = image_ops.build_pyramid(gray[i], ops)
        pyr_diff = max(pyr_diff, max(float((a[i] - c).abs().max()) for a, c in zip(lv_b, lv_s)))
        fs = extract(gray[i], depth[i])
        kp = (fb["xy"][i] != fs["xy"]).any(-1) | (fb["valid"][i] != fs["valid"])
        moved += int(kp.sum())
        desc_diff += int(((fb["desc"][i] != fs["desc"]).any(-1) & ~kp).sum())
        n_kp += int(fs["valid"].sum())
        differ |= {k for k, v in fs.items() if not torch.equal(fb[k][i], v)}
    log(f"kernels: batched vs single extraction of {gray.shape[0]} frames on the card: "
        f"pyramid max |diff| {pyr_diff}; of {n_kp} keypoints {moved} moved and {desc_diff} "
        f"others changed descriptor; features that differ anywhere: {sorted(differ)}")


def solve_work(a: dict) -> tuple[float, float]:
    """(bytes, float ops) of one csrc/lm_solve.cu launch on solve_pose's
    arguments `a`: each input and output byte once; every pass over the
    rows that the schedule runs (plane observations: those the masks
    keep)."""
    tensors, dims = lm_ops.kernel_inputs(a["prob"], a["T0"], a["K"], a["use_planes"],
                                         a["use_lines"])
    b, n_pt, n_ln = dims[0], dims[1], dims[2]
    n_bytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    n_bytes += b * (64 + 8 + 4 + n_pt + n_ln + sum(dims[3:]))  # T, n_inliers, chi2, masks
    rows = {"pt": b * n_pt, "ln": b * n_ln}
    if a["use_planes"]:
        p = a["prob"]
        rows["pl"] = int(p.pl_mask.sum() + p.par_mask.sum() + p.ver_mask.sum())
    r, i = a["n_rounds"], a["n_iters"]
    n_ops = 0.0
    for fam, n in rows.items():
        sys6, sys3, cost, chi = SOLVE_OPS[fam]
        per_pass = sys3 if a["translation_only"] else sys6
        n_ops += n * (r * i * per_pass + (0 if a["gauss_newton"] else r) * cost + r * chi)
    return n_bytes, n_ops


def _measure_solve(cfg, dev, st: dict) -> None:
    """The pose solve's kernel on the three solves (candidates, Manhattan,
    final) of one full-body step of 640x480 near_corner frames at B = 1,
    the chunk path's launches: each within SOLVE_TOL of the plain version,
    two launches bit for bit equal; `ms`, `device_ms`, the plain version's
    ms and the bound terms summed over the three into st.  Logs the same
    at B = BATCH, per step."""
    seq = SyntheticSequence(n_frames=BATCH + 2, cam=cfg.camera, view="near_corner")
    frames = [seq.frame(i) for i in range(BATCH + 2)]
    view, _ = replay.shared_view(cfg, frames[0], dev)
    native = [dt.to_native(g, d) for _, g, d in frames]
    for b in (1, BATCH):
        calls = replay.step_solves(cfg, seq, native, view, list(range(1, b + 1)), dev)
        sums = dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0)
        by_solve = []
        for a in calls:
            out, again = lm_ops.solve_pose(**a), lm_ops.solve_pose(**a)
            ref = lm_ops.solve_pose_plain(**a)
            if not all(torch.equal(out[k], again[k]) for k in out):
                raise RuntimeError(f"lm_solve (B = {b}): two launches differ")
            gap = max(max(_pose_diff(x, y)) for x, y in zip(ref["T"].cpu().numpy(),
                                                              out["T"].cpu().numpy()))
            if not gap < SOLVE_TOL:
                raise RuntimeError(f"lm_solve (B = {b}): {gap} off the plain solve")
            one = dict(max_abs_err=gap, ms=median_ms(lambda: lm_ops.solve_pose(**a)),
                       device_ms=graph_ms(lambda _s: lm_ops.solve_pose(**a)),
                       plain_ms=median_ms(lambda: lm_ops.solve_pose_plain(**a), reps=3, trials=3))
            one["bytes"], one["ops"] = solve_work(a)
            by_solve.append(round(one["device_ms"], 4))
            for k, v in one.items():
                sums[k] = max(sums[k], v) if k == "max_abs_err" else sums[k] + v
        log(f"kernels lm_solve at B = {b}: device ms by solve (candidates, Manhattan, final) "
            f"{by_solve}, per {'frame' if b == 1 else 'step'} {sums['device_ms']:.4f} "
            f"(from Python {sums['ms']:.4f}, plain {sums['plain_ms']:.4f}); {sums['bytes']:.0f} "
            f"bytes, {sums['ops']:.0f} float ops; largest gap to the plain solve "
            f"{sums['max_abs_err']:.3g}")
        if b == 1:
            for k, v in sums.items():
                st[k] = v


def phase_kernels(cfg, dev, frames) -> dict:
    """Each kernel against its plain version at the main path's shapes:
    frame 0 alone (the track phase's launches) and BATCH frames in one
    launch (the replay's)."""
    t0 = time.perf_counter()
    native = [dt.to_native(g, d) for _, g, d in frames[:BATCH]]
    gray = torch.from_numpy(np.stack([g for g, _ in native])).to(dev).to(torch.float32)
    depth = torch.from_numpy(np.stack([d.astype(np.int32) for _, d in native])).to(dev)
    depth = depth.to(torch.float32) * float(np.float32(1.0 / dt.DEPTH_QUANT))
    stats = {k: dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0, ops=0.0)
             for k in KERNELS}
    _measure_levels(cfg, dev, gray[:1].contiguous(), stats, ("fast_score", "ic_angle", "brief"))
    _measure_levels(cfg, dev, gray, stats,
                    ("fast_score_batched", "ic_angle_batched", "brief_batched"))
    _measure_solve(cfg, dev, stats["lm_solve"])
    per_frame = {**launches_per_frame(), lm_ops.solve_pose_cuda.__name__: SOLVES_PER_FRAME}
    for name, st in stats.items():
        st["bound_ms"], st["bound_by"] = bound(st.pop("bytes"), st.pop("ops"))
        log(f"kernels {name}: max_abs_err {st['max_abs_err']:.3g}, "
            f"{st['ms']:.4f} ms per {'step' if 'batched' in name else 'frame'} "
            f"(device {st['device_ms']:.4f} ms) "
            f"({per_frame[KERNELS[name]['wrapper'].__name__]} launches), "
            f"plain {st['plain_ms']:.4f} ms, "
            f"bound {st['bound_ms']:.6f} ms ({st['bound_by']})")
    _compare_extraction(cfg, dev, gray, depth)
    log(f"phase kernels: {len(frame.active_levels(cfg))} levels, single and {BATCH}-frame "
        f"launches, all "
        f"kernels agree with their plain versions, {time.perf_counter() - t0:.1f} s")
    return stats


def _check_launches(name: str, launches: dict, n: int) -> None:
    """Each extractor kernel launched once per frame of the n frames (so at
    least once on the path)."""
    for k, per in launches_per_frame().items():
        c = launches[k]
        if c != n * per:
            raise RuntimeError(f"{name}: kernel {k} launched {c} times in {n} frames, not "
                               f"{per} per frame")


def _run_system(cfg, seq, frames, tmp: str, enable_planes: bool, name: str,
                enable_lines: bool = False) -> dict:
    """System(cfg, enable_planes, enable_lines) over the frames with the
    launch counts set to 0 first: every frame tracked, ATE below ATE_LIMIT
    and each kernel launched once per frame.  Returns the launch counts,
    median ms per frame and, with planes, per-frame plane and Manhattan
    counts, with lines per-frame line counts and the map lines."""
    t0 = time.perf_counter()
    system = System(cfg, fast=True, enable_planes=enable_planes, enable_lines=enable_lines,
                    enable_surfels=False)  # CUDA
    reset_launches()
    ms, tracked, n_planes, found, used = [], 0, [], 0, 0
    n_lines, n_lifted, n_assoc = [], [], []
    for ts, gray, depth in frames:
        t = time.perf_counter()
        T = system.track(gray, depth, ts)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        if T is not None and np.isfinite(T).all():
            tracked += 1
        res = system.tracker.last_result
        if enable_planes and res is not None:
            n_planes.append(int(res["plane_valid"].sum()))
            found += int(res["manhattan_found"])
            used += int(res["use_manhattan"])
        if enable_lines and res is not None:
            n_lines.append(int(res["line_valid"].sum()))
            n_lifted.append(int((res["line_valid"] & res["line_has3d"]).sum()))
            n_assoc.append(int((res["line_assoc"] >= 0).sum()))
    launches = read_launches()
    system.shutdown()
    traj = os.path.join(tmp, f"CameraTrajectory_{name}.txt")
    system.save_trajectory_tum(traj)
    system.save_keyframe_trajectory_tum(os.path.join(tmp, f"KeyFrameTrajectory_{name}.txt"))
    ts_e, pos_e, _ = traj_io.load_trajectory_tum(traj)
    gt = seq.gt_rows()
    ate = traj_io.ate_rmse(
        (ts_e, pos_e), (np.array([r[0] for r in gt]), np.array([r[1] for r in gt]))
    )
    n = len(frames)
    med = statistics.median(ms[1:])
    log(f"{name}: {tracked}/{n} frames tracked, {system.map.n_kf} keyframes, ATE {ate:.4f} m, "
        f"median {med:.1f} ms/frame, largest {max(ms[1:]):.1f} (first frame {ms[0]:.0f} ms), "
        f"launches {launches}")
    log(f"{name}: {backend_report(system)}")
    if tracked != n:
        raise RuntimeError(f"{name}: only {tracked} of {n} frames tracked")
    if not ate < ATE_LIMIT:
        raise RuntimeError(f"{name}: ATE {ate} m is not below {ATE_LIMIT} m")
    _check_launches(name, launches, n)
    out = {"launches": launches, "ms": med, "seconds": time.perf_counter() - t0}
    if enable_planes:
        out.update(planes_per_frame=n_planes, found=found, used=used,
                   map_planes=int(system.map.pl_valid.sum()),
                   pairs=len(system.map.manhattan_pairs),
                   triples=len(system.map.manhattan_triples))
    if enable_lines:
        m = system.map
        out.update(lines_per_frame=n_lines, lifted_per_frame=n_lifted, assoc_per_frame=n_assoc,
                   map_lines=int(m.ml_valid.sum()),
                   map_line_lengths=np.linalg.norm(m.ml_ep - m.ml_sp, axis=1)[m.ml_valid])
    return out


# the System's host spans of a keyframe's hooks
KF_HOOKS = ("keyframe.local_mapper", "keyframe.reloc_add", "keyframe.surfel_insert")


def host_sections(system, since: dict | None = None) -> dict:
    """The tracker's host sections (FastTracker.perf) since the snapshot
    `since` (all when None): {section: [ms, events]}."""
    snap = system.trace.snapshot()
    if since is not None:
        snap = tracing.diff(since, snap)
    return {k: [round(s * 1e3, 1), n] for k, (s, n) in sorted(tracing.by_leaf(snap, SECTIONS).items())}


def span_seconds(system, name: str) -> float:
    """Host seconds of the System's spans named `name`, wherever they nest."""
    return tracing.by_leaf(system.trace.snapshot(), (name,)).get(name, (0.0, 0))[0]


def backend_report(system) -> str:
    """The back end's host ms per keyframe event, in all and by stage, and
    its counts."""
    lm = system.local_mapper
    n = max(lm.counts["events"], 1)
    snap = system.trace.snapshot()
    stages = {}
    for path, (s, _, _) in snap["spans"].items():
        parent, _, stage = path.rpartition("/")
        if parent.rpartition("/")[2] == "keyframe.local_mapper":
            stages[stage] = stages.get(stage, 0.0) + s
    stages = {k: round(v * 1e3 / n, 3) for k, v in stages.items()}
    hooks = tracing.by_leaf(snap, KF_HOOKS)
    total = sum(s for s, _ in hooks.values()) * 1e3 / n
    reloc_add = hooks.get("keyframe.reloc_add", (0.0, 0))[0]
    return (f"back end {total:.2f} ms per keyframe event over {lm.counts['events']} events "
            f"(LocalMapper by stage {stages}, relocalization index "
            f"{reloc_add * 1e3 / n:.3f} ms); "
            f"mapper {dict(lm.counts)}, tracker {dict(system.tracker.counts)}")


def phase_track(cfg, seq, frames, tmp: str) -> tuple[dict, float]:
    """The points-only System over N_FRAMES frames of the orbit view;
    returns the launch counts of that run and its median ms per frame."""
    run = _run_system(cfg, seq, frames, tmp, False, "track")
    log(f"phase track: {run['seconds']:.1f} s")
    return run["launches"], run["ms"]


def _log_planes(name: str, run: dict) -> None:
    log(f"{name}: {run['ms']:.1f} ms/frame, kernel launches per frame "
        f"{ {k: v / N_FRAMES for k, v in run['launches'].items()} }, planes per frame "
        f"{run['planes_per_frame']}, Manhattan found on {run['found']} and used on "
        f"{run['used']} of {N_FRAMES - 1} tracked frames, {run['map_planes']} map planes, "
        f"{run['pairs']} Manhattan pairs, {run['triples']} triples")


def phase_planes(cfg, tmp: str) -> tuple[dict, dict]:
    """System(enable_planes=True) over N_FRAMES frames of the 640x480
    corner view, then of the near_corner view with the reference's
    Manhattan bar; returns each run's launch counts."""
    t0 = time.perf_counter()
    runs = {}
    for view in ("corner", "near_corner"):
        seq = SyntheticSequence(n_frames=N_FRAMES, cam=cfg.camera, view=view)
        frames = [seq.frame(i) for i in range(N_FRAMES)]
        runs[view] = _run_system(cfg, seq, frames, tmp, True, f"planes_{view}")
        _log_planes(f"planes: 640x480 {view}", runs[view])
    corner, near = runs["corner"], runs["near_corner"]
    if min(corner["planes_per_frame"]) < 1 or corner["map_planes"] < 1:
        raise RuntimeError(f"planes: a corner frame without a plane "
                           f"({corner['planes_per_frame']}) or no map plane")
    if not _manhattan_bar(near):
        raise RuntimeError(f"planes: the Manhattan bar at 640x480 (near_corner) failed: "
                           f"{ {k: v for k, v in near.items() if k != 'launches'} }")
    log(f"phase planes: {time.perf_counter() - t0:.1f} s")
    return corner["launches"], near["launches"]


def _manhattan_bar(run: dict) -> bool:
    """The reference's Manhattan bar (tests/test_planes_e2e.py), held on
    the near_corner view at 640x480."""
    return (min(run["planes_per_frame"]) >= 3 and run["found"] >= 3 and run["used"] >= 1
            and run["map_planes"] >= 2 and run["pairs"] >= 1)


def phase_full(cfg, tmp: str) -> dict:
    """System(enable_planes=True, enable_lines=True) over N_FRAMES frames
    of the 640x480 near_corner view with the reference's line bar and the
    Manhattan bar; returns the run's launch counts."""
    t0 = time.perf_counter()
    seq = SyntheticSequence(n_frames=N_FRAMES, cam=cfg.camera, view="near_corner")
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    run = _run_system(cfg, seq, frames, tmp, True, "full", enable_lines=True)
    _log_planes("full: 640x480 near_corner", run)
    lengths = run["map_line_lengths"]
    log(f"full: lines per frame (valid) {run['lines_per_frame']}, lifted to 3D "
        f"{run['lifted_per_frame']}, associated with map lines {run['assoc_per_frame']}; "
        f"{run['map_lines']} map lines, shortest {lengths.min() if len(lengths) else 0:.3f} m")
    if not (run["map_lines"] >= 3 and (lengths > 0.05).all() and run["assoc_per_frame"][-1] >= 1):
        raise RuntimeError(
            f"full: the line bar failed: {run['map_lines']} map lines, lengths {lengths}, "
            f"{run['assoc_per_frame'][-1]} associated on the last frame")
    if not _manhattan_bar(run):
        raise RuntimeError(f"full: the Manhattan bar failed: "
                           f"{ {k: v for k, v in run.items() if k != 'launches'} }")
    log(f"phase full: {time.perf_counter() - t0:.1f} s")
    return run["launches"]


def _rot_angle(R: np.ndarray) -> float:
    """Rotation angle (rad) of a 3x3 rotation matrix, accurate near zero."""
    R = np.asarray(R, np.float64)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(w) / 2, (np.trace(R) - 1) / 2))


def _pose_diff(A: np.ndarray, B: np.ndarray) -> tuple[float, float]:
    d = np.linalg.inv(np.asarray(A, np.float64)) @ np.asarray(B, np.float64)
    return float(np.linalg.norm(d[:3, 3])), _rot_angle(d[:3, :3])


def _replay_run(cfg, dev, seq, native, view, first: list[int]):
    """len(first) streams through build_throughput_step for REPLAY_STEPS
    steps, stream s starting at frame first[s].  Returns (per-step inputs,
    carries going in, outputs, ms per step, launches per step); the host
    clock runs from the upload of a step's frames to the synchronize
    after it."""
    step = mesh.build_throughput_step(cfg, len(first), dev)
    carry = replay.start_carry(cfg, seq, first, dev)
    torch.cuda.synchronize()
    inputs, carries, outs, ms, launches = [], [], [], [], []
    for i in range(REPLAY_STEPS):
        before = read_launches()
        t = time.perf_counter()
        g8, d16 = replay.step_frames(native, first, i, dev)
        carries.append(carry)
        out, carry = step(g8, d16, carry, view)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        after = read_launches()
        launches.append({k: after[k] - before[k] for k in after})
        inputs.append((g8, d16))
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    return inputs, carries, outs, ms, launches


def phase_replay(cfg, dev, track_ms: float) -> dict:
    """The batched replay (the full body) of BATCH streams of the
    near_corner view against one shared view; returns the launch counts of
    its run."""
    t0 = time.perf_counter()
    seq = SyntheticSequence(n_frames=N_FRAMES, cam=cfg.camera, view="near_corner")
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    # the shared view of keyframe 0; stream s replays frames s, s+1, ...
    # from the ground-truth pose of frame s (parallel/replay.py)
    view, tracker = replay.shared_view(cfg, frames[0], dev)
    n_points = int(tracker.map.mp_valid.sum())
    native = [dt.to_native(g, d) for _, g, d in frames]
    gt_cw = replay.start_poses(seq, range(N_FRAMES))
    first = list(range(BATCH))
    per_step = launches_per_frame()

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    inputs, carries, outs, ms, step_launches = _replay_run(cfg, dev, seq, native, view, first)
    launches = read_launches()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    med = statistics.median(ms[1:])
    # B = 1 through the same entry point, stream 0's frames
    _, _, outs_1, ms_1, _ = _replay_run(cfg, dev, seq, native, view, first[:1])
    med_1 = statistics.median(ms_1[1:])

    # every stream tracked on every step; each kernel launched once per step
    for i, out in enumerate(outs):
        if not out["tracked_ok"].all():
            raise RuntimeError(f"replay step {i}: streams {np.nonzero(~out['tracked_ok'])[0]} lost")
        for name, want in per_step.items():
            n = step_launches[i][name]
            if n != want:
                raise RuntimeError(
                    f"replay step {i}: {name} launched {n} times, not {per_step[name]}")
    # each stream against the single-stream step on the same frame and carry
    single = dt.build_frame_step(cfg, dev, enable_planes=True, enable_lines=True)
    max_dt = max_dr = 0.0
    gt_err = []
    for i, ((g8, d16), carry, out) in enumerate(zip(inputs, carries, outs)):
        for s in range(BATCH):
            res, _ = single(g8[s], d16[s], {k: v[s] for k, v in carry.items()}, view)
            dt_, dr_ = _pose_diff(res["T"].cpu().numpy(), out["T"][s])
            max_dt, max_dr = max(max_dt, dt_), max(max_dr, dr_)
            gt_err.append(_pose_diff(gt_cw[first[s] + i], out["T"][s])[0])
    for i, (a, c) in enumerate(zip(outs_1, outs)):
        dt_, dr_ = _pose_diff(a["T"][0], c["T"][0])
        max_dt, max_dr = max(max_dt, dt_), max(max_dr, dr_)
    gt_rms = float(np.sqrt(np.mean(np.square(gt_err))))
    log(f"replay: {BATCH} streams x {REPLAY_STEPS} steps against one view of {n_points} "
        f"points, all tracked; median {med:.2f} ms per step (first step {ms[0]:.0f} ms), "
        f"{BATCH * 1e3 / med:.1f} frames/s aggregate; B = 1 through the same entry: "
        f"{med_1:.2f} ms per step, {1e3 / med_1:.1f} frames/s; single-stream System "
        f"(track phase): {track_ms:.1f} ms per frame; peak memory {peak_mib:.1f} MiB; "
        f"launches per step {step_launches[-1]}")
    log(f"replay: manhattan_found per stream and step "
        f"{[o['manhattan_found'].astype(int).tolist() for o in outs]}, use_manhattan "
        f"{[o['use_manhattan'].astype(int).tolist() for o in outs]}")
    log(f"replay: associated lines per step and stream "
        f"{[(o['line_assoc'] >= 0).sum(-1).tolist() for o in outs]}")
    log(f"replay: against the single-stream step on the same frame and carry: max "
        f"{max_dt:.3g} m, {max_dr:.3g} rad; against ground truth: RMS {gt_rms:.4f} m, "
        f"max {max(gt_err):.4f} m")
    if not (max_dt < POSE_TOL_M and max_dr < POSE_TOL_RAD):
        raise RuntimeError(
            f"replay poses differ from the single-stream step by {max_dt} m / {max_dr} rad")
    if not gt_rms < ATE_LIMIT:
        raise RuntimeError(f"replay pose RMS error {gt_rms} m is not below {ATE_LIMIT} m")
    lost = [(i, np.nonzero(~o["manhattan_found"])[0].tolist()) for i, o in enumerate(outs)
            if not o["manhattan_found"].all()]
    if lost:
        raise RuntimeError(f"replay: no Manhattan frame found at (step, streams) {lost}")
    log(f"phase replay: {time.perf_counter() - t0:.1f} s")
    return launches


def _map_consistent(m) -> bool:
    """tests/test_local_mapping.py's map bar: every keyframe's map point
    valid, the covisibility symmetric."""
    ids = m.kf_mp_idx[: m.n_kf]
    return bool(m.mp_valid[ids[ids >= 0]].all()) and bool((m.covis == m.covis.T).all())


def phase_mapping(cfg, tmp: str):
    """System(enable_planes=True, enable_lines=True) over N_MAP walk
    frames with the mapping bars; returns the launch counts, the system
    and the frames (the reloc phase goes on from them)."""
    t0 = time.perf_counter()
    seq = SyntheticSequence(n_frames=N_MAP, cam=cfg.camera, view="walk")
    frames = [seq.frame(i) for i in range(N_MAP)]
    system = System(cfg, fast=True, enable_planes=True, enable_lines=True,
                    enable_surfels=False)  # CUDA
    reset_launches()
    ms, lost_runs, run = [], [], 0
    for ts, gray, depth in frames:
        t = time.perf_counter()
        T = system.track(gray, depth, ts)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        if T is None:
            run += 1
        elif run:
            lost_runs.append(run)
            run = 0
    launches = read_launches()
    traj = os.path.join(tmp, "CameraTrajectory_mapping.txt")
    system.save_trajectory_tum(traj)
    ts_e, pos_e, _ = traj_io.load_trajectory_tum(traj)
    gt = seq.gt_rows()
    ate = traj_io.ate_rmse(
        (ts_e, pos_e), (np.array([r[0] for r in gt]), np.array([r[1] for r in gt])))
    m, lm, tr = system.map, system.local_mapper, system.tracker
    log(f"mapping: 640x480 walk, {len(ts_e)}/{N_MAP} frames tracked, "
        f"{tr.counts['relocalized']} relocalized, lost runs {lost_runs + ([run] if run else [])}, "
        f"{system.n_resets} resets, ATE {ate:.4f} m; keyframes made {tr.counts['keyframes']} "
        f"(live {int(m.kf_valid.sum())}), culled {lm.counts['kf_culled']}, slots reused "
        f"{tr.counts['slots_reused']}; points made from depth {tr.counts['depth_points']}, "
        f"triangulated {lm.counts['triangulated']}, fused observations "
        f"{lm.counts['fused']}, merged {lm.counts['merged']}, erased {lm.counts['erased']}, "
        f"live {int(m.mp_valid.sum())}; map planes {int(m.pl_valid.sum())} "
        f"({lm.counts['planes_culled']} culled), map lines {int(m.ml_valid.sum())} "
        f"({lm.counts['lines_culled']} culled)")
    log(f"mapping: {backend_report(system)}")
    log(f"mapping: median {statistics.median(ms[1:]):.1f} ms/frame, largest {max(ms[1:]):.1f} "
        f"(first frame {ms[0]:.0f} ms), kernel launches per frame "
        f"{ {k: v / N_MAP for k, v in launches.items()} }")
    if run or any(r > RELOC_WITHIN for r in lost_runs):
        raise RuntimeError(f"mapping: a loss not recovered within {RELOC_WITHIN} frames: "
                           f"{lost_runs}, {run} at the end")
    if not ate < ATE_LIMIT:
        raise RuntimeError(f"mapping: ATE {ate} m is not below {ATE_LIMIT} m")
    if system.n_resets:
        raise RuntimeError(f"mapping: {system.n_resets} resets")
    if tr.counts["keyframes"] < 3 or lm.counts["triangulated"] < 1:
        raise RuntimeError(f"mapping: {tr.counts['keyframes']} keyframes, "
                           f"{lm.counts['triangulated']} points triangulated")
    if not _map_consistent(m):
        raise RuntimeError("mapping: a keyframe refers to an invalid point, or the "
                           "covisibility is not symmetric")
    _check_launches("mapping", launches, N_MAP)
    log(f"phase mapping: {time.perf_counter() - t0:.1f} s")
    return launches, system, frames


def pad_with_clones(system, n: int) -> None:
    """tests/test_reloc.py's padding: n clones of keyframe 0 (its pose,
    features and map points), each indexed by the relocalizer."""
    m = system.map
    kf0 = {"xy_und": m.kf_xy[0], "u_right": m.kf_uright[0], "depth": m.kf_depth[0],
           "level": m.kf_level[0], "angle": m.kf_angle[0], "desc": m.kf_desc[0],
           "valid": m.kf_kp_valid[0]}
    for k in range(n):
        kf = m.add_keyframe(m.kf_pose[0], 0.01 * (k + 1), 0, kf0)
        m.set_kf_matches(kf, m.kf_mp_idx[0])
        system.reloc_module.add_keyframe(kf)


def _reuse_slot(system, frames) -> str:
    """A retired keyframe's slot reused by a new keyframe (a clone is
    retired first if the back end retired none): the view written in
    place must then equal a full upload of the map, and the graphed step
    must track the next frame against it."""
    tr, m = system.tracker, system.map
    if not m.kf_free:
        clone = max(k for k in range(m.n_kf) if m.kf_valid[k] and k != tr.ref_kf)
        m.retire_keyframe(clone)
    slot = m.kf_free[0]
    reused = tr.counts["slots_reused"]
    tr.force_keyframe = True
    if system.track(frames[6][1], frames[6][2], 102.0) is None:
        raise RuntimeError("reloc: the frame made a keyframe in a reused slot was lost")
    if tr.counts["slots_reused"] != reused + 1 or not m.kf_valid[slot] or tr.ref_kf != slot:
        raise RuntimeError(f"reloc: keyframe slot {slot} was not reused")
    host = dt.build_host_view(tr.cfg, m, tr.ref_kf, tr.reg2, tr.reg3)
    full = dt.upload_view(host, tr.device)
    bad = [k for k in full if not torch.equal(tr.view[k], full[k])]
    if bad:
        raise RuntimeError(f"reloc: after the slot reuse the view differs from a full upload: {bad}")
    if system.track(frames[7][1], frames[7][2], 102.03) is None:
        raise RuntimeError("reloc: the frame after the slot reuse was lost")
    return (f"keyframe slot {slot} retired and reused by a new keyframe; the view equals a full "
            f"upload of the map, and the graphed step tracked the next frame against it")


def phase_reloc(cfg, system, frames) -> dict:
    """The walk on, the forced-loss traffic on the mapping phase's frames,
    then localization mode; returns the launch counts."""
    t0 = time.perf_counter()
    tr, reloc = system.tracker, system.reloc_module
    longer = SyntheticSequence(n_frames=N_WALK, cam=cfg.camera, view="walk")
    reset_launches()
    for i in range(N_MAP, N_WALK):
        ts, gray, depth = longer.frame(i)
        if system.track(gray, depth, ts) is None:
            raise RuntimeError("reloc: a walk frame was lost before the forced loss")
    calls = []
    relocalize = reloc.relocalize

    def timed(feats):
        t = time.perf_counter()
        T = relocalize(feats)
        calls.append((round((time.perf_counter() - t) * 1e3, 1),
                      reloc.last_path if T is not None else None))
        return T

    reloc.relocalize = timed
    pad_with_clones(system, 5)
    gray, depth = frames[0][1:]
    T = system.track(np.zeros_like(gray), np.zeros_like(depth), 100.0)
    if T is not None or tr.state != "LOST":
        raise RuntimeError("reloc: the black frame was tracked")
    back = []
    for k, i in enumerate(range(5, -1, -1)):
        T = system.track(frames[i][1], frames[i][2], 100.1 + 0.03 * k)
        back.append((i, T is not None, tr.frame_id == tr.last_reloc_frame_id))
    first = [j for j, (_, ok, _) in enumerate(back) if ok]
    log(f"reloc: frames 5..0 after the lost frame (frame, tracked, relocalized): {back}; "
        f"relocalize calls (ms, path): {calls}; matched keyframe {reloc.last_kf}")
    if not first or not back[first[0]][2]:
        raise RuntimeError("reloc: no relocalization within the walk back")
    if not all(ok for _, ok, _ in back[first[0]:]):
        raise RuntimeError("reloc: a frame after the relocalization was lost")
    n_kf = tr.counts["keyframes"]
    system.activate_localization_mode()
    n_loc = 5
    for k, (ts, gray, depth) in enumerate(frames[1: 1 + n_loc]):
        if system.track(gray, depth, 101.0 + 0.03 * k) is None:
            raise RuntimeError("reloc: a frame was lost in localization mode")
    system.deactivate_localization_mode()
    added = tr.counts["keyframes"] - n_kf
    launches = read_launches()
    n = N_WALK - N_MAP + 1 + len(back) + n_loc
    log(f"reloc: localization mode over {n_loc} frames, keyframes added {added}; launches "
        f"{launches} in {n} frames; {backend_report(system)}")
    if added:
        raise RuntimeError(f"reloc: {added} keyframes added in localization mode")
    reuse = _reuse_slot(system, frames)
    launches = read_launches()
    n += 2
    log(f"reloc: {reuse}")
    _check_launches("reloc", launches, n)
    log(f"phase reloc: {time.perf_counter() - t0:.1f} s")
    return launches


def bench_cfg() -> SlamConfig:
    """bench.py's configuration (bench.py:136-143): 640x480, fx 525, bf
    40, the default ORB settings and capacities."""
    return SlamConfig(camera=CameraConfig(
        fx=525.0, fy=525.0, cx=319.5, cy=239.5, k1=0, k2=0, p1=0, p2=0, k3=0,
        width=640, height=480, bf=40.0))


def _chunk_run(cfg, seq, frames, tmp: str, chunk: int, pipeline: bool, name: str) -> dict:
    """bench.py phase 1's procedure on the port: System(cfg, fast=True,
    pipeline, chunk, enable_surfels=False) over CHUNK_WARM frames with a
    keyframe forced at frame 1 + BENCH_CHUNK, a flush and warmup(), then
    CHUNK_WINDOWS timed windows of CHUNK_WINDOW frames in one continuous
    region (the final flush's drain in the last window).  The launch
    counts and graph replays are set to 0 before the System is made."""
    t0 = time.perf_counter()
    reset_launches()
    replays0 = GraphedStep.replays
    system = System(cfg, fast=True, pipeline=pipeline, chunk=chunk, enable_surfels=False)
    tr = system.tracker
    for i in range(CHUNK_WARM):
        if i == 1 + BENCH_CHUNK:
            tr.force_keyframe = True
        system.track(frames[i][1], frames[i][2], frames[i][0])
    tr.flush()
    solves0 = lm_ops.solve_pose_cuda.launches
    system.warmup()
    torch.cuda.synchronize()
    # the warm-up's relocalization of the last frame solves off the step
    warm_solves = lm_ops.solve_pose_cuda.launches - solves0
    n0 = sum(not r.lost for r in tr.records)
    kf0 = tr.counts["keyframes"]
    since = system.trace.snapshot()
    marks = [time.perf_counter()]
    for w in range(CHUNK_WINDOWS):
        lo = CHUNK_WARM + w * CHUNK_WINDOW
        for ts, g8, d16 in frames[lo: lo + CHUNK_WINDOW]:
            system.track(g8, d16, ts)
        marks.append(time.perf_counter())
    tr.flush()
    torch.cuda.synchronize()
    marks[-1] = time.perf_counter()
    launches = read_launches()
    replays = GraphedStep.replays - replays0
    windows = [(b - a) * 1e3 / CHUNK_WINDOW for a, b in zip(marks, marks[1:])]
    n_timed = CHUNK_WINDOWS * CHUNK_WINDOW
    n_ok = sum(not r.lost for r in tr.records) - n0
    # the step's device time: its graph replayed back to back between events
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(10):
        tr.step.graph.replay()
    b.record()
    b.synchronize()
    device_ms = a.elapsed_time(b) / 10
    traj = os.path.join(tmp, f"CameraTrajectory_{name}.txt")
    system.save_trajectory_tum(traj)
    ts_e, pos_e, _ = traj_io.load_trajectory_tum(traj)
    gt = seq.gt_rows()
    ate = traj_io.ate_rmse(
        (ts_e, pos_e), (np.array([r[0] for r in gt]), np.array([r[1] for r in gt])))
    perf = host_sections(system, since)
    med = statistics.median(windows)
    return {"system": system, "windows": windows, "ms": med, "n_ok": n_ok, "n_timed": n_timed,
            "ate": ate, "keyframes": tr.counts["keyframes"], "kf_timed": tr.counts["keyframes"] - kf0,
            "perf": perf, "launches": launches, "warm_solves": warm_solves, "replays": replays,
            "device_ms": device_ms, "busy": device_ms / med, "seconds": time.perf_counter() - t0}


def _graph_equals_eager(cfg, frames) -> str:
    """The graphed frame step against the eager step on the same frames,
    carry and view, bit for bit: after the capture, after a view update
    written in place, and after a carry reset in place (a
    relocalization's)."""
    dev = torch.device("cuda")
    system = System(cfg, fast=True, enable_surfels=False)  # chunk 1: captured on the second frame
    tr = system.tracker
    for ts, g8, d16 in frames[:3]:
        system.track(g8, d16, ts)
    eager = dt.build_frame_step(cfg, dev, True, True)
    checked = []

    def compare(i: int, what: str) -> None:
        carry = clone_tree(tr.carry)
        g8 = torch.from_numpy(frames[i][1]).to(dev)
        d16 = torch.from_numpy(frames[i][2].astype(np.int32)).to(dev)
        res_e, carry_e = eager(g8, d16, carry, tr.view)
        res_g, carry_g = tr.step(g8, d16, carry, tr.view)
        torch.cuda.synchronize()
        bad = [k for k in ("summary_flat", "payload_flat") if not torch.equal(res_e[k], res_g[k])]
        bad += [f"feats.{k}" for k in res_e["feats"]
                if not torch.equal(res_e["feats"][k], res_g["feats"][k])]
        bad += [f"carry.{k}" for k in carry_e if not torch.equal(carry_e[k], carry_g[k])]
        if bad:
            raise RuntimeError(f"graph: the graphed step differs from the eager step {what}: {bad}")
        checked.append(what)

    compare(3, "after the capture")
    m = tr.map
    rng = np.random.default_rng(0)
    n = 64
    m.add_points(rng.uniform(-1, 1, (n, 3)).astype(np.float32) + np.float32([0, 0, 4]),
                 rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32),
                 np.tile(np.float32([0, 0, -1]), (n, 1)), np.zeros(n, np.float32),
                 np.full(n, 20.0, np.float32), np.zeros(n, np.int32), 0)
    ptrs = [v.data_ptr() for v in tr.view.values()]
    tr.refresh_view()
    if [v.data_ptr() for v in tr.view.values()] != ptrs:
        raise RuntimeError("graph: the view update replaced a view tensor")
    compare(4, "after a view update")
    dt.reset_carry_(tr.carry, cfg, tr.T_cw, vo_points=True)
    compare(5, "after a carry reset")
    return ", ".join(checked)


def phase_chunk(tmp: str, smi: str) -> tuple[dict, dict, dict]:
    """bench.py phase 1 on the port at full width, beside chunk 1 without
    the pipeline on the same frames; the same System on the walk, where
    keyframes come at chunk boundaries; then the graphed step against the
    eager step.  Returns the launch counts of the three runs."""
    t0 = time.perf_counter()
    cfg = bench_cfg()
    n = CHUNK_WARM + CHUNK_WINDOWS * CHUNK_WINDOW
    seq = SyntheticSequence(n_frames=n, cam=cfg.camera, view="corner")
    # sensor-native frames, as bench.py feeds them (u8 gray, u16 depth)
    frames = []
    for i in range(n):
        ts, gray, depth = seq.frame(i)
        frames.append((ts, *dt.to_native(gray, depth)))
    runs = {}
    for name, chunk, pipeline in (("chunk", BENCH_CHUNK, True), ("chunk1", 1, False)):
        run = runs[name] = _chunk_run(cfg, seq, frames, tmp, chunk, pipeline, name)
        tr = run["system"].tracker
        log(f"{name}: System(cfg, fast=True, pipeline={pipeline}, chunk={chunk}, "
            f"enable_surfels=False), bench.py's 640x480 corner, full body, on {smi}: median "
            f"{run['ms']:.2f} ms per frame over {CHUNK_WINDOWS} windows of {CHUNK_WINDOW} "
            f"frames {[round(w, 2) for w in run['windows']]}; {run['n_ok']}/{run['n_timed']} timed "
            f"frames tracked, ATE {run['ate']:.4f} m over {n} frames, keyframes made "
            f"{run['keyframes']} ({run['kf_timed']} in the timed region, one forced in the "
            f"warm-up), relocalized {tr.counts['relocalized']}")
        log(f"{name}: host ms [total, events] in the timed region {run['perf']}; "
            f"{backend_report(run['system'])}")
        log(f"{name}: graph replays per frame {run['replays'] / n:.4f}, kernel launches per "
            f"frame {({k: v / n for k, v in run['launches'].items()})}; the step's graph "
            f"replayed back to back {run['device_ms']:.3f} ms of device time per frame, busy "
            f"share {run['busy']:.3f} of the median frame; {run['seconds']:.1f} s")
        if run["n_ok"] < TRACKED_SHARE * run["n_timed"]:
            raise RuntimeError(f"{name}: only {run['n_ok']} of {run['n_timed']} timed frames tracked")
        if not run["ate"] < ATE_LIMIT:
            raise RuntimeError(f"{name}: ATE {run['ate']} m is not below {ATE_LIMIT} m")
        _check_launches(name, run["launches"], n)
        solves = run["launches"]["solve_pose_cuda"] - run["warm_solves"]
        log(f"{name}: the pose solve launched {solves} times by the step in {n} frames, "
            f"{run['warm_solves']} by the warm-up's relocalization")
        if solves != SOLVES_PER_FRAME * n:
            raise RuntimeError(f"{name}: the step launched the pose solve {solves} times in {n} "
                               f"frames, not {SOLVES_PER_FRAME} per frame")
        run["system"] = None
    log(f"chunk: {runs['chunk']['ms']:.2f} ms per frame at chunk {BENCH_CHUNK} with the "
        f"pipeline, {runs['chunk1']['ms']:.2f} ms per frame at chunk 1 (graphed, no pipeline), "
        f"same frames, same call, {smi}")
    walk_launches = _chunk_walk(cfg, tmp)
    log(f"graph: the graphed step equals the eager step bit for bit "
        f"({_graph_equals_eager(cfg, frames)})")
    log(f"phase chunk: {time.perf_counter() - t0:.1f} s")
    return runs["chunk"]["launches"], runs["chunk1"]["launches"], walk_launches


def _chunk_walk(cfg, tmp: str) -> dict:
    """bench.py phase 1's System on the mapping phase's walk (N_MAP
    frames), where the keyframe policy mints keyframes at chunk
    boundaries (the corner traffic makes none past the forced one): every
    frame recorded, >= 90% tracked, ATE below 0.05 m, at least one
    keyframe event besides keyframe 0, and each kernel once per frame run
    on the card (the partial chunk's padding included)."""
    seq = SyntheticSequence(n_frames=N_MAP, cam=cfg.camera, view="walk")
    reset_launches()
    system = System(cfg, fast=True, pipeline=True, chunk=BENCH_CHUNK, enable_surfels=False)
    tr = system.tracker
    for i in range(N_MAP):
        ts, gray, depth = seq.frame(i)
        system.track(gray, depth, ts)
    system.shutdown()
    torch.cuda.synchronize()
    launches = read_launches()
    traj = os.path.join(tmp, "CameraTrajectory_chunk_walk.txt")
    system.save_trajectory_tum(traj)
    ts_e, pos_e, _ = traj_io.load_trajectory_tum(traj)
    gt = seq.gt_rows()
    ate = traj_io.ate_rmse(
        (ts_e, pos_e), (np.array([r[0] for r in gt]), np.array([r[1] for r in gt])))
    kf = [int(f) for f, v in zip(system.map.kf_frame_id[: system.map.n_kf],
                                  system.map.kf_valid[: system.map.n_kf]) if v]
    n_ok = sum(not r.lost for r in tr.records)
    log(f"chunk_walk: the same System on the {N_MAP}-frame walk: {len(tr.records)} frames recorded, "
        f"{n_ok} tracked, ATE {ate:.4f} m, keyframes made {tr.counts['keyframes']} (live at "
        f"frames {kf}), relocalized {tr.counts['relocalized']}; frames run on the card "
        f"{tr.step.calls} (the last chunk padded); host ms [total, events] "
        f"{host_sections(system)}; "
        f"{backend_report(system)}")
    if len(tr.records) != N_MAP or n_ok < TRACKED_SHARE * N_MAP:
        raise RuntimeError(f"chunk_walk: {len(tr.records)} frames recorded, {n_ok} tracked")
    if not ate < ATE_LIMIT:
        raise RuntimeError(f"chunk_walk: ATE {ate} m is not below {ATE_LIMIT} m")
    if tr.counts["keyframes"] < 2:
        raise RuntimeError("chunk_walk: no keyframe event besides keyframe 0")
    _check_launches("chunk_walk", launches, tr.step.calls)
    return launches


def _profile_counts(fn) -> tuple[dict, object]:
    """CUDA kernel launches, host syncs and copies of one fn() call, from
    the profiler's CUDA runtime events (the card synchronized before and
    after); returns (counts, fn's result)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    counts = {
        "launches": sum(e.count for e in ev
                        if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")),
        "syncs": sum(e.count for e in ev if "Synchronize" in e.key),
        "copies": sum(e.count for e in ev if "cudaMemcpy" in e.key),
        # the CUDA runtime calls that held the host longest: [count, ms]
        "runtime_ms": {e.key: [e.count, round(e.cpu_time_total / 1e3, 2)] for e in sorted(
            (e for e in ev if e.key.startswith("cu")), key=lambda e: -e.cpu_time_total)[:5]},
    }
    return counts, out


def _g(xs) -> list[str]:
    return [f"{float(x):.3g}" for x in xs]


def _plane_errors(sp: dict, ref: dict, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Normal angle (rad) and largest mean coordinate difference (m) of
    superpixels ids against ref."""
    dots = np.abs((sp["normal"][ids] * ref["normal"][ids]).sum(-1))
    return (np.arccos(np.clip(dots, 0.0, 1.0)),
            np.abs(sp["mean"][ids] - ref["mean"][ids]).max(-1))


def _compare_superpixels(card: dict, cpu: dict, f64: dict) -> str:
    """One frame's superpixels on the card against the CPU (float32) and a
    float64 CPU run, under the SP_* tolerances; returns a report, raises
    when they disagree."""
    card, cpu, f64 = ({k: v.cpu().numpy() for k, v in d.items()} for d in (card, cpu, f64))
    share = float((card["labels"] == cpu["labels"]).mean())
    S = cpu["mean"].shape[0]
    touched = np.zeros(S + 1, bool)
    for a, b in ((card, cpu), (card, f64), (cpu, f64)):
        diff = a["labels"] != b["labels"]
        touched[np.where(diff, a["labels"], S)] = True
        touched[np.where(diff, b["labels"], S)] = True
    same = np.nonzero(~touched[:S] & (cpu["n_pix"] > 0))[0]
    valid_share = float((card["valid"][same] == cpu["valid"][same]).mean())
    both = same[card["valid"][same] & cpu["valid"][same] & f64["valid"][same]]
    ang_card, mean_card = _plane_errors(card, f64, both)
    ang_cpu, mean_cpu = _plane_errors(cpu, f64, both)
    q = {k: (np.percentile(v, 99), v.max()) if len(v) else (0.0, 0.0) for k, v in
         (("ang_card", ang_card), ("mean_card", mean_card), ("ang_cpu", ang_cpu),
          ("mean_cpu", mean_cpu))}
    report = (f"labels equal on {share:.6f} of the pixels, valid flags on {valid_share:.4f} of "
              f"{len(same)} superpixels with the same members; against float64 on {len(both)} "
              f"valid in all, [99th percentile, worst]: card normals {_g(q['ang_card'])} rad, "
              f"means {_g(q['mean_card'])} m; CPU float32 normals {_g(q['ang_cpu'])} rad, "
              f"means {_g(q['mean_cpu'])} m")
    if (share < SP_LABEL_SHARE or valid_share < SP_VALID_SHARE or not len(both)
            or q["ang_card"][0] > SP_ERR_RATIO * q["ang_cpu"][0] + SP_ANGLE_FLOOR
            or q["mean_card"][0] > SP_ERR_RATIO * q["mean_cpu"][0] + SP_MEAN_FLOOR
            or q["ang_card"][1] > SP_MAX_ANGLE or q["mean_card"][1] > SP_MAX_MEAN):
        raise RuntimeError(f"surfels: superpixels card vs CPU: {report}")
    return report


def _check_surfel_ops(cfg, dev, system, inserts, seq) -> str:
    """The surfel ops of the last two inserted keyframes on the card
    against the CPU, and superpixels twice on the card.  The walk's pixels
    are nearly all plane pixels, which the mapper leaves out, so the ops
    run here without the plane mask, where there are superpixels to fuse:
    superpixels (card, CPU and a float64 CPU run), then from an empty state
    both keyframes' new surfels and fusion on the card and on the CPU,
    given the card's superpixels; their surfels must lie in the room
    (the uint16 depth converted to metres), and a card mapper inserting the
    same two frames as the caller gave them must build the same state."""
    (kf_a, g_a, d_a, memb, _), (kf_b, g_b, d_b, _, _) = inserts[-2], inserts[-1]
    K = system.surfel_mapper.K
    H, W = g_b.shape
    # the keyframe's superpixels as the mapper runs them, twice on the card
    mask = plane_mask(memb, H, W, dev)
    frames = [(torch.from_numpy(np.asarray(g, np.float32)), torch.from_numpy(dt.depth_in_metres(d)))
              for g, d in ((g_a, d_a), (g_b, d_b))]
    g, d = frames[-1]
    sp = surf_ops.superpixels(g.to(dev), d.to(dev), mask, K)
    sp2 = surf_ops.superpixels(g.to(dev), d.to(dev), mask, K)
    if not all(torch.equal(sp[k], sp2[k]) for k in sp):
        raise RuntimeError("surfels: two card runs of superpixels differ: "
                           f"{[k for k in sp if not torch.equal(sp[k], sp2[k])]}")
    no_mask = torch.zeros((H, W), dtype=torch.bool)
    K_cpu = K.cpu()
    sps = [surf_ops.superpixels(g.to(dev), d.to(dev), no_mask.to(dev), K) for g, d in frames]
    rep_sp = _compare_superpixels(
        sps[-1], surf_ops.superpixels(g, d, no_mask, K_cpu),
        surf_ops.superpixels(g.double(), d.double(), no_mask, K_cpu.double()))
    cap = cfg.surfel.max_surfels
    states = {"card": surf_ops.empty_state(cap, dev), "cpu": surf_ops.empty_state(cap, "cpu")}
    n_fused = 0
    for kf, sp_k in zip((kf_a, kf_b), sps):
        T_cw = torch.from_numpy(system.map.kf_pose[kf].astype(np.float32))
        T_wc = torch.from_numpy(np.linalg.inv(system.map.kf_pose[kf].astype(np.float32)))
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            sp_d = {k: v.to(device) for k, v in sp_k.items()}
            fused = surf_ops.fuse_surfels(states[name], sp_d, T_cw.to(device), T_wc.to(device),
                                          K.to(device), kf, H, W)
            surf_ops.add_new_surfels(states[name], sp_d, fused, T_wc.to(device), kf)
            n_fused = int(fused.sum()) if name == "card" else n_fused
    err = 0.0
    for k, v in states["cpu"].items():
        a = states["card"][k].cpu()
        if v.dtype.is_floating_point:
            err = max(err, float((a - v).abs().max()))
        elif not torch.equal(a, v):
            raise RuntimeError(f"surfels: {k} differs between card and CPU after two keyframes")
    if err > SURFEL_STATE_TOL:
        raise RuntimeError(f"surfels: the surfel state differs by {err} between card and CPU")
    mapper = SurfelMapper(cfg, system.map, dev)
    mapper.insert_keyframe(kf_a, g_a, d_a, ref_kf=None)
    mapper.insert_keyframe(kf_b, g_b, d_b, ref_kf=kf_a)
    bad = [k for k in states["card"] if not torch.equal(mapper.surfels[k], states["card"][k])]
    if bad:
        raise RuntimeError(f"surfels: the mapper's uint16 inserts differ from the ops in metres: {bad}")
    live = states["cpu"]["valid"].numpy()
    inside = _inside_room(seq, states["cpu"]["pos"].numpy()[live])
    if not live.any() or not n_fused or inside <= INSIDE_SHARE:
        raise RuntimeError(f"surfels: without the plane mask {int(live.sum())} surfels, "
                           f"{n_fused} fused, {inside} inside the room")
    return (f"keyframe {kf_b}'s superpixels twice on the card equal; card vs CPU (no plane "
            f"mask) {rep_sp}; keyframes {kf_a} then {kf_b} fused on the card and on the CPU from "
            f"the card's superpixels: {int(live.sum())} surfels, {n_fused} superpixels fused, flags "
            f"and counts equal, floats within {err:.3g}, {inside:.4f} inside the room; a card "
            f"mapper given the uint16 frames built the same state")


def _record_inserts(mapper) -> list:
    """Record each insert_keyframe call of the mapper as (kf_id, gray,
    depth, plane_membership, ref_kf); returns the list it fills."""
    inserts, insert = [], mapper.insert_keyframe

    def recorded(kf_id, gray, depth, plane_membership=None, ref_kf=None):
        inserts.append((kf_id, gray, depth, plane_membership, ref_kf))
        return insert(kf_id, gray, depth, plane_membership=plane_membership, ref_kf=ref_kf)

    mapper.insert_keyframe = recorded
    return inserts


def _surfel_yield(name: str, mapper, inserts) -> dict:
    """What the plane masks of the inserted keyframes left to the
    superpixels: usable pixels (depth, no plane) and valid superpixels,
    run again on the mapper's device; the map's live surfels, those fused
    into at least once, and the exported vertices split into stable
    surfels and the map planes' flattened clouds.  Raises unless the map
    holds surfels exactly when some insert had a valid superpixel (no
    surfel is ever removed)."""
    usable = n_valid = 0
    for kf_id, gray, depth, memb, _ in inserts:
        g = dt.to_device(np.asarray(gray, np.float32), mapper.device)
        d = dt.to_device(dt.depth_in_metres(depth), mapper.device)
        mask = plane_mask(memb, *g.shape, mapper.device)
        usable += int(((d > 0) & ~mask).sum())
        n_valid += int(surf_ops.superpixels(g, d, mask, mapper.K)["valid"].sum())
    s = mapper.surfels
    m = mapper.map
    out = {"usable": usable, "valid_sp": n_valid, "live": int(s["valid"].sum()),
           "fused": int((s["valid"] & (s["n_updates"] >= 2)).sum()),
           "plane_pts": int(sum(m.pl_n_pts[j] for j in np.nonzero(m.pl_valid)[0])),
           "exported": len(mapper.export_arrays()["pos"])}
    out["surfels_exported"] = out["exported"] - out["plane_pts"]
    if (out["live"] > 0) != (n_valid > 0):
        raise RuntimeError(f"{name}: {out['live']} live surfels after {len(inserts)} inserts with "
                           f"{n_valid} valid superpixels")
    return out


def _yield_report(y: dict, n_inserts: int) -> str:
    return (f"the plane masks of the {n_inserts} inserted keyframes left {y['usable']} pixels and "
            f"{y['valid_sp']} valid superpixels; live surfels {y['live']} ({y['fused']} fused into "
            f"at least once); exported vertices {y['exported']}: {y['surfels_exported']} surfels "
            f"and {y['plane_pts']} points of the map planes' flattened clouds")


def _inside_room(seq, pos: np.ndarray) -> float:
    """Share of the points (first camera's frame) inside the padded room
    (tests/test_surfels.py's bar)."""
    T0 = seq.poses[0]
    room = pos @ T0[:3, :3].T + T0[:3, 3]
    return float(((room > -0.5).all(1) & (room < np.array(seq.room.size) + 0.5).all(1)).mean()
                 ) if len(room) else 0.0


def _surfels_corner(cfg, smi: str) -> dict:
    """bench.py phase 2's System and warm-up on phase 1's corner view,
    where the plane mask leaves most of each frame to the superpixels
    (the walk's leaves none): 1 + 2 x chunk uint16 frames, a keyframe
    forced at 1 + chunk, flush.  The surfels that the two keyframes'
    inserts build on the card must be live, partly fused, inside the
    room, and as many as a CPU mapper inserting the same frames, plane
    memberships and links builds, within the valid-flag share that
    superpixels on the card and the CPU are held to.  Returns the launch
    counts."""
    t0 = time.perf_counter()
    seq = SyntheticSequence(n_frames=CHUNK_WARM, cam=cfg.camera, view="corner")
    frames = []
    for i in range(CHUNK_WARM):
        ts, gray, depth = seq.frame(i)
        frames.append((ts, *dt.to_native(gray, depth)))
    reset_launches()
    system = System(cfg, fast=True, pipeline=True, chunk=BENCH_CHUNK, enable_surfels=True)
    tr, mapper = system.tracker, system.surfel_mapper
    inserts = _record_inserts(mapper)
    for i, (ts, g8, d16) in enumerate(frames):
        if i == 1 + BENCH_CHUNK:
            tr.force_keyframe = True
        system.track(g8, d16, ts)
    tr.flush()
    torch.cuda.synchronize()
    launches = read_launches()
    y = _surfel_yield("surfels_corner", mapper, inserts)
    cpu = SurfelMapper(cfg, system.map, "cpu")
    for kf_id, gray, depth, memb, ref_kf in inserts:
        cpu.insert_keyframe(kf_id, gray, depth,
                            plane_membership=None if memb is None else memb.cpu(), ref_kf=ref_kf)
    live_cpu = int(cpu.surfels["valid"].sum())
    fused_cpu = int((cpu.surfels["valid"] & (cpu.surfels["n_updates"] >= 2)).sum())
    s = mapper.surfels
    inside = _inside_room(seq, s["pos"][s["valid"]].cpu().numpy())
    n_ok = sum(not r.lost for r in tr.records)
    log(f"surfels_corner: the same System on the 640x480 corner, {CHUNK_WARM} uint16 frames, on "
        f"{smi}: {n_ok}/{CHUNK_WARM} frames tracked, keyframes {tr.counts['keyframes']}, surfel "
        f"inserts {len(inserts)}; {_yield_report(y, len(inserts))}; live surfels inside the room "
        f"{inside:.4f}; a CPU mapper given the same inserts: live {live_cpu}, fused {fused_cpu}; "
        f"{time.perf_counter() - t0:.1f} s")
    slack = 1.0 - SP_VALID_SHARE
    if (len(inserts) < 2 or not y["live"] or not y["fused"] or inside <= INSIDE_SHARE
            or abs(y["live"] - live_cpu) > slack * live_cpu
            or abs(y["fused"] - fused_cpu) > slack * fused_cpu):
        raise RuntimeError(f"surfels_corner: {len(inserts)} inserts, live {y['live']} (CPU "
                           f"{live_cpu}), fused {y['fused']} (CPU {fused_cpu}), inside {inside}")
    if n_ok != CHUNK_WARM:
        raise RuntimeError(f"surfels_corner: {n_ok} of {CHUNK_WARM} frames tracked")
    _check_launches("surfels_corner", launches, tr.step.calls)
    return launches


def phase_surfels(tmp: str, smi: str) -> dict:
    """bench.py phase 2's procedure on the port: System(cfg, fast=True,
    pipeline=True, chunk=16, enable_surfels=True) on the walk, uint16
    frames; then the same System on the corner (_surfels_corner).
    Returns the launch counts of both runs."""
    t0 = time.perf_counter()
    cfg = bench_cfg()
    dev = torch.device("cuda")
    n = CHUNK_WARM + SURFEL_WINDOWS * SURFEL_WINDOW
    seq = SyntheticSequence(n_frames=n, cam=cfg.camera, view="walk")
    frames = []
    for i in range(n):
        ts, gray, depth = seq.frame(i)
        frames.append((ts, *dt.to_native(gray, depth)))  # u8 gray, u16 depth, as bench.py
    reset_launches()
    system = System(cfg, fast=True, pipeline=True, chunk=BENCH_CHUNK, enable_surfels=True)
    tr, mapper = system.tracker, system.surfel_mapper
    inserts = _record_inserts(mapper)
    for i in range(CHUNK_WARM):
        if i == 1 + BENCH_CHUNK:
            tr.force_keyframe = True
        system.track(frames[i][1], frames[i][2], frames[i][0])
    tr.flush()
    system.warmup()
    torch.cuda.synchronize()
    kf0, ins0 = tr.counts["keyframes"], len(inserts)
    ins_s0, since = span_seconds(system, "keyframe.surfel_insert"), system.trace.snapshot()
    marks = [time.perf_counter()]
    for w in range(SURFEL_WINDOWS):
        lo = CHUNK_WARM + w * SURFEL_WINDOW
        for ts, g8, d16 in frames[lo: lo + SURFEL_WINDOW]:
            system.track(g8, d16, ts)
        marks.append(time.perf_counter())
    tr.flush()
    torch.cuda.synchronize()
    marks[-1] = time.perf_counter()
    launches = read_launches()
    windows = [(b - a) * 1e3 / SURFEL_WINDOW for a, b in zip(marks, marks[1:])]
    kf_timed = tr.counts["keyframes"] - kf0
    ins_timed = len(inserts) - ins0
    host_ms = (span_seconds(system, "keyframe.surfel_insert") - ins_s0) * 1e3 / max(ins_timed, 1)
    traj = os.path.join(tmp, "CameraTrajectory_surfels.txt")
    system.save_trajectory_tum(traj)
    ts_e, pos_e, _ = traj_io.load_trajectory_tum(traj)
    gt = seq.gt_rows()
    ate = traj_io.ate_rmse(
        (ts_e, pos_e), (np.array([r[0] for r in gt]), np.array([r[1] for r in gt])))
    n_ok = sum(not r.lost for r in tr.records)
    y = _surfel_yield("surfels", mapper, inserts)
    inside = _inside_room(seq, mapper.export_arrays()["pos"])
    # one insert's launches, syncs and copies: the last keyframe's frame
    # into a fresh mapper over the same map (the same code path)
    last = inserts[-1]
    fresh = SurfelMapper(cfg, system.map, dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fresh.insert_keyframe(*last[:3], plane_membership=last[3], ref_kf=None)
    t_host = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    t_idle = (time.perf_counter() - t) * 1e3
    prof, _ = _profile_counts(lambda: fresh.insert_keyframe(
        *last[:3], plane_membership=last[3], ref_kf=None))
    log(f"surfels: System(cfg, fast=True, pipeline=True, chunk={BENCH_CHUNK}, enable_surfels=True), "
        f"bench.py phase 2 on the port: the 640x480 walk, uint16 frames, on {smi}: ms per frame "
        f"by window {[round(w, 2) for w in windows]} (median {statistics.median(windows):.2f}); "
        f"{n_ok}/{n} frames tracked, ATE {ate:.4f} m; keyframes in the timed windows {kf_timed}, "
        f"surfel inserts {ins_timed} (all {len(inserts)}); host ms per surfel insert {host_ms:.2f}; "
        f"one insert on an idle card: {t_host:.2f} ms host, {t_idle:.2f} ms to its end, "
        f"{prof['launches']} launches, {prof['syncs']} syncs, {prof['copies']} copies, the "
        f"runtime calls that held the host longest [count, ms] {prof['runtime_ms']}; "
        f"{_yield_report(y, len(inserts))}; exported vertices inside the room {inside:.4f}"
        f"{' (the map planes alone)' if not y['surfels_exported'] else ''}")
    log(f"surfels: host ms [total, events] in the timed region "
        f"{host_sections(system, since)}; "
        f"{backend_report(system)}")
    log(f"surfels: {_check_surfel_ops(cfg, dev, system, inserts, seq)}")
    if ins_timed < 1:
        raise RuntimeError("surfels: no keyframe with a surfel insert in the timed windows")
    if not y["exported"] or inside <= INSIDE_SHARE:
        raise RuntimeError(f"surfels: {y['exported']} vertices exported, {inside} inside the room")
    if n_ok < TRACKED_SHARE * n:
        raise RuntimeError(f"surfels: {n_ok} of {n} frames tracked")
    for kf_id, gray, depth, _, _ in inserts:
        fid = int(system.map.kf_frame_id[kf_id])
        if depth is not frames[fid][2]:
            raise RuntimeError(f"surfels: keyframe {kf_id} was inserted with another frame's depth")
    _check_launches("surfels", launches, tr.step.calls)
    corner_launches = _surfels_corner(cfg, smi)
    log(f"phase surfels: {time.perf_counter() - t0:.1f} s")
    return launches, corner_launches


def phase_modular(tmp: str, smi: str) -> dict:
    """System(cfg) with the reference's defaults (the modular tracker,
    planes, lines and surfels on) over N_MODULAR near_corner frames at
    640x480; returns the launch counts."""
    t0 = time.perf_counter()
    cfg = bench_cfg()
    seq = SyntheticSequence(n_frames=N_MODULAR, cam=cfg.camera, view="near_corner")
    frames = [seq.frame(i) for i in range(N_MODULAR)]
    reset_launches()
    system = System(cfg)  # CUDA, the reference's defaults
    inserts = _record_inserts(system.surfel_mapper)
    pm = system.tracker.plane_module
    ms, tracked, manhattan, profiled = [], 0, 0, None
    for i, (ts, gray, depth) in enumerate(frames):
        t = time.perf_counter()
        if i == N_MODULAR - 1:  # the last frame profiled (CUPTI tracing slows it)
            profiled, T = _profile_counts(lambda: system.track(gray, depth, ts))
        else:
            T = system.track(gray, depth, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        tracked += T is not None
        manhattan += pm.manhattan_Rcw is not None
    system.shutdown()
    launches = read_launches()
    traj = os.path.join(tmp, "CameraTrajectory_modular.txt")
    system.save_trajectory_tum(traj)
    ts_e, pos_e, _ = traj_io.load_trajectory_tum(traj)
    gt = seq.gt_rows()
    ate = traj_io.ate_rmse(
        (ts_e, pos_e), (np.array([r[0] for r in gt]), np.array([r[1] for r in gt])))
    ply_path = os.path.join(tmp, "Surfels_modular.ply")
    system.save_surfels(ply_path)
    y = _surfel_yield("modular", system.surfel_mapper, inserts)
    m = system.map
    log(f"modular: System(cfg) (the modular tracker, planes, lines and surfels on), 640x480 "
        f"near_corner, on {smi}: {tracked}/{N_MODULAR} frames tracked, ATE {ate:.4f} m, the "
        f"Manhattan frame on {manhattan} frames; median {statistics.median(ms[1:]):.1f} ms per frame, "
        f"largest {max(ms[1:]):.1f} (first frame {ms[0]:.0f} ms); the last frame "
        f"{profiled}; keyframes {m.n_kf}, map planes {int(m.pl_valid.sum())}, map lines "
        f"{int(m.ml_valid.sum())}; {_yield_report(y, len(inserts))}; kernel launches {launches}")
    log(f"modular: {backend_report(system)}; surfel inserts "
        f"{system.surfel_mapper.n_keyframes}, host ms per insert "
        f"{span_seconds(system, 'keyframe.surfel_insert') * 1e3 / max(system.surfel_mapper.n_keyframes, 1):.2f}")
    if tracked != N_MODULAR or not ate < ATE_LIMIT:
        raise RuntimeError(f"modular: {tracked} of {N_MODULAR} frames tracked, ATE {ate} m")
    if manhattan < MANHATTAN_FRAMES:
        raise RuntimeError(f"modular: the Manhattan frame on {manhattan} frames only")
    if not y["exported"]:
        raise RuntimeError("modular: nothing exported")
    _check_launches("modular", launches, N_MODULAR)
    log(f"phase modular: {time.perf_counter() - t0:.1f} s")
    return launches


N_PERSIST = 90  # walk frames written as a TUM sequence in the persist phase
PERSIST_LOST = 3  # lost frames, one of which the loaded map must relocalize
PERSIST_TRACK = 10  # frames then tracked from the graphed step
# card against CPU AHC planes: the partition of each card's own stats
# (float32 sums in another order) may differ only where a merge sits on a
# threshold, so the gate holds the valid counts equal and each plane's
# normal within AHC_NORMAL_TOL and offset within AHC_D_TOL * |d|: the
# bar tests/test_torch_cuda.py holds the device method's plane_stage2 to,
# card against CPU, at 640x480
AHC_NORMAL_TOL = 1e-4
AHC_D_TOL = 1e-4
MESH_B = 8  # build_batched_track_step streams on the one-card mesh
# the fused step's acceptance: at least 7 point inliers (device_tracker.py
# tracked_ok, the reference's device_tracker.py:887)
TRACK_MIN_INLIERS = 7
MESH_STEPS = 6  # the first not timed
ARGMIN_BANK, ARGMIN_QUERIES = 4096, 1000


def _write_tum(cfg, seq, root: str) -> list:
    """N_PERSIST frames of `seq` as a TUM-format sequence under root (RGB
    from the gray frame, 16-bit depth at DepthMapFactor, associations);
    returns what was written: (timestamp, rgb, float depth) per frame."""
    from manhattanslam_tpu_torch.io.png import write_png

    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    lines, written = ["# timestamp rgb timestamp depth"], []
    for i in range(N_PERSIST):
        ts, gray, depth = seq.frame(i)
        g8 = np.clip(np.round(gray), 0, 255).astype(np.uint8)
        rgb = np.stack([g8, g8, g8], -1)
        d16 = np.clip(np.round(depth * cfg.depth_map_factor), 0, 65535).astype(np.uint16)
        write_png(os.path.join(root, "rgb", f"{i:04d}.png"), rgb)
        write_png(os.path.join(root, "depth", f"{i:04d}.png"), d16)
        lines.append(f"{ts:.6f} rgb/{i:04d}.png {ts:.6f} depth/{i:04d}.png")
        written.append((ts, rgb, depth))
    with open(os.path.join(root, "associations.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return written


def _gt_ate(seq, path_or_rows) -> float:
    gt = seq.gt_rows()
    return traj_io.ate_rmse(path_or_rows,
                            (np.array([r[0] for r in gt]), np.array([r[1] for r in gt])))


def _persist_runner(cfg, seq, root: str, dev) -> str:
    """run_slam.main over the TUM sequence with the reference's defaults
    (fused, chunk 1, planes, lines, surfels), writing under root."""
    import contextlib
    import io

    from manhattanslam_tpu_torch import run_slam

    track, ms = System.track, []

    def timed(self, *a, **k):
        t = time.perf_counter()
        T = track(self, *a, **k)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        return T

    prefix = os.path.join(root, "run_")
    out = io.StringIO()
    reset_launches()
    System.track = timed
    try:
        with contextlib.redirect_stdout(out):
            rc = run_slam.main(["--settings", os.path.join(HERE, "configs", "TUM1.yaml"),
                                "--sequence", root, "--associations",
                                os.path.join(root, "associations.txt"), "--device", str(dev),
                                "--out-prefix", prefix])
    finally:
        System.track = track
    launches = read_launches()
    report = out.getvalue().splitlines()
    for line in report:
        log(f"persist: runner | {line}")
    traj = prefix + "CameraTrajectory.txt"
    rows = [ln.split() for ln in open(traj) if ln.strip()]
    ate = _gt_ate(seq, traj)
    log(f"persist: runner median {statistics.median(ms[1:]):.1f} ms/frame, largest "
        f"{max(ms[1:]):.1f} (first frame {ms[0]:.0f} ms), ATE {ate:.4f} m against the "
        f"renderer, {len(rows)} trajectory lines, launches {launches}")
    if rc != 0 or f"tracked: {N_PERSIST}/{N_PERSIST} frames" not in report:
        raise RuntimeError(f"persist: the runner returned {rc} and did not track every frame")
    if not ate < ATE_LIMIT:
        raise RuntimeError(f"persist: the runner's ATE {ate} m is not below {ATE_LIMIT} m")
    if len(rows) != N_PERSIST or any(len(r) != 8 for r in rows):
        raise RuntimeError("persist: a trajectory line without 8 fields")
    for name in ("KeyFrameTrajectory.txt", "Surfels.ply"):
        if not os.path.exists(prefix + name):
            raise RuntimeError(f"persist: the runner wrote no {name}")
    _check_launches("persist runner", launches, N_PERSIST)
    return launches


def _persist_reload(cfg, seq, frames, root: str, dev) -> dict:
    """A System with the viewer over the frames, saved; a fresh System
    loads it, relocalizes a lost frame in localization mode and tracks on
    from the graphed step.  Returns the launch counts."""
    from manhattanslam_tpu_torch.io import map_io

    reset_launches()
    first = System(cfg, fast=True, use_viewer=True, device=dev)
    n_kf = []
    for ts, gray, depth in frames:
        if first.track(gray, depth, ts) is None:
            raise RuntimeError("persist: a frame of the viewer's System was lost")
        n_kf.append(first.map.n_kf)
    first.shutdown()
    v = first.viewer
    kp = v._res["feats"]["valid"].sum().item() if v._res is not None else 0
    tracked_kp = int((first.tracker.last_mp_idx >= 0).sum())
    log(f"persist: System(fast=True, use_viewer=True) over {len(frames)} frames, the viewer "
        f"updated on each; keyframes by frame {n_kf[::10]} ... {n_kf[-1]}; the viewer holds "
        f"the last frame's {kp} keypoints, {tracked_kp} tracked; retired slots "
        f"{first.map.kf_free}, last keyframe {first.map.last_kf_added}")
    path = os.path.join(root, "map.npz")
    first.save_map(path)
    second = System(cfg, fast=True, device=dev)
    second.load_map(path)
    a, b = first.map, second.map
    bad = [k for k in map_io._ARRAYS if not np.array_equal(getattr(a, k), getattr(b, k))]
    scal = ("n_kf", "kf_free", "last_kf_added", "manhattan_pairs", "manhattan_triples",
            "kf_not_erase")
    bad += [k for k in scal if getattr(a, k) != getattr(b, k)]
    if bad:
        raise RuntimeError(f"persist: the loaded map differs in {bad}")
    tr, reloc = second.tracker, second.reloc_module
    calls, relocalize = [], reloc.relocalize

    def timed(feats):
        t = time.perf_counter()
        T = relocalize(feats)
        calls.append((round((time.perf_counter() - t) * 1e3, 1),
                      reloc.last_path if T is not None else None))
        return T

    reloc.relocalize = timed
    # the kidnapped camera stands where the map is best covered: at the
    # frame of the keyframe with the most covisibility (keyframe 0 aside,
    # whose pose is the carry's start); away from it the relocalizer's
    # candidates come from keyframes 40 frames off (ROADMAP Queue 3)
    kfs = [k for k in range(1, b.n_kf) if b.kf_valid[k]]
    kf = max(kfs, key=lambda k: (int(b.covis[k].sum()), -k))
    at = min(int(b.kf_frame_id[kf]), len(frames) - PERSIST_LOST - PERSIST_TRACK)
    second.activate_localization_mode()
    tr.state, tr.frame_id = "LOST", 1000
    back = []
    for i in range(at, at + PERSIST_LOST):
        ts, gray, depth = frames[i]
        T = second.track(gray, depth, ts)
        back.append((i, T is not None, tr.frame_id == tr.last_reloc_frame_id))
        if T is not None:
            break
    log(f"persist: loaded map ({b.n_kf} keyframe slots at frames "
        f"{b.kf_frame_id[:b.n_kf].tolist()}, {int(b.mp_valid.sum())} points); lost from keyframe "
        f"{kf}'s frame on (frame, tracked, relocalized): {back}; relocalize calls (ms, path): "
        f"{calls}; matched keyframe {reloc.last_kf}")
    if not back[-1][1] or not back[-1][2]:
        raise RuntimeError("persist: no frame among the first three relocalized on the loaded map")
    start = back[-1][0] + 1
    for i in range(start, start + PERSIST_TRACK):
        ts, gray, depth = frames[i]
        if second.track(gray, depth, ts) is None:
            raise RuntimeError(f"persist: frame {i} lost after the relocalization; the tracker's "
                               f"last frames (id, inliers, ok, ...) {tr.frame_log[-6:]}")
    if dev.type == "cuda" and tr.step.graph is None:
        raise RuntimeError("persist: the loaded System's step was not graphed")
    rows = tr.trajectory_rows()[-PERSIST_TRACK:]
    ate = _gt_ate(seq, (np.array([r[0] for r in rows]), np.array([r[1] for r in rows])))
    ref = {round(r[0], 6): np.asarray(r[1]) for r in first.tracker.trajectory_rows()}
    gap = max(float(np.linalg.norm(np.asarray(r[1]) - ref[round(r[0], 6)])) for r in rows)
    log(f"persist: {PERSIST_TRACK} frames tracked from the graphed step after it, ATE "
        f"{ate:.4f} m against the renderer, largest distance to the first System's poses "
        f"{gap:.4f} m")
    if not ate < ATE_LIMIT:
        raise RuntimeError(f"persist: the reloaded System's ATE {ate} m is not below {ATE_LIMIT}")
    launches = read_launches()
    _check_launches("persist reload", launches, len(frames) + len(back) + PERSIST_TRACK)
    return launches


def _quantized(cfg, seq, i: int) -> np.ndarray:
    d16 = dt.to_native(*seq.frame(i)[1:])[1]
    return d16.astype(np.float32) * np.float32(1.0 / dt.DEPTH_QUANT)


def _persist_ahc(cfg, dev) -> str:
    """The exact AHC merge at 640x480 on a corner and a near_corner frame:
    on the card, the C++ and Python merges on the same pulled stats, the
    card's planes against the CPU's, and the device method's count."""
    from manhattanslam_tpu_torch.ops import planes

    K = np.asarray(cfg.camera.K, np.float32)
    P, M = cfg.caps.max_planes_frame, cfg.caps.max_plane_points
    h, w = cfg.camera.height // 2, cfg.camera.width // 2
    grid, min_support = (h // planes.BLOCK, w // planes.BLOCK), int(0.04 * h * w)
    out = []
    for view in ("corner", "near_corner"):
        depth = _quantized(cfg, SyntheticSequence(n_frames=1, cam=cfg.camera, view=view), 0)
        d_card = torch.from_numpy(depth).to(dev)
        card = planes.extract_planes(d_card, K, P, M, method="ahc")
        devm = planes.extract_planes(d_card, K, P, M, method="device")
        cpu = planes.extract_planes(depth, K, P, M, method="ahc", device="cpu")
        _, packed = planes.plane_stage1(d_card, torch.from_numpy(K).to(dev))
        st = planes.unpack_stats(packed.cpu().numpy())
        t = time.perf_counter()
        lab_cc = planes.merge_blocks(st, grid, min_support)
        t_cc = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        lab_py = planes.merge_blocks_py(st, grid, min_support)
        t_py = (time.perf_counter() - t) * 1e3
        pairs = {}
        same = all((a < 0) == (b < 0) and pairs.setdefault(a, b) == b
                   for a, b in zip(lab_cc, lab_py)) and len(set(pairs.values())) == len(pairs)
        if not same:
            raise RuntimeError(f"persist ahc {view}: the C++ and Python merges partition apart")
        nc, nh = int(card["valid"].sum()), int(cpu["valid"].sum())
        if nc != nh:
            raise RuntimeError(f"persist ahc {view}: {nc} planes on the card, {nh} on the CPU")
        cc, ch = card["coeffs"][card["valid"]], cpu["coeffs"][cpu["valid"]]
        dn = float(np.abs(cc[:, :3] - ch[:, :3]).max()) if nc else 0.0
        dd = float((np.abs(cc[:, 3] - ch[:, 3]) / np.abs(ch[:, 3])).max()) if nc else 0.0
        log(f"persist ahc {view}: {cfg.camera.width}x{cfg.camera.height}, device method "
            f"{int(devm['valid'].sum())} planes, exact AHC {nc} planes on the card ({nh} on the CPU, normals within {dn:.3g}, "
            f"offsets within {dd:.3g} of |d|); the C++ merge {t_cc:.3f} ms and the Python merge "
            f"{t_py:.1f} ms on the host, the same partition into {len(pairs) - (-1 in pairs)} "
            f"segments")
        if not (dn <= AHC_NORMAL_TOL and dd <= AHC_D_TOL):
            raise RuntimeError(f"persist ahc {view}: card planes off the CPU's by {dn} / {dd}")
        out.append(f"{view} device {int(devm['valid'].sum())} / AHC {nc}")
    return ", ".join(out)


def _persist_mesh(cfg, seq, dev) -> dict:
    """build_batched_track_step at B = MESH_B on make_mesh() against the
    same step at B = 1 per stream, and sharded_hamming_argmin on meshes of
    one and four entries of the card.  Returns the step's launch counts."""
    m1 = mesh.make_mesh()
    if m1.devices.size != torch.cuda.device_count():
        raise RuntimeError(f"persist mesh: make_mesh() holds {m1.devices.size} devices")
    f0 = frame.build_extractor(cfg, dev)(*(torch.from_numpy(x).to(dev) for x in (
        np.round(seq.frame(0)[1]).astype(np.float32), _quantized(cfg, seq, 0))))
    bank = {"pos": frame.backproject_keypoints(f0, cfg), "desc": f0["desc"],
            "valid": f0["valid"] & (f0["depth"] > 0), "level": f0["level"]}
    idx = list(range(1, MESH_B + 1))
    gray = torch.from_numpy(np.stack([np.round(seq.frame(i)[1]) for i in idx]).astype(np.float32))
    depth = torch.from_numpy(np.stack([_quantized(cfg, seq, i) for i in idx]))
    seeds = torch.from_numpy(np.stack([np.linalg.inv(seq.poses[i - 1]) @ seq.poses[0]
                                       for i in idx]).astype(np.float32))
    gray, depth, seeds = gray.to(dev), depth.to(dev), seeds.to(dev)
    banks = {k: v.expand((MESH_B,) + v.shape).contiguous() for k, v in bank.items()}
    step = mesh.build_batched_track_step(cfg, m1)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    ms, per_step = [], []
    for _ in range(MESH_STEPS):
        before = read_launches()
        t = time.perf_counter()
        out = step(gray, depth, seeds, banks)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({k: v - before[k] for k, v in read_launches().items()})
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    med = statistics.median(ms[1:])
    worst_t = worst_r = 0.0
    for s in range(MESH_B):
        one = step(gray[s:s + 1], depth[s:s + 1], seeds[s:s + 1],
                   {k: v[s:s + 1] for k, v in banks.items()})
        dt_, dr_ = _pose_diff(out["T"][s].cpu().numpy(), one["T"][0].cpu().numpy())
        worst_t, worst_r = max(worst_t, dt_), max(worst_r, dr_)
        n_b, n_1 = int(out["n_inliers"][s]), int(one["n_inliers"][0])
        if n_b != n_1 or n_b < TRACK_MIN_INLIERS:
            raise RuntimeError(f"persist mesh: stream {s} has {n_b} inliers, {n_1} at B = 1 "
                               f"(the tracker accepts >= {TRACK_MIN_INLIERS})")
    log(f"persist mesh: make_mesh() = {m1.devices.size} device; build_batched_track_step at "
        f"B = {MESH_B}: median {med:.2f} ms per step (first {ms[0]:.0f} ms), "
        f"{MESH_B * 1e3 / med:.1f} frames/s, peak memory {peak:.1f} MiB, inliers per stream "
        f"{out['n_inliers'].tolist()}, matches {out['n_matches'].tolist()}; against B = 1: "
        f"max {worst_t:.3g} m, {worst_r:.3g} rad; launches per step {per_step[-1]}")
    if not (worst_t < POSE_TOL_M and worst_r < POSE_TOL_RAD):
        raise RuntimeError(f"persist mesh: B = {MESH_B} off B = 1 by {worst_t} m / {worst_r} rad")
    for i, n in enumerate(per_step):
        if {k: n[k] for k in launches_per_frame()} != launches_per_frame():
            raise RuntimeError(f"persist mesh: step {i} launched {n}, not once per kernel")
    rng = np.random.default_rng(5)
    base = rng.integers(-2**31, 2**31, (16, 8), dtype=np.int64).astype(np.int32)

    def draw(n):
        d = base[rng.integers(0, len(base), n)].copy()
        bit = rng.integers(0, 256, n)
        d[np.arange(n), bit // 32] ^= (np.int64(1) << (bit % 32)).astype(np.uint32).view(np.int32)
        return torch.from_numpy(d).to(dev)

    q, bankd = draw(ARGMIN_QUERIES), draw(ARGMIN_BANK)
    full = matching.hamming_matrix(q, bankd)
    best, arg = torch.min(full, dim=1)
    res = []
    for entries in (1, 4):
        idx_m, dist_m = mesh.sharded_hamming_argmin(q, bankd, mesh.make_mesh(devices=[dev] * entries))
        ok = torch.equal(idx_m.long(), arg) and torch.equal(dist_m.float(), best)
        res.append(f"{entries} entries {'equal' if ok else 'DIFFERENT'}")
        if not ok:
            raise RuntimeError(f"persist mesh: the sharded argmin over {entries} entries differs")
    ties = float((torch.sort(full, 1).values[:, :2].diff(dim=1) == 0).float().mean())
    log(f"persist mesh: sharded_hamming_argmin, {ARGMIN_QUERIES} queries against a "
        f"{ARGMIN_BANK}-entry bank ({ties:.2f} of queries with a tied best): {', '.join(res)} "
        f"to the single-bank argmin")
    return launches


def phase_persist(cfg, tmp: str, dev) -> tuple[dict, dict]:
    """Data sources, the runner, persistence with the viewer, the exact AHC
    merge and the mesh entries; returns the launch counts of the System
    runs (the single rows) and of the batched track step (the batched)."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "tum_walk")
    seq = SyntheticSequence(n_frames=N_PERSIST, cam=cfg.camera, view="walk")
    written = _write_tum(cfg, seq, root)
    t_write = time.perf_counter() - t0
    from manhattanslam_tpu_torch.datasets.tum import TumSequence, to_gray

    t = time.perf_counter()
    tum = TumSequence(root, os.path.join(root, "associations.txt"), cfg.depth_map_factor)
    frames, worst = [], 0.0
    for fr, (ts, rgb, depth) in zip(tum, written):
        if fr.timestamp != float(f"{ts:.6f}") or not np.array_equal(fr.rgb, rgb):
            raise RuntimeError("persist: a TUM frame's timestamp or RGB differs from what was written")
        worst = max(worst, float(np.abs(fr.depth - depth).max()))
        frames.append((fr.timestamp, to_gray(fr.rgb, cfg.camera.rgb), fr.depth))
    quantum = 1.0 / cfg.depth_map_factor
    log(f"persist: {N_PERSIST} walk frames written as a TUM sequence in {t_write:.1f} s and "
        f"read back in {time.perf_counter() - t:.1f} s: RGB equal, depth within {worst:.3g} m "
        f"(one quantum {quantum:.3g} m)")
    if not worst <= quantum:
        raise RuntimeError(f"persist: depth read back {worst} m off, over one quantum")
    t = time.perf_counter()
    runner = _persist_runner(cfg, seq, root, dev)
    log(f"persist: runner {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    reload = _persist_reload(cfg, seq, frames, root, dev)
    log(f"persist: save, load, relocalize and track on {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ahc = _persist_ahc(cfg, dev)
    log(f"persist: AHC {ahc}, {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    batched = _persist_mesh(cfg, seq, dev)
    log(f"persist: mesh {time.perf_counter() - t:.1f} s")
    launches = {k: runner[k] + reload[k] for k in runner}
    log(f"phase persist: {time.perf_counter() - t0:.1f} s")
    return launches, batched


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = load_config(os.path.join(HERE, "configs", "TUM1.yaml"))
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    smi = phase_build()
    seq = SyntheticSequence(n_frames=N_FRAMES, cam=cfg.camera)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    stats = phase_kernels(cfg, dev, frames)
    with tempfile.TemporaryDirectory() as tmp:
        chunk_launches, chunk1_launches, walk_launches = phase_chunk(tmp, smi)
        surfel_launches, surfel_corner_launches = phase_surfels(tmp, smi)
        modular_launches = phase_modular(tmp, smi)
        track_launches, track_ms = phase_track(cfg, seq, frames, tmp)
        corner_launches, near_launches = phase_planes(cfg, tmp)
        full_launches = phase_full(cfg, tmp)
        mapping_launches, system, walk = phase_mapping(cfg, tmp)
        reloc_launches = phase_reloc(cfg, system, walk)
        persist_launches, batched_launches = phase_persist(cfg, tmp, dev)
    replay_launches = phase_replay(cfg, dev, track_ms)
    launches = {"chunk": chunk_launches, "chunk1": chunk1_launches, "chunk_walk": walk_launches,
                "surfels": surfel_launches, "surfels_corner": surfel_corner_launches,
                "modular": modular_launches,
                "track": track_launches, "planes_corner": corner_launches,
                "planes_near_corner": near_launches, "full": full_launches,
                "mapping": mapping_launches, "reloc": reloc_launches,
                "persist": persist_launches, "replay": replay_launches,
                "batched_track": batched_launches}
    paths = {"chunk": ("chunk", "chunk1", "chunk_walk", "surfels", "surfels_corner", "modular",
                       "track", "planes_corner", "planes_near_corner", "full", "mapping",
                       "reloc", "persist"),
             "replay": ("replay", "batched_track")}
    rows = []
    for name, k in KERNELS.items():
        st = stats[name]
        rows.append({
            "name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": launches[k["path"]][k["wrapper"].__name__],
            "launches_by_path": {p: launches[p][k["wrapper"].__name__] for p in paths[k["path"]]},
            "max_abs_err": st["max_abs_err"], "ms": st["ms"], "device_ms": st["device_ms"],
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
