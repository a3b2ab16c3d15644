#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (manhattanslam_tpu_torch) on one CUDA card.

Usage: python3 chip_smoke.py   (from the root of a checkout; needs one GPU)

Phases, each printing one line with its elapsed seconds:

1. build   - compile the CUDA kernels in manhattanslam_tpu_torch/csrc (one
             nvcc per source, in parallel, into build/torch_kernels/) and
             print the card's name and power limit from nvidia-smi.
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
             (reported).
Every System phase runs the mapping back end and the relocalizer on each
keyframe (synchronously, inside track) and prints, besides its median
ms per frame, the largest and the back end's host ms per keyframe event
and stage.

3. track   - the points-only System over 30 synthetic 640x480 frames at the
             TUM1 camera (the orbit view), with every kernel's launch
             count set to 0 first: all frames tracked, ATE against the
             renderer's ground truth below 0.05 m, FAST, IC angle and BRIEF
             each launched once per frame.
4. planes  - System(TUM1, enable_planes=True) over 30 frames of two
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
5. full    - System(TUM1, enable_planes=True, enable_lines=True), the
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
6. replay  - the batched multi-sequence replay (BASELINE config 5) through
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
7. mapping - System(TUM1, enable_planes=True, enable_lines=True) over 120
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
8. reloc   - frames 120..199 of a 200-frame walk (tracked; a walk's
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
             16 point inliers on the mapped walk at 192x144.

Any failure raises and the script exits nonzero.  It writes only into a
temporary directory and the kernel build directory, and starts no thread.
The last two lines are the kernels JSON (one row per TPU kernel) and
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

from manhattanslam_tpu_torch.config import load_config
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu_torch.frontend import device_tracker as dt
from manhattanslam_tpu_torch.frontend import frame
from manhattanslam_tpu_torch.io import trajectory as traj_io
from manhattanslam_tpu_torch.ops import fast as fast_ops
from manhattanslam_tpu_torch.ops import image as image_ops
from manhattanslam_tpu_torch.ops import kernel_build
from manhattanslam_tpu_torch.ops import orb as orb_ops
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

# One row per TPU kernel (each function that reaches pl.pallas_call).  A
# single kernel and its batched twin are served by one CUDA kernel, one
# launch for all pyramid levels and streams; the single rows count
# launches on the track phase's path (and list the planes phase's two runs
# and the full phase's beside them), the batched rows on the replay's.
_FAST = "manhattanslam_tpu_torch/csrc/fast.cu"
_IC = "manhattanslam_tpu_torch/csrc/ic_angle.cu"
_BRIEF = "manhattanslam_tpu_torch/csrc/brief.cu"
KERNELS = {
    "fast_score": dict(
        source=_FAST, path="track", wrapper=fast_ops.fast_score_levels,
        replaces="manhattanslam_tpu/ops/fast_pallas.py:33 (_fast_kernel, pallas_call :79)",
    ),
    "ic_angle": dict(
        source=_IC, path="track", wrapper=orb_ops.ic_angle_levels,
        replaces="manhattanslam_tpu/ops/orb_pallas.py:235 (_make_moments_kernel, pallas_call :285)",
    ),
    "brief": dict(
        source=_BRIEF, path="track", wrapper=orb_ops.brief_levels,
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
}
WRAPPERS = (fast_ops.fast_score_levels, orb_ops.ic_angle_levels, orb_ops.brief_levels)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def read_launches() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


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
    log(f"phase build: {len(kernel_build.SIGNATURES)} kernels built, "
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
    per_frame = launches_per_frame()
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
    """Each kernel launched once per frame of the n frames (so at least
    once on the path)."""
    for k, c in launches.items():
        if c != n * launches_per_frame()[k]:
            raise RuntimeError(f"{name}: kernel {k} launched {c} times in {n} frames, not "
                               f"{launches_per_frame()[k]} per frame")


def _run_system(cfg, seq, frames, tmp: str, enable_planes: bool, name: str,
                enable_lines: bool = False) -> dict:
    """System(cfg, enable_planes, enable_lines) over the frames with the
    launch counts set to 0 first: every frame tracked, ATE below ATE_LIMIT
    and each kernel launched once per frame.  Returns the launch counts,
    median ms per frame and, with planes, per-frame plane and Manhattan
    counts, with lines per-frame line counts and the map lines."""
    t0 = time.perf_counter()
    system = System(cfg, enable_planes=enable_planes, enable_lines=enable_lines)  # CUDA
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


def backend_report(system) -> str:
    """The back end's host ms per keyframe event, in all and by stage, and
    its counts."""
    lm = system.local_mapper
    n = max(lm.counts["events"], 1)
    stages = {k: round(v * 1e3 / n, 3) for k, v in lm.perf.items()}
    total = sum(system.kf_perf.values()) * 1e3 / n
    return (f"back end {total:.2f} ms per keyframe event over {lm.counts['events']} events "
            f"(LocalMapper by stage {stages}, relocalization index "
            f"{system.kf_perf['reloc_add'] * 1e3 / n:.3f} ms); "
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
        for name, n in step_launches[i].items():
            if n != per_step[name]:
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
    system = System(cfg, enable_planes=True, enable_lines=True)  # CUDA
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
    _check_launches("reloc", launches, n)
    log(f"phase reloc: {time.perf_counter() - t0:.1f} s")
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
    seq = SyntheticSequence(n_frames=N_FRAMES, cam=cfg.camera)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    stats = phase_kernels(cfg, dev, frames)
    with tempfile.TemporaryDirectory() as tmp:
        track_launches, track_ms = phase_track(cfg, seq, frames, tmp)
        corner_launches, near_launches = phase_planes(cfg, tmp)
        full_launches = phase_full(cfg, tmp)
        mapping_launches, system, walk = phase_mapping(cfg, tmp)
        reloc_launches = phase_reloc(cfg, system, walk)
    replay_launches = phase_replay(cfg, dev, track_ms)
    launches = {"track": track_launches, "planes_corner": corner_launches,
                "planes_near_corner": near_launches, "full": full_launches,
                "mapping": mapping_launches, "reloc": reloc_launches,
                "replay": replay_launches}
    paths = {"track": ("track", "planes_corner", "planes_near_corner", "full", "mapping",
                       "reloc"),
             "replay": ("replay",)}
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
