"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: CUDA kernels have no CPU mode, so without a GPU these
tests skip.  This file imports neither JAX nor the reference package, so
it also runs on a machine with a GPU and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from manhattanslam_tpu_torch.config import (
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig, load_config,
)
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu_torch.frontend import device_tracker as dt
from manhattanslam_tpu_torch.frontend import frame
from manhattanslam_tpu_torch.io import trajectory as traj_io
from manhattanslam_tpu_torch.ops import fast, image, kernel_build, lines, lm, orb, planes, surfels
from manhattanslam_tpu_torch.parallel import mesh, replay
from manhattanslam_tpu_torch.system import System

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _image(h, w, seed, integer=True):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w)) if integer else rng.uniform(0, 255, (h, w))
    return torch.from_numpy(img.astype(np.float32))


def _keypoints(h, w, n, seed):
    rng = np.random.default_rng(seed)
    b = orb.EDGE_THRESHOLD
    xy = np.stack([rng.uniform(b, w - b - 1, n), rng.uniform(b, h - b - 1, n)], -1)
    return torch.from_numpy(np.round(xy).astype(np.float32))


@pytest.mark.parametrize("hw", [(480, 640), (134, 179), (70, 128), (41, 45)])
def test_fast_kernel_equals_plain(cuda, hw):
    img = _image(*hw, seed=hw[0], integer=False).to(cuda)
    before = fast.fast_score_levels.launches
    out = fast.fast_score_map(img)
    torch.cuda.synchronize()
    assert fast.fast_score_levels.launches == before + 1
    assert torch.equal(out, fast.fast_score_map_plain(img))


@pytest.mark.parametrize("hw,n", [((480, 640), 217), ((134, 179), 60), ((40, 54), 7)])
def test_ic_angle_kernel_within_tolerance(cuda, hw, n):
    img = _image(*hw, seed=n).to(cuda)
    xy = _keypoints(*hw, n, seed=n).to(cuda)
    out = orb.ic_angle(img, xy)
    ref = orb.ic_angle_plain(img, xy)
    d = torch.remainder(out - ref + math.pi, 2 * math.pi) - math.pi
    assert float(d.abs().max()) < 1e-4


def _blurred_brief(img, xy, angle):
    """BRIEF's plain composition: the integer-rounded blur of the raw
    image, then the steered samples."""
    return orb.brief_descriptors_plain(torch.round(image.gaussian_blur(img, 7, 2.0)), xy, angle)


@pytest.mark.parametrize("hw,n", [((480, 640), 217), ((134, 179), 60), ((40, 54), 7)])
def test_brief_kernel_bit_exact(cuda, hw, n):
    """One level (the blur inside the kernel) against the plain
    composition, on a raw image with fractional intensities."""
    img = _image(*hw, seed=hw[1], integer=False).to(cuda)
    xy = _keypoints(*hw, n, seed=n + 1).to(cuda)
    angle = torch.from_numpy(
        np.random.default_rng(n).uniform(-math.pi, math.pi, n).astype(np.float32)
    ).to(cuda)
    before = orb.brief_levels.launches
    out = orb.brief_level(img, xy, angle)
    torch.cuda.synchronize()
    assert orb.brief_levels.launches == before + 1
    assert torch.equal(out, _blurred_brief(img, xy, angle))


def test_wrapper_checks_inputs(cuda):
    with pytest.raises(ValueError):
        fast.fast_score_map(torch.zeros((8, 8), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        orb.ic_angle(torch.zeros((64, 64), device=cuda), torch.zeros((3, 3), device=cuda))


def _launches():
    return fast.fast_score_levels.launches, orb.ic_angle_levels.launches, orb.brief_levels.launches


def _small_cfg():
    return SlamConfig(
        camera=CameraConfig(fx=160.0, fy=160.0, cx=95.5, cy=71.5, k1=0, k2=0, p1=0, p2=0, k3=0,
                            width=192, height=144, bf=12.0),
        orb=OrbConfig(n_features=250),
        caps=CapacityConfig(max_keypoints=256, max_lines=32, max_map_points=8192,
                            max_map_lines=512, max_keyframes=64),
    )


def _batched_inputs(kind, b, hw, n, seed):
    """A kernel's wrapper inputs for b streams, the wrapper, its plain
    version and the wrapper that counts the launch."""
    imgs = torch.stack([_image(*hw, seed=seed + i, integer=kind == "ic_angle") for i in range(b)])
    if kind == "fast":
        return (imgs,), fast.fast_score_map, fast.fast_score_map_plain, fast.fast_score_levels
    xy = torch.stack([_keypoints(*hw, n, seed=seed + 10 + i) for i in range(b)])
    if kind == "ic_angle":
        return (imgs, xy), orb.ic_angle, orb.ic_angle_plain, orb.ic_angle_levels
    angle = torch.from_numpy(
        np.random.default_rng(seed).uniform(-math.pi, math.pi, (b, n)).astype(np.float32))
    return (imgs, xy, angle), orb.brief_level, _blurred_brief, orb.brief_levels


@pytest.mark.parametrize("kind", ["fast", "ic_angle", "brief"])
@pytest.mark.parametrize("hw,n", [((480, 640), 217), ((134, 179), 60)])
def test_batched_kernel_equals_plain_and_single_launches(cuda, kind, hw, n):
    """One launch for 3 streams: equal to the plain version (IC angle within
    1e-4 rad) and to 3 single launches."""
    args, wrapper, plain, counted = _batched_inputs(kind, 3, hw, n, seed=hw[0] + n)
    args = tuple(a.to(cuda) for a in args)
    before = counted.launches
    out = wrapper(*args)
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    ref = plain(*args)
    if kind == "ic_angle":
        d = torch.remainder(out - ref + math.pi, 2 * math.pi) - math.pi
        assert float(d.abs().max()) < 1e-4
    else:
        assert torch.equal(out, ref)
    for i in range(3):
        assert torch.equal(out[i], wrapper(*(a[i] for a in args))), i


TUM1_SHAPES = image.pyramid_shapes(480, 640, 8, 1.2)
TUM1_BUDGETS = OrbConfig(n_features=1000).features_per_level()


def _stacks(b, seed, integer):
    """b images at each of TUM1's 8 pyramid level shapes: (b, h, w) each."""
    return [torch.stack([_image(*hw, seed=seed + 100 * li + i, integer=integer) for i in range(b)])
            for li, hw in enumerate(TUM1_SHAPES)]


@pytest.mark.parametrize("b", [1, 8])
def test_fast_levels_launch_equals_plain_and_other_launches(cuda, b):
    """One launch over TUM1's 8 level shapes: equal to the plain version at
    every level, to one launch per level and to b single-image launches,
    and each level a contiguous view of one level-major buffer."""
    levels = [lv.to(cuda) for lv in _stacks(b, seed=b, integer=False)]
    before = fast.fast_score_levels.launches
    scores = fast.fast_score_levels(levels)
    torch.cuda.synchronize()
    assert fast.fast_score_levels.launches == before + 1
    base = scores[0].data_ptr()
    offset = 0
    for li, (lv, sc) in enumerate(zip(levels, scores)):
        assert sc.shape == lv.shape and sc.is_contiguous(), li
        assert sc.data_ptr() == base + 4 * offset, li
        offset += lv.numel()
        assert torch.equal(sc, fast.fast_score_map_plain(lv)), li
        assert torch.equal(sc, fast.fast_score_map(lv)), li
    for i in range(b if b > 1 else 0):
        for li, (sc, single) in enumerate(zip(scores, fast.fast_score_levels([lv[i] for lv in levels]))):
            assert torch.equal(sc[i], single), (i, li)


@pytest.mark.parametrize("b", [1, 3])
def test_ic_levels_launch_within_tolerance_and_bitwise_across_launch_shapes(cuda, b):
    """One launch for every level's keypoints (level-major): within 1e-4
    rad of the plain version, and bitwise equal to one launch per level,
    to a launch over a subset of the levels and to single-image launches."""
    levels = [lv.to(cuda) for lv in _stacks(b, seed=7 * b, integer=True)]
    xys = [torch.stack([_keypoints(*hw, n, seed=li * 10 + i) for i in range(b)]).to(cuda)
           for li, (hw, n) in enumerate(zip(TUM1_SHAPES, TUM1_BUDGETS))]
    xy_flat = torch.cat([xy.reshape(-1, 2) for xy in xys])
    before = orb.ic_angle_levels.launches
    ang = orb.ic_angle_levels(levels, xy_flat, TUM1_BUDGETS)
    torch.cuda.synchronize()
    assert orb.ic_angle_levels.launches == before + 1
    d = orb.ic_angle_levels_plain(levels, xy_flat, TUM1_BUDGETS) - ang
    assert float((torch.remainder(d + math.pi, 2 * math.pi) - math.pi).abs().max()) < 1e-4
    views = orb.level_keypoint_views(ang, TUM1_BUDGETS, (b,))
    for li, (lv, xy, v) in enumerate(zip(levels, xys, views)):
        assert torch.equal(v, orb.ic_angle(lv, xy)), li
    sub = slice(2, 6)
    part = orb.ic_angle_levels(levels[sub], torch.cat([xy.reshape(-1, 2) for xy in xys[sub]]),
                               TUM1_BUDGETS[sub])
    assert torch.equal(part, torch.cat([v.reshape(-1) for v in views[sub]]))
    for i in range(b if b > 1 else 0):
        single = orb.ic_angle_levels([lv[i] for lv in levels], torch.cat([xy[i] for xy in xys]),
                                     TUM1_BUDGETS)
        assert torch.equal(single, torch.cat([v[i] for v in views])), i


def _brief_keypoints(hw, n, seed):
    """n keypoints of one image for BRIEF: rounded interior points, then a
    sub-pixel one, the image's corners and (0, 0) padding slots, as the
    extractor's invalid slots are."""
    h, w = hw
    xy = _keypoints(h, w, n, seed)
    edge = torch.tensor([[w / 2 + 0.37, h / 2 - 0.61], [0, 0], [w - 1, 0], [0, h - 1],
                         [w - 1, h - 1], [0, 0], [0, 0]], dtype=torch.float32)
    m = min(n, len(edge))
    xy[n - m:] = edge[:m]
    return xy


@pytest.mark.parametrize("b", [1, 8])
def test_brief_levels_launch_bit_exact_and_bitwise_across_launch_shapes(cuda, b):
    """One launch for every level's keypoints at TUM1's 8 level shapes
    (raw levels with fractional intensities, padding slots at (0, 0) and
    keypoints on the border): equal to the plain version at every keypoint,
    to one launch per level, to a launch over a subset of the levels, to
    b single-image launches and to the kernel's other thread layout (a
    warp or a block per keypoint)."""
    levels = [lv.to(cuda) for lv in _stacks(b, seed=11 * b, integer=False)]
    xys = [torch.stack([_brief_keypoints(hw, n, seed=li * 10 + i) for i in range(b)]).to(cuda)
           for li, (hw, n) in enumerate(zip(TUM1_SHAPES, TUM1_BUDGETS))]
    xy_flat = torch.cat([xy.reshape(-1, 2) for xy in xys])
    ang = torch.from_numpy(np.random.default_rng(b).uniform(
        -math.pi, math.pi, xy_flat.shape[0]).astype(np.float32)).to(cuda)
    before = orb.brief_levels.launches
    words = orb.brief_levels(levels, xy_flat, ang, TUM1_BUDGETS)
    torch.cuda.synchronize()
    assert orb.brief_levels.launches == before + 1
    assert words.shape == (xy_flat.shape[0], 8) and words.dtype == torch.int32
    assert torch.equal(words, orb.brief_levels_plain(levels, xy_flat, ang, TUM1_BUDGETS))
    views = orb.level_keypoint_views(words, TUM1_BUDGETS, (b,))
    angles = orb.level_keypoint_views(ang, TUM1_BUDGETS, (b,))
    for li, (lv, xy, a, v) in enumerate(zip(levels, xys, angles, views)):
        assert torch.equal(v, orb.brief_level(lv, xy, a)), li
    sub = slice(3, 7)
    part = orb.brief_levels(levels[sub], torch.cat([xy.reshape(-1, 2) for xy in xys[sub]]),
                            torch.cat([a.reshape(-1) for a in angles[sub]]), TUM1_BUDGETS[sub])
    assert torch.equal(part, torch.cat([v.reshape(-1, 8) for v in views[sub]]))
    for i in range(b if b > 1 else 0):
        single = orb.brief_levels([lv[i] for lv in levels], torch.cat([xy[i] for xy in xys]),
                                  torch.cat([a[i] for a in angles]), TUM1_BUDGETS)
        assert torch.equal(single, torch.cat([v[i] for v in views])), i
    other = torch.empty_like(words)
    threads = 32 if orb.brief_threads(b) == 128 else 128
    ca, sa = torch.cos(ang), torch.sin(ang)
    err = kernel_build.kernel("brief")(
        *orb.brief_kernel_args(levels, TUM1_BUDGETS, threads=threads), xy_flat.data_ptr(),
        ca.data_ptr(), sa.data_ptr(), orb.device_constant("PATTERN", cuda).data_ptr(),
        other.data_ptr(), torch.cuda.current_stream(cuda).cuda_stream)
    kernel_build.check_launch("brief", err)
    assert torch.equal(other, words)


def test_level_wrappers_check_inputs(cuda):
    imgs = [torch.zeros((2, 64, 64), device=cuda), torch.zeros((3, 50, 50), device=cuda)]
    with pytest.raises(ValueError):  # two leading shapes
        fast.fast_score_levels(imgs)
    with pytest.raises(ValueError):  # more levels than the table holds
        fast.fast_score_levels([imgs[0]] * 9)
    with pytest.raises(ValueError):  # keypoints of another count than the budgets
        orb.ic_angle_levels([imgs[0]], torch.zeros((5, 2), device=cuda), [3])
    xy, ang = torch.zeros((6, 2), device=cuda), torch.zeros(6, device=cuda)
    with pytest.raises(ValueError):  # two leading shapes
        orb.brief_levels(imgs, torch.zeros((12, 2), device=cuda), torch.zeros(12, device=cuda),
                         [3, 2])
    with pytest.raises(ValueError):  # more levels than the table holds
        orb.brief_levels([imgs[0]] * 9, torch.zeros((54, 2), device=cuda),
                         torch.zeros(54, device=cuda), [3] * 9)
    with pytest.raises(ValueError):  # keypoints of another count than the budgets
        orb.brief_levels([imgs[0]], xy, ang, [2])
    with pytest.raises(ValueError):  # angles of another count than the keypoints
        orb.brief_levels([imgs[0]], xy, ang[:5], [3])
    with pytest.raises(ValueError):  # float64 angles
        orb.brief_levels([imgs[0]], xy, ang.double(), [3])
    with pytest.raises(ValueError):  # an image too small for the blur's border
        orb.brief_levels([torch.zeros((3, 64), device=cuda)], xy[:3], ang[:3], [3])
    with pytest.raises(ValueError):  # keypoints on the CPU
        orb.brief_levels([imgs[0]], xy.cpu(), ang, [3])


@pytest.mark.parametrize("b", [1, 2])
def test_extractor_launches_fast_and_ic_angle_once_per_frame(cuda, b):
    """The extractor on the card at small_cfg size (its coarsest level is
    too small for the patch window and drops out of the level tables):
    FAST, IC angle and BRIEF each launched once per frame or batched step,
    and the features those of one level at a time."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=3, cam=cfg.camera)
    gray = torch.stack([torch.from_numpy(seq.frame(i)[1]).round() for i in range(b)]).to(cuda)
    depth = torch.stack([torch.from_numpy(seq.frame(i)[2]) for i in range(b)]).to(cuda)
    active = frame.active_levels(cfg)
    assert len(active) < cfg.orb.n_levels
    extract = frame.build_extractor(cfg, cuda)
    before = _launches()
    feats = extract(gray, depth)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_launches(), before)] == [1, 1, 1]
    ops = image.pyramid_operators(cfg.camera.height, cfg.camera.width, cfg.orb.n_levels,
                                  cfg.orb.scale_factor, cuda)
    levels = image.build_pyramid(gray, ops)
    budgets = cfg.orb.features_per_level()
    start = 0
    for li, n in enumerate(budgets):
        one = frame._extract_level(levels[li], n, cfg)
        for k in ("response", "valid", "angle", "desc"):
            assert torch.equal(feats[k][:, start:start + n], one[k]), (li, k)
        start += n


def test_replay_step_matches_single_stream_step(cuda):
    """The batched replay (the full body) on the card, 3 streams at
    different frame offsets against the shared view of keyframe 0: each
    stream's pose within 1e-3 m and 1e-3 rad of the single-stream step on
    the same frame and carry,
    every stream tracked, FAST, IC angle and BRIEF each launched once per
    step whatever the number of streams."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=30, cam=cfg.camera)
    first = [1, 4, 8]
    frames = [seq.frame(i) for i in range(max(first) + 3)]
    view, _ = replay.shared_view(cfg, frames[0], cuda)
    native = [dt.to_native(g, d) for _, g, d in frames]
    step = mesh.build_throughput_step(cfg, len(first), cuda)
    single = dt.build_frame_step(cfg, cuda, enable_planes=True, enable_lines=True)
    carry = replay.start_carry(cfg, seq, first, cuda)
    for i in range(3):
        g8, d16 = replay.step_frames(native, first, i, cuda)
        before = _launches()
        out, new_carry = step(g8, d16, carry, view)
        assert [a - b for a, b in zip(_launches(), before)] == [1, 1, 1]
        assert bool(out["tracked_ok"].all()), i
        for s in range(len(first)):
            res, _ = single(g8[s], d16[s], {k: v[s] for k, v in carry.items()}, view)
            d = torch.linalg.inv(res["T"].double()) @ out["T"][s].double()
            assert float(torch.linalg.norm(d[:3, 3])) < 1e-3, (i, s)
            w = torch.stack([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
            angle = math.atan2(float(torch.linalg.norm(w)) / 2, (float(torch.trace(d[:3, :3])) - 1) / 2)
            assert angle < 1e-3, (i, s)
            assert bool(res["tracked_ok"]) == bool(out["tracked_ok"][s])
        carry = new_carry


def test_system_on_cuda_matches_cpu(cuda):
    """The 12 box-room frames of the CPU parity test (tests/test_torch_tracker.py)
    through the System on the card and on the CPU: all frames tracked, the
    card's trajectory within the repo's e2e ATE bound, and the two
    trajectories within 1 cm RMS of each other.  Not closer: the predicted
    scale level ceil(log(maxDist/dist) / log(1.2)) sits on an integer for a
    point seen from its creation distance, so one ulp of log moves a point
    to another level and window; on the CPU alone, taking that log in
    float64 instead of float32 moves frame 1 by 7.3 mm."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=12, cam=cfg.camera)
    gpu = System(cfg, fast=True, enable_planes=False, enable_lines=False, enable_surfels=False)
    cpu = System(cfg, fast=True, enable_planes=False, enable_lines=False, enable_surfels=False,
                 device="cpu")
    for i in range(12):
        ts, gray, depth = seq.frame(i)
        a, b = gpu.track(gray, depth, ts), cpu.track(gray, depth, ts)
        assert a is not None and b is not None, f"frame {i}"
    pos_gpu = np.array([r[1] for r in gpu.tracker.trajectory_rows()])
    pos_cpu = np.array([r[1] for r in cpu.tracker.trajectory_rows()])
    gt = seq.gt_rows()
    ts_all = np.array([r[0] for r in gt])
    assert traj_io.ate_rmse((ts_all, pos_gpu), (ts_all, np.array([r[1] for r in gt]))) < 0.05
    assert np.sqrt(((pos_gpu - pos_cpu) ** 2).sum(1).mean()) < 1e-2


def _view_depths(cfg, view, frames):
    seq = SyntheticSequence(n_frames=30, cam=cfg.camera, view=view)
    d16 = [dt.to_native(*seq.frame(i)[1:])[1].astype(np.int32) for i in frames]
    return torch.from_numpy(np.stack(d16)).to(torch.float32) * float(np.float32(1 / dt.DEPTH_QUANT))


def test_plane_extraction_on_card_matches_cpu(cuda):
    """The plane extraction of three 640x480 frames of the corner view
    (one plane: floor and walls joined) and three of the near_corner view
    (three planes) at TUM1, in one call for the six streams, on the card
    against the CPU: the hash priorities equal; valid, n_pts equal;
    normals within 1e-4; a plane with the same pixels on both within 1e-4
    m RMS over them, another one's d within 1e-4 of |d|; membership equal
    on 99% of the plane pixels (the fits' float32 sums run in another
    order on the card)."""
    cfg = load_config(str(Path(__file__).resolve().parent.parent / "configs" / "TUM1.yaml"))
    depth = torch.cat([_view_depths(cfg, "corner", (0, 10, 20)),
                       _view_depths(cfg, "near_corner", (0, 10, 20))])
    K = torch.from_numpy(cfg.camera.K)
    h2, w2 = cfg.camera.height // 2, cfg.camera.width // 2
    args = (8, 512, (h2 // 10, w2 // 10), float(np.float32(0.04 * h2 * w2)), 0.04)
    assert torch.equal(planes.hash_priorities(h2 * w2, cuda).cpu(),
                       planes.hash_priorities(h2 * w2, torch.device("cpu")))
    gpu = planes.extract_planes_device(depth.to(cuda), K.to(cuda), *args)
    cpu = planes.extract_planes_device(depth, K, *args)
    gpu = {k: v.cpu() for k, v in gpu.items()}
    assert torch.equal(gpu["valid"], cpu["valid"])
    assert cpu["valid"].sum(-1).tolist() == [1, 1, 1, 3, 3, 3]
    assert torch.equal(gpu["n_pts"], cpu["n_pts"])
    v = cpu["valid"]
    assert float((gpu["coeffs"][v][:, :3] - cpu["coeffs"][v][:, :3]).abs().max()) <= 1e-4
    pts = planes.depth_to_points(depth, K).reshape(6, -1, 3)
    for b, j in v.nonzero().tolist():
        on = (cpu["membership"][b] == j).reshape(-1)
        if (int(gpu["n_support"][b, j]) == int(cpu["n_support"][b, j])
                and torch.equal((gpu["membership"][b] == j).reshape(-1), on)):
            gap = pts[b][on] @ (gpu["coeffs"][b, j, :3] - cpu["coeffs"][b, j, :3]) + (
                gpu["coeffs"][b, j, 3] - cpu["coeffs"][b, j, 3])
            assert float(gap.square().mean().sqrt()) <= 1e-4, (b, j)
        else:
            d = float(cpu["coeffs"][b, j, 3])
            assert abs(float(gpu["coeffs"][b, j, 3]) - d) <= 1e-4 * abs(d), (b, j)
    member = (gpu["membership"] >= 0) | (cpu["membership"] >= 0)
    assert float((gpu["membership"] == cpu["membership"])[member].float().mean()) >= 0.99


def test_system_with_planes_on_cuda_matches_cpu(cuda):
    """The fused step with the plane branch: 12 corner frames at small_cfg
    size through System(enable_planes=True) on the card and on the CPU,
    all tracked, the Manhattan pose used on the same frames, the two
    trajectories within the 1 cm RMS of test_system_on_cuda_matches_cpu
    (the same scale-level knife edge)."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=12, cam=cfg.camera, view="corner")
    gpu = System(cfg, fast=True, enable_planes=True, enable_lines=False, enable_surfels=False)
    cpu = System(cfg, fast=True, enable_planes=True, enable_lines=False, enable_surfels=False,
                 device="cpu")
    for i in range(12):
        ts, gray, depth = seq.frame(i)
        a, b = gpu.track(gray, depth, ts), cpu.track(gray, depth, ts)
        assert a is not None and b is not None, f"frame {i}"
    assert gpu.trace.counters["manhattan_frames"] == cpu.trace.counters["manhattan_frames"] >= 1
    assert gpu.map.manhattan_pairs == cpu.map.manhattan_pairs
    pos_gpu = np.array([r[1] for r in gpu.tracker.trajectory_rows()])
    pos_cpu = np.array([r[1] for r in cpu.tracker.trajectory_rows()])
    assert np.sqrt(((pos_gpu - pos_cpu) ** 2).sum(1).mean()) < 1e-2


def _u8_frames(cfg, view, idx):
    seq = SyntheticSequence(n_frames=30, cam=cfg.camera, view=view)
    native = [dt.to_native(*seq.frame(i)[1:]) for i in idx]
    gray = torch.from_numpy(np.stack([g for g, _ in native]).astype(np.float32))
    d16 = torch.from_numpy(np.stack([d for _, d in native]).astype(np.int32))
    return gray, d16.to(torch.float32) * float(np.float32(1 / dt.DEPTH_QUANT))


def test_line_detection_and_lifting_on_card_match_cpu(cuda):
    """detect_lines (the half-resolution branch) and lift_lines_3d on two
    640x480 frames each of the wall and near_corner views at TUM1, the
    four in one call, on the card against the CPU.  Detection: each
    frame's valid lines agree on at least 90% of them, and a line valid on
    both with the same support has its endpoints within 0.05 px as an
    unordered pair.  Not all equal: the card's atan2, cos and sin differ
    from the CPU's by ulps, which can move an edge pixel whose angle or
    rho sits on a bin boundary to the next bin, and the refit's float32
    sums run in another order (atomics).  Lifting on the CPU's segments:
    ok and n_inliers equal, endpoints within 1e-4 m."""
    cfg = load_config(str(Path(__file__).resolve().parent.parent / "configs" / "TUM1.yaml"))
    gw, dw = _u8_frames(cfg, "wall", (0, 10))
    gn, dn = _u8_frames(cfg, "near_corner", (0, 10))
    gray, depth = torch.cat([gw, gn]), torch.cat([dw, dn])
    L = cfg.caps.max_lines
    cpu = lines.detect_lines(gray, L)
    gpu = {k: v.cpu() for k, v in lines.detect_lines(gray.to(cuda), L).items()}
    for b in range(4):
        vc, vg = cpu["valid"][b], gpu["valid"][b]
        assert int(vc.sum()) >= 10, b
        assert float((vc == vg)[vc | vg].float().mean()) >= 0.9, b
        same = vc & vg & (cpu["response"][b] == gpu["response"][b])
        assert int(same.sum()) >= 0.8 * int(vc.sum()), b
        a = torch.stack([cpu["sp"][b], cpu["ep"][b]], 1)[same]
        g = torch.stack([gpu["sp"][b], gpu["ep"][b]], 1)[same]
        err = torch.minimum((a - g).abs().amax((1, 2)), (a - g.flip(1)).abs().amax((1, 2)))
        assert float(err.max()) < 0.05, (b, err)
    K = torch.from_numpy(cfg.camera.K)
    lc = lines.lift_lines_3d(depth, K, cpu["sp"], cpu["ep"], cpu["valid"])
    lg = {k: v.cpu() for k, v in lines.lift_lines_3d(
        depth.to(cuda), K.to(cuda), cpu["sp"].to(cuda), cpu["ep"].to(cuda),
        cpu["valid"].to(cuda)).items()}
    assert torch.equal(lc["ok"], lg["ok"]) and int(lc["ok"].sum()) >= 20
    assert torch.equal(lc["n_inliers"], lg["n_inliers"])
    ok = lc["ok"]
    for k in ("sp3", "ep3"):
        assert float((lc[k][ok] - lg[k][ok]).abs().max()) < 1e-4, k


def test_system_with_lines_on_cuda_matches_cpu(cuda):
    """The full body (planes and lines) through System on the card and on
    the CPU, 8 near_corner frames at small_cfg size: all tracked, map
    lines on both, and the two trajectories within the 1 cm RMS of
    test_system_on_cuda_matches_cpu (the same scale-level knife edge)."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=12, cam=cfg.camera, view="near_corner")
    gpu = System(cfg, fast=True, enable_planes=True, enable_lines=True, enable_surfels=False)
    cpu = System(cfg, fast=True, enable_planes=True, enable_lines=True, enable_surfels=False,
                 device="cpu")
    for i in range(8):
        ts, gray, depth = seq.frame(i)
        a, b = gpu.track(gray, depth, ts), cpu.track(gray, depth, ts)
        assert a is not None and b is not None, f"frame {i}"
    assert int(gpu.map.ml_valid.sum()) >= 3 and int(cpu.map.ml_valid.sum()) >= 3
    assert int((gpu.tracker.last_result["line_assoc"] >= 0).sum()) >= 1
    pos_gpu = np.array([r[1] for r in gpu.tracker.trajectory_rows()])
    pos_cpu = np.array([r[1] for r in cpu.tracker.trajectory_rows()])
    assert np.sqrt(((pos_gpu - pos_cpu) ** 2).sum(1).mean()) < 1e-2


def test_corridor_full_system_holds_the_reference_bars(cuda):
    """The corridor e2e milestone (tests/test_lowtexture_e2e.py:88-107) on
    the card: System with planes and lines, the mapping back end and the
    relocalizer, 30 frames of the blank-walled corridor at small_cfg size:
    no frame lost, no reset, the trajectory covering > 90% of the frames
    with ATE below 0.05 m, and the Manhattan translation path carrying at
    least half of the tracked frames."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=30, cam=cfg.camera, view="corridor")
    system = System(cfg, fast=True, enable_planes=True, enable_lines=True, enable_surfels=False)
    n_lost = 0
    for i in range(30):
        ts, gray, depth = seq.frame(i)
        n_lost += system.track(gray, depth, ts) is None
    assert n_lost == 0 and system.n_resets == 0
    est = system.tracker.trajectory_rows()
    assert len(est) / 30 > 0.9
    gt = seq.gt_rows()
    ate = traj_io.ate_rmse((np.array([r[0] for r in est]), np.stack([r[1] for r in est])),
                           (np.array([r[0] for r in gt]), np.stack([r[1] for r in gt])))
    assert ate < 0.05
    tr = system.tracker
    assert system.trace.counters["manhattan_frames"] / max(tr.n_ok_frames, 1) >= 0.5


def test_system_with_back_end_on_cuda_matches_cpu(cuda):
    """System (points only; the back end and the relocalizer on every
    keyframe) on the card and on the CPU over 12 "walk" frames, where the
    second keyframe's event triangulates against the first: the same
    keyframes, the back end run on each, and the two trajectories within
    the 1 cm RMS of test_system_on_cuda_matches_cpu."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=12, cam=cfg.camera, view="walk")
    gpu = System(cfg, fast=True, enable_planes=False, enable_lines=False, enable_surfels=False)
    cpu = System(cfg, fast=True, enable_planes=False, enable_lines=False, enable_surfels=False,
                 device="cpu")
    for i in range(12):
        ts, gray, depth = seq.frame(i)
        a, b = gpu.track(gray, depth, ts), cpu.track(gray, depth, ts)
        assert a is not None and b is not None, f"frame {i}"
    assert gpu.map.n_kf == cpu.map.n_kf >= 2
    np.testing.assert_array_equal(gpu.map.kf_frame_id, cpu.map.kf_frame_id)
    assert gpu.local_mapper.counts["events"] == gpu.map.n_kf
    pos_gpu = np.array([r[1] for r in gpu.tracker.trajectory_rows()])
    pos_cpu = np.array([r[1] for r in cpu.tracker.trajectory_rows()])
    assert np.sqrt(((pos_gpu - pos_cpu) ** 2).sum(1).mean()) < 1e-2


def _native_cuda(frame, dev):
    g8, d16 = dt.to_native(*frame[1:])
    return torch.from_numpy(g8).to(dev), torch.from_numpy(d16.astype(np.int32)).to(dev)


def test_graphed_step_equals_eager_step(cuda):
    """The frame step replayed from its CUDA graph against the eager step,
    on the same frames, carry and view, bit for bit (the step is
    deterministic: tools/probe_determinism.py): after the capture, after a
    view update written in place, after a carry reset in place."""
    from manhattanslam_tpu_torch.frontend.graphed_step import clone_tree

    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=12, cam=cfg.camera, view="near_corner")
    system = System(cfg, fast=True, enable_surfels=False)  # planes and lines on, chunk 1
    for i in range(3):
        ts, gray, depth = seq.frame(i)
        assert system.track(gray, depth, ts) is not None
    tr = system.tracker
    assert tr.step.graph is not None
    eager = dt.build_frame_step(cfg, cuda, True, True)

    def same(i):
        carry = clone_tree(tr.carry)
        g8, d16 = _native_cuda(seq.frame(i), cuda)
        res_e, carry_e = eager(g8, d16, carry, tr.view)
        res_g, carry_g = tr.step(g8, d16, carry, tr.view)
        for k in ("summary_flat", "payload_flat"):
            assert torch.equal(res_e[k], res_g[k]), (i, k)
        for k in carry_e:
            assert torch.equal(carry_e[k], carry_g[k]), (i, k)
        return bool(res_g["tracked_ok"])

    assert same(3)
    rng = np.random.default_rng(0)
    m = tr.map
    m.add_points(rng.uniform(-1, 1, (32, 3)).astype(np.float32) + np.float32([0, 0, 2]),
                 rng.integers(0, 2**32, (32, 8), dtype=np.uint64).astype(np.uint32),
                 np.tile(np.float32([0, 0, -1]), (32, 1)), np.zeros(32, np.float32),
                 np.full(32, 9.0, np.float32), np.zeros(32, np.int32), 0)
    tr.refresh_view()
    assert same(4)
    dt.reset_carry_(tr.carry, cfg, tr.T_cw, vo_points=True)
    assert same(5)


def test_branch_times_sum_to_the_graph_and_leave_it_as_it_was(cuda):
    """GraphedStep.branch_times on the card (the full body at chunk 1):
    the six branches in order, their device ms within 3% of a replay of
    the production graph and their operations adding up to its nodes;
    the production graph replays after the timing capture as it did
    before it, bit for bit from the same carry."""
    from manhattanslam_tpu_torch.frontend.graphed_step import clone_tree, copy_tree_

    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=3, cam=cfg.camera, view="near_corner")
    system = System(cfg, fast=True, enable_surfels=False)
    for i in range(3):
        ts, gray, depth = seq.frame(i)
        assert system.track(gray, depth, ts) is not None
    step = system.tracker.step
    assert step.graph is not None and step.nodes > 0
    carry0 = clone_tree(step.carry)

    def replay():
        copy_tree_(step.carry, carry0)
        step.graph.replay()
        torch.cuda.synchronize()
        return clone_tree(step._out), clone_tree(step.carry)

    def graph_ms(n=20):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            step.graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    before = replay()
    ms = graph_ms()
    times = step.branch_times(system.tracker.view, reps=20)
    ms = (ms + graph_ms()) / 2
    assert list(times) == ["extract", "candidate_solves", "planes", "manhattan_solve", "lines",
                           "final_solve"]
    assert all(t["ms"] > 0 and t["ops"] > 0 for t in times.values()), times
    assert abs(sum(t["ms"] for t in times.values()) - ms) <= 0.03 * ms, (times, ms)
    assert sum(t["ops"] for t in times.values()) == step.nodes
    after = replay()
    for a, b in zip(before, after):
        for k in a:
            if isinstance(a[k], dict):
                assert all(torch.equal(a[k][j], b[k][j]) for j in a[k]), k
            else:
                assert torch.equal(a[k], b[k]), k


def test_chunked_pipelined_system_on_cuda_matches_cpu(cuda):
    """bench.py's dispatch form, System(pipeline=True, chunk=4) with planes
    and lines, on the card and on the CPU over the 13 corner frames of
    tests/test_torch_chunked.py: every frame recorded, and the two
    trajectories within the file's 1 cm RMS."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=13, cam=cfg.camera, view="corner")
    gpu = System(cfg, fast=True, enable_surfels=False, pipeline=True, chunk=4)
    cpu = System(cfg, fast=True, enable_surfels=False, pipeline=True, chunk=4, device="cpu")
    for i in range(13):
        ts, gray, depth = seq.frame(i)
        gpu.track(gray, depth, ts)
        cpu.track(gray, depth, ts)
    gpu.shutdown()
    cpu.shutdown()
    assert len(gpu.tracker.records) == len(cpu.tracker.records) == 13
    assert sum(not r.lost for r in gpu.tracker.records) >= 12
    pos_gpu = np.array([r[1] for r in gpu.tracker.trajectory_rows()])
    pos_cpu = np.array([r[1] for r in cpu.tracker.trajectory_rows()])
    assert pos_gpu.shape == pos_cpu.shape
    assert np.sqrt(((pos_gpu - pos_cpu) ** 2).sum(1).mean()) < 1e-2


def test_chunk_path_launches_each_kernel_once_per_frame(cuda):
    """On the chunk path each kernel runs once per frame, counted through
    the graph's replays: 1 + 3 chunks of 4 frames, the first frame eager,
    the second captured and every later one replayed."""
    from manhattanslam_tpu_torch.frontend.graphed_step import GraphedStep

    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=13, cam=cfg.camera, view="corner")
    system = System(cfg, fast=True, enable_surfels=False, chunk=4)
    before, replays = _launches(), GraphedStep.replays
    for i in range(13):
        ts, gray, depth = seq.frame(i)
        system.track(gray, depth, ts)
    system.shutdown()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [13, 13, 13]
    assert GraphedStep.replays - replays == 12


def test_keyframe_slot_reuse_on_cuda(cuda):
    """A retired keyframe's slot reused by a new keyframe on the card: the
    view written in place equals a full upload of the map, and the graphed
    step tracks the next frame against it."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=12, cam=cfg.camera)
    system = System(cfg, fast=True, enable_planes=False, enable_lines=False, enable_surfels=False)
    for i in range(4):
        ts, gray, depth = seq.frame(i)
        assert system.track(gray, depth, ts) is not None
    tr, m = system.tracker, system.map
    tr.force_keyframe = True
    ts, gray, depth = seq.frame(4)
    assert system.track(gray, depth, ts) is not None
    retired = tr.ref_kf
    assert retired > 0
    m.retire_keyframe(retired)  # re-anchors the reference keyframe on the parent
    assert m.kf_free == [retired] and tr.ref_kf != retired
    tr.force_keyframe = True
    ts, gray, depth = seq.frame(5)
    assert system.track(gray, depth, ts) is not None
    assert tr.counts["slots_reused"] == 1 and tr.ref_kf == retired and m.kf_valid[retired]
    full = dt.upload_view(dt.build_host_view(cfg, m, tr.ref_kf, tr.reg2, tr.reg3), cuda)
    for k in full:
        assert torch.equal(tr.view[k], full[k]), k
    assert tr.step.graph is not None
    ts, gray, depth = seq.frame(6)
    assert system.track(gray, depth, ts) is not None


def _surfel_frame(cfg, i):
    ts, gray, depth = SyntheticSequence(n_frames=10, cam=cfg.camera, view="corner").frame(i)
    return torch.from_numpy(gray.astype(np.float32)), torch.from_numpy(depth.astype(np.float32))


def test_superpixels_on_cuda_deterministic_and_match_cpu(cuda):
    """superpixels twice on the card: equal outputs (the per-superpixel
    sums run in a fixed order, no atomics); against the CPU: labels equal
    on >= 99.5% of the pixels, and where a superpixel has the same members
    its mean and z within 1e-4 m and its normal within 1 - |dot| <= 2e-5,
    but for at most one superpixel a frame, within 1 cm and 0.1 rad (a
    segment whose trimmed refits keep members by hard residual
    thresholds; tests/test_torch_surfels.py)."""
    cfg = _small_cfg()
    K = torch.tensor(np.asarray(cfg.camera.K, np.float32))
    for i in (0, 6):
        gray, depth = _surfel_frame(cfg, i)
        mask = torch.zeros(gray.shape, dtype=torch.bool)
        a = surfels.superpixels(gray.to(cuda), depth.to(cuda), mask.to(cuda), K.to(cuda))
        b = surfels.superpixels(gray.to(cuda), depth.to(cuda), mask.to(cuda), K.to(cuda))
        assert all(torch.equal(a[k], b[k]) for k in a)
        c = surfels.superpixels(gray, depth, mask, K)
        a = {k: v.cpu().numpy() for k, v in a.items()}
        c = {k: v.numpy() for k, v in c.items()}
        assert (a["labels"] == c["labels"]).mean() >= 0.995
        S = c["mean"].shape[0]
        diff = a["labels"] != c["labels"]
        touched = np.zeros(S + 1, bool)
        touched[np.where(diff, a["labels"], S)] = True
        touched[np.where(diff, c["labels"], S)] = True
        same = np.nonzero(~touched[:S] & (c["n_pix"] > 0))[0]
        np.testing.assert_array_equal(a["valid"][same], c["valid"][same])
        dots = np.abs((a["normal"][same] * c["normal"][same]).sum(-1))
        off = ((np.abs(a["mean"][same] - c["mean"][same]).max(-1) > 1e-4)
               | (np.abs(a["z"][same] - c["z"][same]) > 1e-4) | (dots < 1 - 2e-5))
        assert off.sum() <= 1
        assert (np.abs(a["mean"][same] - c["mean"][same]).max() < 0.01
                and np.arccos(np.clip(dots, 0, 1)).max() < 0.1)


def test_surfel_fusion_on_cuda_matches_cpu(cuda):
    """fuse_surfels and add_new_surfels on the card and on the CPU, given
    the same superpixels and state (frame 0's surfels, then frame 6 fused
    at its ground-truth pose): flags and counts equal, floats within
    1e-5, the state written in place (no tensor replaced)."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=10, cam=cfg.camera, view="corner")
    K = torch.tensor(np.asarray(cfg.camera.K, np.float32))
    H, W = cfg.camera.height, cfg.camera.width
    states = {"cpu": surfels.empty_state(4096, "cpu"), "cuda": surfels.empty_state(4096, cuda)}
    ptrs = [v.data_ptr() for v in states["cuda"].values()]
    for kf, i in enumerate((0, 6)):
        gray, depth = _surfel_frame(cfg, i)
        sp = surfels.superpixels(gray, depth, torch.zeros(gray.shape, dtype=torch.bool), K)
        T_cw = (np.linalg.inv(seq.poses[i]) @ seq.poses[0]).astype(np.float32)
        T_wc = torch.from_numpy(np.linalg.inv(T_cw))
        T_cw = torch.from_numpy(T_cw)
        for name, dev in (("cpu", torch.device("cpu")), ("cuda", cuda)):
            s = states[name]
            sp_d = {k: v.to(dev) for k, v in sp.items()}
            fused = surfels.fuse_surfels(s, sp_d, T_cw.to(dev), T_wc.to(dev), K.to(dev), kf, H, W)
            surfels.add_new_surfels(s, sp_d, fused, T_wc.to(dev), kf)
        for k, v in states["cpu"].items():
            g = states["cuda"][k].cpu()
            if v.dtype.is_floating_point:
                assert (g - v).abs().max() <= 1e-5, k
            else:
                assert torch.equal(g, v), k
    assert int(states["cpu"]["valid"].sum()) > 100
    assert int(states["cpu"]["n_updates"].max()) >= 2  # frame 6 fused into frame 0's surfels
    assert [v.data_ptr() for v in states["cuda"].values()] == ptrs


def test_modular_system_on_cuda_holds_the_e2e_bars(cuda, tmp_path):
    """The modular tracker (System's default) on the card with
    tests/test_e2e_tracking.py's traffic and flags: all 10 frames tracked,
    ATE < 0.05 m, unit-norm keyframe quaternions, > 100 map points; then
    the default flags (planes, lines, surfels) on the corner view: all
    tracked and surfels exported."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=10, cam=cfg.camera)
    system = System(cfg, enable_planes=False, enable_lines=False, enable_surfels=False)
    for i in range(10):
        ts, gray, depth = seq.frame(i)
        assert system.track(gray, depth, ts) is not None, f"frame {i}"
    pos = np.array([r[1] for r in system.tracker.trajectory_rows()])
    gt = seq.gt_rows()
    ts_all = np.array([r[0] for r in gt])
    assert traj_io.ate_rmse((ts_all, pos), (ts_all, np.array([r[1] for r in gt]))) < 0.05
    q = np.array([r[2] for r in system.tracker.keyframe_rows()])
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1, atol=1e-5)
    assert system.map.mp_valid.sum() > 100
    corner = SyntheticSequence(n_frames=10, cam=cfg.camera, view="corner")
    full = System(cfg)
    for i in range(10):
        ts, gray, depth = corner.frame(i)
        assert full.track(gray, depth, ts) is not None, f"corner frame {i}"
    full.shutdown()
    assert len(full.surfel_mapper.export_arrays()["pos"]) > 200


def test_native_merge_on_cuda_extracted_stats(cuda):
    """The C++ AHC merge on block stats extracted on the card (a 640x480
    near_corner frame at TUM1): the Python merge's partition, and
    extract_planes(method="ahc") on the card with the CPU's valid count."""
    cfg = load_config(str(Path(__file__).resolve().parent.parent / "configs" / "TUM1.yaml"))
    depth = _view_depths(cfg, "near_corner", [0])[0]
    K = torch.as_tensor(np.asarray(cfg.camera.K, np.float32))
    _, packed = planes.plane_stage1(depth.to(cuda), K.to(cuda))
    st = planes.unpack_stats(packed.cpu().numpy())
    grid, min_support = (24, 32), int(0.04 * 240 * 320)
    lab_cc = planes.merge_blocks(st, grid, min_support)
    lab_py = planes.merge_blocks_py(st, grid, min_support)
    remap = {}
    for a, b in zip(lab_cc, lab_py):
        assert (a < 0) == (b < 0) and remap.setdefault(a, b) == b
    card = planes.extract_planes(depth.to(cuda), K, 8, 512, method="ahc")
    host = planes.extract_planes(depth, K, 8, 512, method="ahc", device="cpu")
    assert card["valid"].sum() == host["valid"].sum() >= 3
    np.testing.assert_allclose(card["coeffs"][card["valid"]], host["coeffs"][host["valid"]],
                               atol=1e-3)


def test_batched_track_step_b2_matches_b1_on_cuda(cuda):
    """parallel/mesh.py's sharded step at B = 2 (a mesh of the card twice)
    against two B = 1 steps; each kernel launched once per shard."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=3, cam=cfg.camera, view="corner")
    frames = [seq.frame(i) for i in range(3)]
    feats = frame.build_extractor(cfg, cuda)(torch.from_numpy(np.round(frames[0][1])).to(cuda),
                                             torch.from_numpy(frames[0][2]).to(cuda))
    bank = {"pos": frame.backproject_keypoints(feats, cfg), "desc": feats["desc"],
            "valid": feats["valid"] & (feats["depth"] > 0), "level": feats["level"]}
    gray = torch.from_numpy(np.round(np.stack([frames[1][1], frames[2][1]])).astype(np.float32))
    depth = torch.from_numpy(np.stack([frames[1][2], frames[2][2]]).astype(np.float32))
    seeds = torch.from_numpy(np.stack([np.linalg.inv(seq.poses[i]) @ seq.poses[0]
                                       for i in range(2)]).astype(np.float32))
    bank2 = {k: torch.stack([v, v]) for k, v in bank.items()}
    before = _launches()
    out = mesh.build_batched_track_step(cfg, mesh.make_mesh(devices=[cuda, cuda]))(
        gray, depth, seeds, bank2)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (2, 2, 2)
    for i in range(2):
        one = mesh.build_batched_track_step(cfg, mesh.make_mesh(1))(
            gray[i:i + 1], depth[i:i + 1], seeds[i:i + 1], {k: v[None] for k, v in bank.items()})
        T, T1 = out["T"][i].cpu().numpy(), one["T"][0].cpu().numpy()
        assert np.abs(T[:3, 3] - T1[:3, 3]).max() < 1e-3
        assert np.abs(T[:3, :3] - T1[:3, :3]).max() < 1e-3
        assert int(out["n_inliers"][i]) == int(one["n_inliers"][0]) > 50


def test_load_map_then_graphed_tracking_on_cuda(cuda, tmp_path):
    """A map saved after 8 frames, loaded into a fresh System: the loaded
    tables equal, and the next frames tracked from the graphed step
    against the refreshed view."""
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=12, cam=cfg.camera, view="corner")
    first = System(cfg, fast=True, enable_surfels=False)
    for i in range(8):
        ts, gray, depth = seq.frame(i)
        assert first.track(gray, depth, ts) is not None
    p = str(tmp_path / "map.npz")
    first.save_map(p)
    second = System(cfg, fast=True, enable_surfels=False)
    second.load_map(p)
    for k in ("mp_pos", "kf_pose", "kf_mp_idx", "pl_coeffs"):
        np.testing.assert_array_equal(getattr(second.map, k), getattr(first.map, k))
    tr = second.tracker
    tr.state, tr.frame_id, tr.T_cw = "LOST", 100, first.tracker.T_cw.copy()
    second.activate_localization_mode()
    for i in range(8, 12):
        ts, gray, depth = seq.frame(i)
        assert second.track(gray, depth, 100.0 + i) is not None, i
    assert tr.step.graph is not None


# ---------------------------------------------------------------- the pose solve
SOLVE_CASES = ("candidate", "manhattan", "final", "reloc")


@pytest.fixture(scope="module")
def near_corner_solves():
    """The three solve_pose calls of one eager full-body step on 640x480
    near_corner frames (replay.step_solves) at B = 1 and B = 8: {B: {case:
    solve_pose_plain's arguments}}; "reloc" is the final problem with the
    relocalizer's flags (LM, 4 x 10, points only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = load_config(str(Path(__file__).resolve().parent.parent / "configs" / "TUM1.yaml"))
    seq = SyntheticSequence(n_frames=12, cam=cfg.camera, view="near_corner")
    frames = [seq.frame(i) for i in range(10)]
    view, _ = replay.shared_view(cfg, frames[0], dev)
    native = [dt.to_native(g, d) for _, g, d in frames]
    out = {}
    for b in (1, 8):
        calls = replay.step_solves(cfg, seq, native, view, list(range(1, b + 1)), dev)
        assert len(calls) == 3
        reloc = dict(calls[2], translation_only=False, n_rounds=4, n_iters=10,
                     gauss_newton=False, use_planes=False, use_lines=False)
        out[b] = dict(zip(SOLVE_CASES, calls + [reloc]))
    return out


def _pose_gap(Ta, Tb):
    """(translation m, rotation rad) of Ta^-1 Tb, per problem, in float64."""
    d = torch.linalg.inv(Ta.double()) @ Tb.double()
    w = torch.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0], d[:, 1, 0] - d[:, 0, 1]], -1)
    tr = d[:, 0, 0] + d[:, 1, 1] + d[:, 2, 2]
    return torch.linalg.norm(d[:, :3, 3], dim=-1), torch.atan2(torch.linalg.norm(w, dim=-1) / 2,
                                                                (tr - 1) / 2)


def _near_gates(a: dict, T: torch.Tensor) -> dict:
    """Per family, the rows whose chi2 at pose T lies within 1e-4 relative
    of their gate."""
    s = lm._Solver(a["prob"], a["K"], a["bf"], a["params"], a["translation_only"],
                   a["use_planes"], a["use_lines"])
    p = a["params"]
    gates = {"pt": lm.chi2_threshold(a["prob"]), "ln": 2.0 * lm.CHI2_MONO, "pl": p.plane_chi,
             "par": p.vp_chi, "ver": p.vp_chi}
    return {k: (c - gates[k]).abs() <= 1e-4 * torch.as_tensor(gates[k])
            for k, c in s.chi(T).items()}


def _assert_solve_matches_plain(a: dict, out: dict, ref: dict) -> None:
    # T within 1e-5 m and 1e-5 rad: the kernel sums H, g and the cost in
    # another order than cuBLAS and PyTorch's reductions, and contracts
    # products into FMAs, so the two iterate on float32 roundings apart
    # (~1e-7 relative); the damped steps contract that, so the poses stay
    # within a few float32 ulps of a metre-scale pose
    dt_m, dr = _pose_gap(ref["T"], out["T"])
    assert float(dt_m.max()) < 1e-5 and float(dr.max()) < 1e-5, (dt_m, dr)
    # the masks equal, but where a row's chi2 sits within 1e-4 relative of
    # its gate: which side of the gate it falls is float32 rounding there
    near = _near_gates(a, ref["T"])
    n_near = torch.zeros_like(ref["n_inliers"])
    for k in ("pt", "ln", "pl", "par", "ver"):
        differ = out["inlier_" + k] != ref["inlier_" + k]
        if k in near:
            assert not bool((differ & ~near[k]).any()), k
            n_near = n_near + (differ & near[k]).sum(-1)
        else:  # a family the solve leaves out: no inliers
            assert not bool(out["inlier_" + k].any()) and out["inlier_" + k].shape == ref[
                "inlier_" + k].shape, k
    assert bool(((out["n_inliers"] - ref["n_inliers"]).abs() <= n_near).all())
    # chi2 sums the same inliers' chi2 at poses within float32 rounding:
    # 1e-4 relative (where no mask differs)
    same = n_near == 0
    assert torch.allclose(out["chi2"][same], ref["chi2"][same], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("case", SOLVE_CASES)
def test_lm_solve_kernel_matches_plain(near_corner_solves, case, b):
    """csrc/lm_solve.cu against the plain solve on the card, for each
    caller's flags (candidate: GN, 6 dof, points, 3B problems; Manhattan:
    GN, translation only, points and planes, 2B; final: LM, 6 dof, every
    family; reloc: LM 4 x 10, points only), on problems of 640x480
    near_corner frames: one launch a call, two launches bit for bit equal
    (a fixed reduction order, no atomics), and the plain version's answer
    within the tolerances stated in _assert_solve_matches_plain."""
    a = near_corner_solves[b][case]
    before = lm.solve_pose_cuda.launches
    out, again = lm.solve_pose(**a), lm.solve_pose(**a)
    torch.cuda.synchronize()
    assert lm.solve_pose_cuda.launches == before + 2
    assert list(out) == list(again)
    for k in out:
        assert torch.equal(out[k], again[k]), k
    ref = lm.solve_pose_plain(**a)
    assert list(out) == list(ref)
    assert all(out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape for k in out)
    _assert_solve_matches_plain(a, out, ref)


@pytest.mark.parametrize("case", ["final", "candidate"])
def test_lm_solve_kernel_degenerate_problems(near_corner_solves, case):
    """Every row masked (H = 0: the pose stays T0, no inliers, chi2 0) gives
    what the plain version gives, bit for bit.  A single point row (H of
    rank 3 at most, so singular; the damping makes it solvable) has no
    unique pose: a step along H's null space is the rounding of g over
    the damping (LM's lambda halves to 1e-5 in 5 accepted iterations), so
    the two poses may part by centimetres there; what both have to give is
    the same inlier and the same cost: chi2 within 1e-3 of the row's gate
    of each other, the pose finite and a rotation."""
    a = near_corner_solves[1][case]
    prob = a["prob"]
    off = {k: torch.zeros_like(getattr(prob, k)) for k in lm.PoseProblem._fields
           if k.endswith("mask") and getattr(prob, k) is not None}
    none = dict(a, prob=prob._replace(**off))
    out, ref = lm.solve_pose(**none), lm.solve_pose_plain(**none)
    for k in out:
        assert torch.equal(out[k], ref[k]), k
    assert torch.equal(out["T"], a["T0"])
    one = off["pt_mask"].clone()
    one[0, int(torch.nonzero(prob.pt_mask[0])[0])] = True
    single = dict(none, prob=none["prob"]._replace(pt_mask=one))
    out, ref = lm.solve_pose(**single), lm.solve_pose_plain(**single)
    for k in ("inlier_pt", "inlier_ln", "inlier_pl", "inlier_par", "inlier_ver", "n_inliers"):
        assert torch.equal(out[k], ref[k]), k
    assert bool(out["inlier_pt"][0].any())
    c_out, c_ref = float(out["chi2"][0]), float(ref["chi2"][0])
    assert abs(c_out - c_ref) < 1e-3 * lm.CHI2_MONO, (c_out, c_ref)
    R = out["T"][0, :3, :3].double()
    assert bool(torch.isfinite(out["T"]).all())
    assert torch.allclose(R @ R.T, torch.eye(3, dtype=R.dtype, device=R.device), atol=1e-5)


def test_lm_solve_is_one_node_a_solve_and_three_launches_a_frame(cuda, near_corner_solves):
    """Captured in a CUDA graph, each of the three solves of a frame adds
    one node (the kernel: no torch op of the solver); one eager frame of
    the full body launches the kernel exactly three times."""
    from manhattanslam_tpu_torch import tracing

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    added = []
    with torch.cuda.graph(graph, stream=side):
        for case in ("candidate", "manhattan", "final"):
            n0 = tracing.capture_nodes()
            lm.solve_pose(**near_corner_solves[1][case])
            added.append(tracing.capture_nodes() - n0)
    assert added == [1, 1, 1]
    cfg = _small_cfg()
    seq = SyntheticSequence(n_frames=4, cam=cfg.camera, view="near_corner")
    frames = [seq.frame(i) for i in range(3)]
    view, _ = replay.shared_view(cfg, frames[0], cuda)
    native = [dt.to_native(g, d) for _, g, d in frames]
    body = dt.build_batched_body(cfg, cuda, enable_planes=True, enable_lines=True)
    g8, d16 = replay.step_frames(native, [1], 0, cuda)
    before = lm.solve_pose_cuda.launches
    body(*dt.frame_to_float(g8, d16), replay.start_carry(cfg, seq, [1], cuda), view)
    assert lm.solve_pose_cuda.launches == before + 3


def test_lm_solve_wrapper_checks_inputs(cuda):
    """The wrapper raises on what the kernel does not take, and the plain
    path is not reachable with CUDA tensors."""
    K = torch.eye(3, device=cuda)
    T0 = torch.eye(4, device=cuda)[None]
    prob = lm.empty_problem(npt=4, nl=2, lead=(1,), device=cuda)
    with pytest.raises(ValueError):
        lm.solve_pose(prob, T0.double(), K, 30.0)
    with pytest.raises(ValueError):
        lm.solve_pose(prob._replace(pt_xw=prob.pt_xw.double()), T0, K, 30.0)
    with pytest.raises(ValueError):
        lm.solve_pose(prob, T0, K, torch.tensor(30.0, device=cuda))
    with pytest.raises(ValueError):
        lm.solve_pose(prob._replace(pt_info=prob.pt_info.cpu()), T0, K, 30.0)
    with pytest.raises(ValueError):
        lm.solve_pose_cuda(lm.empty_problem(npt=4, lead=(1,)), T0.cpu(), K.cpu(), 30.0)
