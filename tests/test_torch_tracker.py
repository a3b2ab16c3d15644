"""The slice as a whole: the port's points-only FastTracker against the JAX
FastTracker (planes and lines off, driven directly so that no LocalMapper
runs) on 12 box-room frames at small_cfg size, plus the port's System
surface and the device-view plumbing.

Tolerances: per-frame pose within 1e-3 m and 1e-3 rad (the extractors'
pyramids differ by float32 ulps, which can swap a keypoint at a coarse
level); tracked flags and keyframe frames equal; port-vs-reference ATE
under 5 mm.
"""

import jax
import numpy as np
import pytest
import torch

from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.frontend import device_tracker as jdt
from manhattanslam_tpu.frontend.fast_tracking import FastTracker as JaxFastTracker
from manhattanslam_tpu.io import trajectory as traj_io
from manhattanslam_tpu.slam_map import SlamMap as JaxSlamMap
from manhattanslam_tpu_torch import convert
from manhattanslam_tpu_torch.frontend import device_tracker as pdt
from manhattanslam_tpu_torch.frontend.fast_tracking import FastTracker
from manhattanslam_tpu_torch.slam_map import SlamMap
from manhattanslam_tpu_torch.system import System
from torch_parity import port_cfg, rot_angle

N_FRAMES = 12
CPU = torch.device("cpu")


def _rows_xyz(rows):
    return np.array([r[0] for r in rows]), np.array([r[1] for r in rows])


@pytest.fixture(scope="module")
def tracked(small_cfg):
    seq = SyntheticSequence(n_frames=N_FRAMES, cam=small_cfg.camera)
    ref = JaxFastTracker(small_cfg, JaxSlamMap(small_cfg), enable_planes=False, enable_lines=False)
    port = FastTracker(port_cfg(small_cfg), SlamMap(port_cfg(small_cfg)), CPU)
    poses_ref, poses = [], []
    for i in range(N_FRAMES):
        ts, gray, depth = seq.frame(i)
        poses_ref.append(ref.track(ts, gray, depth))
        poses.append(port.track(ts, gray, depth))
    return seq, ref, port, poses_ref, poses


def test_all_frames_tracked_like_reference(tracked):
    _, ref, port, poses_ref, poses = tracked
    assert [p is not None for p in poses] == [p is not None for p in poses_ref]
    assert all(p is not None for p in poses)
    assert [r[2] for r in port.frame_log] == [r[2] for r in ref.frame_log]


def test_per_frame_pose_matches_reference(tracked):
    _, _, _, poses_ref, poses = tracked
    for i, (a, b) in enumerate(zip(poses_ref, poses)):
        d = np.linalg.inv(a.astype(np.float64)) @ b.astype(np.float64)
        assert np.linalg.norm(d[:3, 3]) < 1e-3, f"frame {i}"
        assert rot_angle(d[:3, :3]) < 1e-3, f"frame {i}"


def test_same_keyframes_and_map(tracked):
    _, ref, port, _, _ = tracked
    n = ref.map.n_kf
    assert port.map.n_kf == n
    np.testing.assert_array_equal(port.map.kf_frame_id[:n], ref.map.kf_frame_id[:n])
    # the first keyframe's landmarks come from level-0-dominated features:
    # nearly the same count, created from the same depth rule
    assert abs(int(port.map.mp_valid.sum()) - int(ref.map.mp_valid.sum())) <= 5


def test_port_vs_reference_ate(tracked, tmp_path):
    seq, ref, port, _, _ = tracked
    a, b = tmp_path / "ref.txt", tmp_path / "port.txt"
    traj_io.save_trajectory_tum(str(a), ref.trajectory_rows())
    traj_io.save_trajectory_tum(str(b), port.trajectory_rows())
    ts_r, p_r, _ = traj_io.load_trajectory_tum(str(a))
    ts_p, p_p, _ = traj_io.load_trajectory_tum(str(b))
    assert len(ts_p) == N_FRAMES
    assert traj_io.ate_rmse((ts_p, p_p), (ts_r, p_r)) < 5e-3
    assert traj_io.ate_rmse((ts_p, p_p), _rows_xyz(seq.gt_rows())) < 0.05


def test_one_step_from_converted_reference_state(tracked, small_cfg):
    """convert.py carries the reference tracker's map and carry into the
    port; one step of each from that same state gives the same pose."""
    seq, ref, _, _, _ = tracked
    pcfg = port_cfg(small_cfg)
    tables = {k: getattr(ref.map, k) for k in convert.MAP_TABLES + convert.MAP_SCALARS}
    m = convert.slam_map_from_numpy(pcfg, tables)
    carry = convert.carry_from_numpy(jax.device_get(ref.carry), CPU)
    view = pdt.upload_view(pdt.build_host_view(pcfg, m, ref.ref_kf), CPU)
    ts, gray, depth = seq.frame(N_FRAMES - 1)
    g8, d16 = pdt.to_native(gray, depth)
    res, _ = pdt.build_frame_step(pcfg, CPU)(
        torch.from_numpy(g8), torch.from_numpy(d16.astype(np.int32)), carry, view
    )
    res_ref, _ = ref.step(jdt.pack_frame(gray, depth), ref.carry, ref.view)
    T_ref = np.asarray(jax.device_get(res_ref["T"]), np.float64)
    d = np.linalg.inv(T_ref) @ res["T"].numpy().astype(np.float64)
    assert bool(res["tracked_ok"]) == bool(jax.device_get(res_ref["tracked_ok"]))
    assert np.linalg.norm(d[:3, 3]) < 1e-3 and rot_angle(d[:3, :3]) < 1e-3


def test_view_update_equals_full_upload(small_cfg):
    """Row diff + in-place apply reproduces a fresh upload of the map."""
    pcfg = port_cfg(small_cfg)
    m = SlamMap(pcfg)
    view = pdt.build_map_view(pcfg, m, CPU)
    shadow = pdt.build_host_view(pcfg, m, 0)
    shadow["ref_mp"][:] = -1
    shadow["ref_desc"][:] = 0
    rng = np.random.default_rng(0)
    n = 50
    feats = {
        "xy_und": rng.uniform(0, 100, (pcfg.caps.max_keypoints, 2)).astype(np.float32),
        "u_right": np.zeros(pcfg.caps.max_keypoints, np.float32),
        "depth": np.ones(pcfg.caps.max_keypoints, np.float32),
        "level": np.zeros(pcfg.caps.max_keypoints, np.int32),
        "angle": np.zeros(pcfg.caps.max_keypoints, np.float32),
        "desc": rng.integers(0, 2**32, (pcfg.caps.max_keypoints, 8), dtype=np.uint64).astype(np.uint32),
        "valid": np.ones(pcfg.caps.max_keypoints, bool),
    }
    kf = m.add_keyframe(np.eye(4, dtype=np.float32), 0.0, 0, feats)
    ids = m.add_points(
        rng.normal(size=(n, 3)).astype(np.float32), feats["desc"][:n],
        np.ones((n, 3), np.float32), np.ones(n, np.float32), np.ones(n, np.float32) * 3,
        np.zeros(n, np.int32), kf,
    )
    mp_idx = np.full(pcfg.caps.max_keypoints, -1, np.int32)
    mp_idx[:n] = ids
    m.set_kf_matches(kf, mp_idx)
    host = pdt.build_host_view(pcfg, m, kf)
    updates = pdt.diff_host_views(shadow, host)
    assert len(updates) == 1 and len(updates[0]["mp_idx"]) == n
    view = pdt.apply_view_update(view, updates)
    full = pdt.upload_view(host, CPU)
    for k in full:
        assert torch.equal(view[k], full[k]), k
    assert pdt.diff_host_views(host, host) == []
    ref_view = pdt.set_ref_kf(pdt.build_map_view(pcfg, m, CPU), m, kf)
    for k in ("ref_desc", "ref_angle", "ref_mp"):
        assert torch.equal(ref_view[k], full[k]), k


def test_init_carry_matches_reference_layout(small_cfg):
    ref = jax.device_get(jdt.init_carry(small_cfg, vo_points=True))
    out = pdt.init_carry(port_cfg(small_cfg), CPU, vo_points=True)
    conv = convert.carry_from_numpy(ref, CPU)
    assert set(out) == set(ref)
    for k in ref:
        assert tuple(out[k].shape) == tuple(np.shape(ref[k])), k
        assert torch.equal(out[k], conv[k]), k


@pytest.mark.parametrize(
    "kwargs",
    [dict(fast=False), dict(fast=True, enable_surfels=False, chunk=4),
     dict(fast=True, enable_surfels=False, pipeline=True),
     dict(fast=True, enable_surfels=False, enable_planes=True, chunk=4),
     dict(fast=True, enable_surfels=False, enable_lines=True, chunk=4),
     dict(fast=True, enable_surfels=True)],
)
def test_system_raises_for_later_slices(small_cfg, kwargs):
    """Every flag set is ported now (chunks and the pipeline, the modular
    tracker and surfels): none raises, each constructs and tracks a
    frame."""
    system = System(port_cfg(small_cfg), device="cpu", **kwargs)
    ts, gray, depth = SyntheticSequence(n_frames=1, cam=small_cfg.camera).frame(0)
    assert system.track(gray, depth, ts) is not None
    assert len(system.tracker.records) == 1


def test_system_with_planes_tracks_the_corner_view(small_cfg):
    """System(enable_planes=True) on the CPU: the corner view's frames are
    tracked, the keyframe's planes become map planes with a Manhattan pair,
    and the Manhattan pose carries frames."""
    seq = SyntheticSequence(n_frames=4, cam=small_cfg.camera, view="corner")
    system = System(port_cfg(small_cfg), fast=True, enable_planes=True, enable_lines=False,
                    enable_surfels=False, device="cpu")
    for i in range(4):
        ts, gray, depth = seq.frame(i)
        assert system.track(gray, depth, ts) is not None
    assert int(system.map.pl_valid.sum()) >= 2 and len(system.map.manhattan_pairs) >= 1
    assert system.trace.counters["manhattan_frames"] >= 1


def test_system_needs_cuda_unless_cpu_is_asked(small_cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        System(port_cfg(small_cfg))


def test_system_tracks_and_saves(small_cfg, tmp_path):
    """System on the CPU: frames tracked, TUM files with 8 fields a line."""
    seq = SyntheticSequence(n_frames=4, cam=small_cfg.camera)
    system = System(port_cfg(small_cfg), fast=True, enable_planes=False, enable_lines=False,
                    enable_surfels=False, device="cpu")
    for i in range(4):
        ts, gray, depth = seq.frame(i)
        assert system.track(gray, depth, ts) is not None
    rgb = np.repeat(np.round(gray).astype(np.uint8)[..., None], 3, -1)
    assert system.track(rgb, depth, 4 / 30.0) is not None
    system.shutdown()
    system.save_trajectory_tum(str(tmp_path / "f.txt"))
    system.save_keyframe_trajectory_tum(str(tmp_path / "k.txt"))
    lines = (tmp_path / "f.txt").read_text().splitlines()
    assert len(lines) == 5 and all(len(ln.split()) == 8 for ln in lines)
    assert len((tmp_path / "k.txt").read_text().splitlines()) == system.map.n_kf
    with pytest.raises(ValueError):
        system.track(gray[:10], depth, 1.0)
