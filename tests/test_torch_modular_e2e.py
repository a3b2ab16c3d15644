"""The port's modular System (``System(small_cfg, device="cpu")``, the
reference's default tracker) held to the bounds of the reference's own
end-to-end tests, on the same traffic and flags, on the CPU:

- tests/test_e2e_tracking.py (points only, the "wall" orbit): all 10
  frames tracked, ATE < 0.05 m, unit-norm keyframe quaternions, > 100
  map points; localization mode adds no keyframe or point and tracks
  every frame; a reset re-initializes, and with planes and lines on it
  re-points the modules and the mapper at the new map; a pipelined fused
  System keeps its flag across a reset.
- tests/test_planes_e2e.py (planes on, the corner view): all tracked,
  >= 2 map planes whose clouds fit them, >= 1 Manhattan pair, the
  Manhattan frame on >= 3 frames and within 2 degrees of the ground-truth
  rotation, ATE.
- tests/test_lines_e2e.py (planes and lines on): all tracked, >= 3 map
  lines longer than 0.05 m, an association on the last frame, ATE.
- tests/test_surfels.py:104-115 with the default flags (planes, lines and
  surfels on): > 200 PLY vertices, > 90% of them inside the padded room.

Marked ``slow`` (the reference's modular System compiles for minutes on
the CPU): the reference's default System against the port's on
tests/test_surfels.py's traffic: the same tracked frames and keyframes,
poses within 1 cm, exported surfel counts within 5%.
"""

import numpy as np
import pytest

from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.io import trajectory as traj_io
from manhattanslam_tpu_torch.io.ply import load_surfel_ply
from manhattanslam_tpu_torch.system import System
from torch_parity import port_cfg, rot_angle


def _run(system, seq, n=None):
    poses = []
    for i in range(len(seq) if n is None else n):
        t, gray, depth = seq.frame(i)
        poses.append(system.track(gray, depth, t))
    return poses


def _ate(system, seq, tmp_path) -> float:
    est = tmp_path / "est.txt"
    system.save_trajectory_tum(str(est))
    ts, pos, _ = traj_io.load_trajectory_tum(str(est))
    assert len(ts) == len(seq)
    gt = seq.gt_rows()
    return traj_io.ate_rmse((ts, pos), (np.array([r[0] for r in gt]), np.array([r[1] for r in gt])))


# ---------------------------------------------------- tests/test_e2e_tracking.py
@pytest.fixture(scope="module")
def tracked(small_cfg):
    seq = SyntheticSequence(n_frames=10, cam=small_cfg.camera)
    system = System(port_cfg(small_cfg), enable_planes=False, enable_lines=False,
                    enable_surfels=False, device="cpu")
    return seq, system, _run(system, seq)


def test_all_frames_tracked(tracked):
    seq, system, poses = tracked
    assert sum(p is not None for p in poses) == len(seq)
    assert system.tracker.__class__.__name__ == "Tracker"


def test_trajectory_accuracy(tracked, tmp_path):
    seq, system, _ = tracked
    assert _ate(system, seq, tmp_path) < 0.05


def test_keyframe_trajectory_export(tracked, tmp_path):
    _, system, _ = tracked
    kf = tmp_path / "kf.txt"
    system.save_keyframe_trajectory_tum(str(kf))
    ts, _, q = traj_io.load_trajectory_tum(str(kf))
    assert len(ts) >= 1
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1, atol=1e-5)


def test_map_grows(tracked):
    _, system, _ = tracked
    assert system.map.n_kf >= 1 and system.map.mp_valid.sum() > 100


def test_localization_mode(small_cfg):
    seq = SyntheticSequence(n_frames=12, cam=small_cfg.camera)
    system = System(port_cfg(small_cfg), enable_planes=False, enable_lines=False,
                    enable_surfels=False, device="cpu")
    _run(system, seq, 6)
    n_kf, n_mp = system.map.n_kf, system.map.mp_valid.sum()
    system.activate_localization_mode()
    for i in range(6, 12):
        t, gray, depth = seq.frame(i)
        assert system.track(gray, depth, t) is not None
    assert system.map.n_kf == n_kf and system.map.mp_valid.sum() == n_mp


def test_reset(small_cfg):
    seq = SyntheticSequence(n_frames=12, cam=small_cfg.camera)
    system = System(port_cfg(small_cfg), enable_planes=False, enable_lines=False,
                    enable_surfels=False, device="cpu")
    _run(system, seq, 3)
    system.reset()
    assert system.map.n_kf == 0
    t, gray, depth = seq.frame(0)
    assert system.track(gray, depth, t) is not None


def test_reset_with_all_modules(small_cfg):
    """The reset re-points the line and plane modules, the relocalizer and
    the local mapper at the NEW map (tests/test_e2e_tracking.py:89-112)."""
    seq = SyntheticSequence(n_frames=12, cam=small_cfg.camera)
    system = System(port_cfg(small_cfg), enable_planes=True, enable_lines=True,
                    enable_surfels=False, device="cpu")
    _run(system, seq, 4)
    modules = (system.tracker.plane_module, system.tracker.line_module)
    system.reset()
    assert system.map.n_kf == 0
    assert (system.tracker.plane_module, system.tracker.line_module) == modules
    assert system.tracker.line_module.map is system.map
    assert system.tracker.plane_module.map is system.map
    assert system.local_mapper.map is system.map and system.reloc_module.map is system.map
    assert system.local_mapper.recent_points == []
    poses = _run(system, seq, 4)
    assert poses[-1] is not None
    assert system.map.n_kf >= 1 and system.map.mp_valid.sum() > 0


def test_reset_fast_tracker(small_cfg):
    seq = SyntheticSequence(n_frames=12, cam=small_cfg.camera)
    system = System(port_cfg(small_cfg), enable_surfels=False, fast=True, pipeline=True,
                    device="cpu")
    _run(system, seq, 3)
    system.reset()
    assert system.tracker.pipeline is True and system.map.n_kf == 0
    _run(system, seq, 4)
    system.shutdown()
    assert system.map.n_kf >= 1


# ----------------------------------------------------- tests/test_planes_e2e.py
@pytest.fixture(scope="module")
def tracked_planes(small_cfg):
    seq = SyntheticSequence(n_frames=10, cam=small_cfg.camera, view="corner")
    system = System(port_cfg(small_cfg), enable_planes=True, enable_lines=False,
                    enable_surfels=False, device="cpu")
    hits, poses = 0, []
    for i in range(len(seq)):
        t, gray, depth = seq.frame(i)
        poses.append(system.track(gray, depth, t))
        hits += system.tracker.plane_module.manhattan_Rcw is not None
    return seq, system, poses, hits


def test_planes_frames_tracked_and_ate(tracked_planes, tmp_path):
    seq, system, poses, _ = tracked_planes
    assert sum(p is not None for p in poses) == len(seq)
    assert _ate(system, seq, tmp_path) < 0.05


def test_map_planes_created(tracked_planes):
    _, system, _, _ = tracked_planes
    m = system.map
    assert int(m.pl_valid.sum()) >= 2
    for j in np.nonzero(m.pl_valid)[0]:
        c = m.pl_coeffs[j]
        cl = m.pl_pts[j, : m.pl_n_pts[j]]
        assert np.abs(cl @ c[:3] + c[3]).mean() < 0.1
    assert len(m.manhattan_pairs) >= 1


def test_manhattan_detected_and_matches_gt(tracked_planes):
    seq, system, _, hits = tracked_planes
    assert hits >= 3
    pm = system.tracker.plane_module
    assert pm.manhattan_Rcw is not None
    R_gt_rel = np.linalg.inv(seq.poses[-1])[:3, :3] @ seq.poses[0][:3, :3]
    assert np.degrees(rot_angle(pm.manhattan_Rcw @ R_gt_rel.T)) < 2.0


# ------------------------------------------------------ tests/test_lines_e2e.py
@pytest.fixture(scope="module")
def tracked_full(small_cfg):
    seq = SyntheticSequence(n_frames=10, cam=small_cfg.camera, view="corner")
    system = System(port_cfg(small_cfg), enable_planes=True, enable_lines=True,
                    enable_surfels=False, device="cpu")
    return seq, system, _run(system, seq)


def test_full_stack_tracks_and_ate(tracked_full, tmp_path):
    seq, system, poses = tracked_full
    assert sum(p is not None for p in poses) == len(seq)
    assert _ate(system, seq, tmp_path) < 0.05


def test_map_lines_created_and_associated(tracked_full):
    _, system, _ = tracked_full
    m = system.map
    assert int(m.ml_valid.sum()) >= 3
    for j in np.nonzero(m.ml_valid)[0]:
        assert np.linalg.norm(m.ml_sp[j] - m.ml_ep[j]) > 0.05
    assert (system.tracker.line_module.assoc >= 0).sum() >= 1


# --------------------------------------------- tests/test_surfels.py:104-115
def _surfel_run(system, seq, tmp_path):
    _run(system, seq)
    system.shutdown()
    p = tmp_path / "Surfels.ply"
    system.save_surfels(str(p))
    return load_surfel_ply(str(p))


def _inside_room(seq, pos) -> float:
    T0 = seq.poses[0]
    pts_room = pos @ T0[:3, :3].T + T0[:3, 3]
    return float(((pts_room > -0.5).all(1)
                  & (pts_room < np.array(seq.room.size) + 0.5).all(1)).mean())


def test_surfel_mapping_default_flags(small_cfg, tmp_path):
    seq = SyntheticSequence(n_frames=10, cam=small_cfg.camera, view="corner")
    system = System(port_cfg(small_cfg), device="cpu")
    assert system.surfel_mapper is not None and system.tracker.line_module is not None
    back = _surfel_run(system, seq, tmp_path)
    assert len(back["pos"]) > 200
    assert _inside_room(seq, back["pos"]) > 0.9


@pytest.mark.slow
def test_default_system_matches_reference(small_cfg, tmp_path):
    """The reference's default System(small_cfg) against the port's on
    tests/test_surfels.py's traffic."""
    from manhattanslam_tpu.io.ply import load_surfel_ply as jload
    from manhattanslam_tpu.system import System as JaxSystem

    seq = SyntheticSequence(n_frames=10, cam=small_cfg.camera, view="corner")
    ref, port = JaxSystem(small_cfg), System(port_cfg(small_cfg), device="cpu")
    ref_poses, port_poses = _run(ref, seq), _run(port, seq)
    assert [p is None for p in port_poses] == [p is None for p in ref_poses]
    for a, b in zip(ref_poses, port_poses):
        if a is not None:
            assert np.linalg.norm(np.asarray(a)[:3, 3] - b[:3, 3]) < 0.01
    assert list(port.map.kf_frame_id[: port.map.n_kf]) == list(ref.map.kf_frame_id[: ref.map.n_kf])
    ref.shutdown()
    port.shutdown()
    ref.save_surfels(str(tmp_path / "r.ply"))
    port.save_surfels(str(tmp_path / "p.ply"))
    n_ref = len(jload(str(tmp_path / "r.ply"))["pos"])
    n_port = len(load_surfel_ply(str(tmp_path / "p.ply"))["pos"])
    assert abs(n_port - n_ref) <= 0.05 * n_ref
