"""Relocalization in the port against the reference, on the CPU at
small_cfg size.

- ``kabsch`` (a batch of weighted fits) and the RANSAC cores
  ``pose_ransac_3d3d_from_samples`` / ``pose_ransac_pnp_from_samples``
  fed the hypotheses' indices that JAX draws exactly as the reference's
  ``one_hyp`` does, on the scenes of tests/test_reloc.py (30% outliers):
  the inlier masks equal, R and t within 1e-5 (Kabsch, 3D-3D) and 3e-5
  (EPnP: its float32 12x12 eigh of M^T M leaves the reference itself
  8e-6 m from a float64 EPnP on the same inliers, and the port 1.3e-5 m,
  so the two are 1.5e-5 m apart).  The reference's JAX stream cannot be
  reproduced by torch, so the port's own sampler is held by the result
  it reaches: the same inliers and the true pose.
- ``compute_bow`` equal to the reference's, and ``detect_candidates``
  equal on the milestone's converted map.
- The milestone: the port's ``System(device="cpu")`` against the
  reference's ``System(fast=True, enable_surfels=False)``, planes and
  lines off, on the forced-loss traffic of tests/test_reloc.py:71-113 (6
  frames of the "wall" orbit, the map padded to 6 keyframes with clones
  of keyframe 0, one noise frame, then frames 5, 4, ..., 0 until one is
  tracked): the same frames tracked and the same frame recovering, the
  same keyframes and culled keyframes, map points within 2%, each
  tracked frame's pose within 1e-3 m / 1e-3 rad, port-vs-reference ATE
  under 5 mm.  In both packages that frame is tracked from the last pose
  again, not relocalized: the noise frame leaves the carry as it was,
  and frame 5 is the frame before it.
- Relocalization proper, port only: after 60 frames of the "walk" the
  same traffic's frame 5 is out of the tracker's reach (the camera has
  turned ~39 degrees) and is relocalized, and frames 4..0 are tracked
  under the post-relocalization gate, each as close to ground truth as
  the worst frame of the walk before the loss, plus 2 cm (at 192x144
  the walk tracks 7-12 cm from ground truth in both packages).  The
  reference's ``relocalize`` compiles for over two minutes on the CPU
  (its LM refine and projection search with the plane and line
  families), past this file's budget; its parts are held against the
  reference here (words, candidates, the RANSAC cores) and in
  tests/test_torch_matching.py (matching, the LM solve and the
  projection search).
- convert's state carry: the reference System's map and back-end state
  through the port and back, equal.
- The reference's test_auto_reset_on_early_loss on the port, and
  localization mode adding no keyframe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.geometry import se3 as jse3
from manhattanslam_tpu.io import trajectory as traj_io
from manhattanslam_tpu.ops import ransac_pose as jransac
from manhattanslam_tpu.system import System as JaxSystem
from manhattanslam_tpu_torch import convert
from manhattanslam_tpu_torch.ops import ransac_pose
from manhattanslam_tpu_torch.reloc.relocalizer import Relocalizer
from manhattanslam_tpu_torch.slam_map import SlamMap
from manhattanslam_tpu_torch.system import System
from torch_parity import port_cfg, rot_angle

CPU = torch.device("cpu")
K_NP = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def reference_samples(valid, key, n_hyp: int, n_sample: int) -> np.ndarray:
    """The hypotheses' indices as the reference's one_hyp draws them."""
    p = jnp.asarray(valid, jnp.float32)
    p = p / jnp.sum(p).clip(1e-9)
    idx_all = jnp.arange(len(valid))
    keys = jax.random.split(key, n_hyp)
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, idx_all, (n_sample,), replace=False, p=p))(keys))


def scene(seed: int, xi, n: int = 80, n_out: int = 24):
    """World points, the true pose and its pixels, as tests/test_reloc.py
    builds them."""
    rng = np.random.default_rng(seed)
    T = np.asarray(jse3.exp_se3(jnp.array(xi, jnp.float32)))
    pw = rng.uniform([-2, -2, 2], [2, 2, 6], (n, 3)).astype(np.float32)
    pc = pw @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([pc[:, 0] / pc[:, 2] * 300 + 160, pc[:, 1] / pc[:, 2] * 300 + 120], -1)
    valid = np.ones(n, bool)
    valid[rng.choice(n, 5, replace=False)] = False  # a few unusable pairs
    return rng, T, pw, pc.astype(np.float32), uv.astype(np.float32), valid


def _assert_result(got: dict, want: dict, atol: float = 1e-5):
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(want["R"]), rtol=0, atol=atol)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]), rtol=0, atol=atol)
    np.testing.assert_array_equal(got["inlier_mask"].numpy(), np.asarray(want["inlier_mask"]))
    assert int(got["n_inliers"]) == int(want["n_inliers"])
    assert bool(got["ok"]) == bool(want["ok"])


def test_kabsch_matches_reference():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(16, 10, 3)).astype(np.float32)
    B = (A @ np.asarray(jse3.exp_so3(jnp.array([0.2, -0.4, 0.1]))).T + 0.3
         + 0.01 * rng.normal(size=A.shape)).astype(np.float32)
    w = rng.uniform(0, 1, (16, 10)).astype(np.float32)
    R_ref, t_ref = jax.vmap(jransac.kabsch)(jnp.asarray(A), jnp.asarray(B), jnp.asarray(w))
    R, t = ransac_pose.kabsch(_t(A), _t(B), _t(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=0, atol=1e-5)
    # a reflection in the best fit comes back as a rotation
    assert np.allclose(np.linalg.det(R.numpy()), 1.0, atol=1e-5)


def test_ransac_3d3d_from_reference_samples():
    rng, T, pw, pc, uv, valid = scene(1, [0.3, 0.1, -0.2, 0.1, -0.05, 0.2])
    pc[:24] += rng.uniform(0.5, 2.0, (24, 3)).astype(np.float32)  # outliers
    key = jax.random.PRNGKey(0)
    want = jransac.pose_ransac_3d3d(jnp.asarray(pw), jnp.asarray(pc), jnp.asarray(uv),
                                    jnp.asarray(valid), jnp.asarray(K_NP), key)
    sel = reference_samples(valid, key, 256, 3)
    got = ransac_pose.pose_ransac_3d3d_from_samples(_t(pw), _t(pc), _t(uv), _t(valid), _t(K_NP),
                                                    _t(sel))
    _assert_result(got, want)
    assert int(got["n_inliers"]) >= 80 - 24 - 5 - 5
    # the port's own sampler reaches the same pose and inliers
    own = ransac_pose.pose_ransac_3d3d(_t(pw), _t(pc), _t(uv), _t(valid), _t(K_NP),
                                       torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(own["inlier_mask"].numpy(), got["inlier_mask"].numpy())
    np.testing.assert_allclose(own["R"].numpy(), T[:3, :3], rtol=0, atol=2e-3)


def test_ransac_pnp_from_reference_samples():
    rng, T, pw, pc, uv, valid = scene(2, [-0.2, 0.15, 0.1, 0.2, 0.1, -0.3])
    uv[:24] += rng.uniform(30, 120, (24, 2)).astype(np.float32)  # outliers
    key = jax.random.PRNGKey(3)
    want = jransac.pose_ransac_pnp(jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(valid),
                                   jnp.asarray(K_NP), key)
    sel = reference_samples(valid, key, 128, 6)
    got = ransac_pose.pose_ransac_pnp_from_samples(_t(pw), _t(uv), _t(valid), _t(K_NP), _t(sel))
    _assert_result(got, want, atol=3e-5)
    own = ransac_pose.pose_ransac_pnp(_t(pw), _t(uv), _t(valid), _t(K_NP),
                                      torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(own["inlier_mask"].numpy(), got["inlier_mask"].numpy())
    np.testing.assert_allclose(own["R"].numpy(), T[:3, :3], rtol=0, atol=5e-3)


# ---------------------------------------------------------- the milestone
def _pad_with_clones(m, reloc):
    """tests/test_reloc.py's padding: clones of keyframe 0 until the map
    holds 6 keyframes, each indexed by the relocalizer."""
    while m.n_kf <= 5:
        feats0 = {"xy_und": m.kf_xy[0], "u_right": m.kf_uright[0], "depth": m.kf_depth[0],
                  "level": m.kf_level[0], "angle": m.kf_angle[0], "desc": m.kf_desc[0],
                  "valid": m.kf_kp_valid[0]}
        kf = m.add_keyframe(m.kf_pose[0], 0.01 * m.n_kf, 0, feats0)
        m.set_kf_matches(kf, m.kf_mp_idx[0])
        reloc.add_keyframe(kf)


def forced_loss(system, reloc, seq, n_frames: int):
    """tests/test_reloc.py's forced-loss traffic after n_frames of seq:
    the map padded to 6 keyframes with clones of keyframe 0 where it has
    fewer, one noise frame (LOST), then frames 5, 4, ..., 0 (all of them:
    the reference's test stops at the first tracked one).  Returns the
    pose of each call and the frame id of the first pose after the loss."""
    poses = []
    for i in range(n_frames):
        t, gray, depth = seq.frame(i)
        poses.append(system.track(gray, depth, t))
    _pad_with_clones(system.map, reloc)
    rng = np.random.default_rng(0)
    noise = rng.uniform(0, 255, gray.shape).astype(np.float32)
    nd = rng.uniform(0.5, 6.0, depth.shape).astype(np.float32)
    poses.append(system.track(noise, nd, n_frames / 30.0))
    assert system.tracker.state == "LOST"
    for i in range(5, -1, -1):
        t, gray, depth = seq.frame(i)
        poses.append(system.track(gray, depth, (n_frames + 6 - i) / 30.0))
    back = [j for j in range(n_frames + 1, len(poses)) if poses[j] is not None]
    return poses, back[0] if back else None


@pytest.fixture(scope="module")
def milestone(small_cfg):
    seq = SyntheticSequence(n_frames=12, cam=small_cfg.camera)
    ref = JaxSystem(small_cfg, enable_planes=False, enable_lines=False, enable_surfels=False,
                    fast=True)
    port = System(port_cfg(small_cfg), device="cpu")
    poses_ref, at_ref = forced_loss(ref, ref.tracker.reloc_module, seq, 6)
    poses, at = forced_loss(port, port.reloc_module, seq, 6)
    return seq, ref, port, poses_ref, at_ref, poses, at


def test_system_recovers_like_reference(milestone):
    _, ref, port, poses_ref, at_ref, poses, at = milestone
    assert at is not None and at == at_ref == 7
    assert [p is not None for p in poses] == [p is not None for p in poses_ref]
    assert [r[2] for r in port.tracker.frame_log] == [r[2] for r in ref.tracker.frame_log]
    assert port.tracker.last_reloc_frame_id == ref.tracker.last_reloc_frame_id
    assert port.tracker.state == ref.tracker.state == "OK"


def test_system_keyframes_and_map_like_reference(milestone):
    _, ref, port, _, _, _, _ = milestone
    assert port.map.n_kf == ref.map.n_kf == 6
    assert port.map.kf_free == ref.map.kf_free
    np.testing.assert_array_equal(port.map.kf_valid, ref.map.kf_valid)
    np.testing.assert_array_equal(port.map.kf_frame_id, ref.map.kf_frame_id)
    n, n_ref = int(port.map.mp_valid.sum()), int(ref.map.mp_valid.sum())
    assert abs(n - n_ref) <= 0.02 * n_ref, (n, n_ref)


def test_system_poses_and_ate_like_reference(milestone, tmp_path):
    _, ref, port, poses_ref, _, poses, _ = milestone
    for i, (a, b) in enumerate(zip(poses_ref, poses)):
        if a is None:
            continue
        d = np.linalg.inv(a.astype(np.float64)) @ b.astype(np.float64)
        assert np.linalg.norm(d[:3, 3]) < 1e-3 and rot_angle(d[:3, :3]) < 1e-3, i
    fa, fb = tmp_path / "ref.txt", tmp_path / "port.txt"
    ref.save_trajectory_tum(str(fa))
    port.save_trajectory_tum(str(fb))
    ts_r, p_r, _ = traj_io.load_trajectory_tum(str(fa))
    ts_p, p_p, _ = traj_io.load_trajectory_tum(str(fb))
    assert len(ts_p) == len(ts_r)
    assert traj_io.ate_rmse((ts_p, p_p), (ts_r, p_r)) < 5e-3


def test_bow_and_candidates_like_reference(milestone, small_cfg):
    _, ref, port, _, _, _, _ = milestone
    jreloc = ref.tracker.reloc_module
    rng = np.random.default_rng(3)
    desc = rng.integers(0, 2**32, (256, 8), dtype=np.uint64).astype(np.uint32)
    valid = rng.uniform(size=256) < 0.9
    pcfg = port_cfg(small_cfg)
    reloc = Relocalizer(pcfg, SlamMap(pcfg), CPU)
    np.testing.assert_array_equal(reloc.compute_bow(desc, valid), jreloc.compute_bow(desc, valid))
    # every live keyframe indexed with its own words
    pm = port.map
    for kf in np.nonzero(pm.kf_valid[: pm.n_kf])[0]:
        np.testing.assert_array_equal(port.reloc_module.kf_bow[kf],
                                      reloc.compute_bow(pm.kf_desc[kf], pm.kf_kp_valid[kf]))
    # candidates on the reference's map, carried across
    reloc.map = convert.slam_map_from_numpy(pcfg, convert.map_to_numpy(ref.map))
    convert.load_backend_state(convert.backend_state_to_numpy(
        ref.local_mapper, jreloc, ref.tracker), reloc=reloc)
    m = ref.map
    for kf in range(m.n_kf):
        feats = {"desc": jnp.asarray(m.kf_desc[kf]), "valid": jnp.asarray(m.kf_kp_valid[kf])}
        want = jreloc.detect_candidates(feats)
        assert reloc.detect_candidates(m.kf_desc[kf], m.kf_kp_valid[kf]) == want
        assert len(want) >= 1


def test_convert_carries_map_and_backend_state(milestone, small_cfg):
    _, ref, _, _, _, _, _ = milestone
    pcfg = port_cfg(small_cfg)
    system = System(pcfg, device="cpu")
    tables = convert.map_to_numpy(ref.map)
    state = convert.backend_state_to_numpy(ref.local_mapper, ref.tracker.reloc_module, ref.tracker)
    assert state["recent_points"] and state["records"]
    m = convert.slam_map_from_numpy(pcfg, tables)
    convert.load_backend_state(state, system.local_mapper, system.reloc_module, system.tracker)
    back = convert.map_to_numpy(m)
    for k, v in tables.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        else:
            assert back[k] == v, k
    got = convert.backend_state_to_numpy(system.local_mapper, system.reloc_module, system.tracker)
    assert got["recent_points"] == state["recent_points"]
    assert got["last_reloc_frame_id"] == state["last_reloc_frame_id"]
    np.testing.assert_array_equal(got["kf_bow"], state["kf_bow"])
    for a, b in zip(got["records"], state["records"], strict=True):
        assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3]
        np.testing.assert_array_equal(a[2], b[2])


def test_port_relocalizes_a_frame_out_of_reach(small_cfg):
    n = 60
    seq = SyntheticSequence(n_frames=n, cam=small_cfg.camera, view="walk")
    system = System(port_cfg(small_cfg), device="cpu")
    poses, at = forced_loss(system, system.reloc_module, seq, n)
    assert system.map.n_kf >= 6  # no clone was needed
    assert at == n + 1 and system.tracker.last_reloc_frame_id == at
    assert system.reloc_module.last_path == "3d3d"
    assert system.reloc_module.last_kf >= 0 and system.map.kf_valid[system.reloc_module.last_kf]
    assert all(p is not None for p in poses[at:])
    # frames 4..0 passed the post-relocalization gate of >= 20 inliers
    assert all(r[2] and r[1] >= 20 for r in system.tracker.frame_log[at + 1:])

    def gt_error(T, i):  # the map's world is frame 0's camera
        gt_cw = np.linalg.inv(seq.poses[i].astype(np.float64)) @ seq.poses[0]
        return np.linalg.norm((np.linalg.inv(gt_cw) @ T.astype(np.float64))[:3, 3])

    worst = max(gt_error(poses[i], i) for i in range(n))
    for T, i in zip(poses[at:], range(5, -1, -1)):
        assert gt_error(T, i) <= worst + 0.02, i


def test_auto_reset_on_early_loss(small_cfg):
    """tests/test_reloc.py:115 on the port: a loss with <= 5 keyframes
    resets the system, which re-initializes on the next good frame."""
    seq = SyntheticSequence(n_frames=12, cam=small_cfg.camera)
    system = System(port_cfg(small_cfg), device="cpu")
    for i in range(4):
        t, gray, depth = seq.frame(i)
        system.track(gray, depth, t)
    assert 1 <= system.map.n_kf <= 5
    rng = np.random.default_rng(1)
    noise = rng.uniform(0, 255, gray.shape).astype(np.float32)
    nd = rng.uniform(0.5, 6.0, depth.shape).astype(np.float32)
    assert system.track(noise, nd, 0.5) is None
    assert system.map.n_kf == 0
    assert system.tracker.state == "NOT_INITIALIZED"
    assert system.local_mapper.map is system.map and system.reloc_module.map is system.map
    assert not system.local_mapper.recent_points and not system.reloc_module.kf_bow.any()
    t, gray, depth = seq.frame(4)
    assert system.track(gray, depth, 0.6) is not None
    assert system.map.n_kf == 1


def test_localization_mode_adds_no_keyframe(small_cfg):
    """The walk makes its second keyframe at frame 11; in localization
    mode it makes none, every frame still tracked, and a loss asks for no
    reset."""
    seq = SyntheticSequence(n_frames=40, cam=small_cfg.camera, view="walk")
    system = System(port_cfg(small_cfg), device="cpu")
    t, gray, depth = seq.frame(0)
    system.track(gray, depth, t)
    system.activate_localization_mode()
    for i in range(1, 14):
        t, gray, depth = seq.frame(i)
        assert system.track(gray, depth, t) is not None, i
    assert system.map.n_kf == 1
    assert bool(system.tracker.carry["vo_points"])
    rng = np.random.default_rng(1)
    noise = rng.uniform(0, 255, gray.shape).astype(np.float32)
    assert system.track(noise, rng.uniform(0.5, 6.0, depth.shape).astype(np.float32), 1.0) is None
    assert not system.tracker.request_reset and system.map.n_kf == 1
