"""The mapping back end of the port against the reference's, on the CPU at
small_cfg size.

The shared map: the port's ``System(enable_planes=True,
enable_lines=True)`` over 33 frames of the box room's "walk" view (3
keyframes; the last one's event culls, triangulates and fuses), with the
map and the mapper's points on probation
snapshotted before each keyframe's ``process_keyframe``.  The snapshot
comes from the port: the reference's full-body step compiles for over a
minute on the CPU, more than this file's budget; both packages then start
from the same converted snapshot, so where it came from does not matter
to the comparison.

- ``triangulate_pairs`` and ``fuse_candidates_batch`` on the last
  keyframe's neighbours and fusion targets: ``ok``, ``idx2`` and
  ``kp_idx`` equal, ``pos_w`` within 1e-5 m widened by the two-ray
  solve's float32 conditioning (``solve_tolerance``).  The two libraries
  round 3-term products differently (XLA's and torch's CPU matrix
  products, FMA or not, differ on 200 of 200 random 50x3 by 3x3
  products), and a low-parallax midpoint solve amplifies that: a point
  7.1 m away seen with 2.5 degrees of parallax is 0.24 mm from a float64
  solve in the reference, 0.57 mm in the port, while the points seen
  with 14 degrees agree within 3e-6 m.
- Stage parity: the last keyframe's ``process_keyframe`` in both packages
  from the snapshot: every map table equal, except the positions,
  normals and scale distances, within 1e-5 (the points triangulated in
  the call: within their solve tolerance, the normal within twice it
  over the distance, the scale distances within it times 1.2^7); the
  points on probation equal.  The call culls and triangulates.
- ``retire_keyframe``: the records re-anchored on the parent as the
  reference's tracker does, the trajectory unchanged, the spanning tree,
  the freed slot, and its reuse by the next keyframe, in both packages.
- The device view after a retirement and a slot reuse, brought up to
  date by row diffs, equals a full upload.
"""

import numpy as np
import pytest
import torch

from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.frontend.fast_tracking import FastTracker as JaxFastTracker
from manhattanslam_tpu.frontend.tracking import FrameRecord as JaxFrameRecord
from manhattanslam_tpu.mapping.local_mapping import LocalMapper as JaxLocalMapper
from manhattanslam_tpu.slam_map import SlamMap as JaxSlamMap
from manhattanslam_tpu_torch import convert, tracing
from manhattanslam_tpu_torch.frontend import device_tracker as pdt
from manhattanslam_tpu_torch.frontend.fast_tracking import FastTracker
from manhattanslam_tpu_torch.mapping import triangulation as ptri
from manhattanslam_tpu_torch.mapping.local_mapping import LocalMapper
from manhattanslam_tpu_torch.system import System
from torch_parity import port_cfg

N_WALK = 33
CPU = torch.device("cpu")
FLOAT_TABLES = ("mp_pos", "mp_normal", "mp_min_dist", "mp_max_dist")


def center(T_cw: np.ndarray) -> np.ndarray:
    return -T_cw[:3, :3].T.astype(np.float64) @ T_cw[:3, 3]


def solve_tolerance(p: np.ndarray, c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """1e-5 m widened by the float32 conditioning of the midpoint solve of
    rays from c1 and c2 meeting at p (..., 3): 4 float32 epsilons of the
    distance over sin^2 of the parallax (7.1 m at 2.5 degrees: 1.8 mm;
    2.2 m at 14 degrees: 2.7e-5 m)."""
    r1, r2 = p - c1, p - c2
    n1, n2 = np.linalg.norm(r1, axis=-1), np.linalg.norm(r2, axis=-1)
    cos = np.sum(r1 * r2, -1) / (n1 * n2)
    return 1e-5 + 4 * np.finfo(np.float32).eps * n1 / np.maximum(1 - cos**2, 1e-12)


def jax_map(cfg, tables: dict) -> JaxSlamMap:
    """A reference SlamMap holding copies of convert.map_to_numpy's tables."""
    m = JaxSlamMap(cfg)
    for k in convert.MAP_TABLES:
        getattr(m, k)[...] = tables[k]
    for k in convert.MAP_SCALARS:
        setattr(m, k, tables[k])
    for k in convert.MAP_REGISTRIES:
        setattr(m, k, dict(tables[k]))
    m.kf_free = list(tables["kf_free"])
    m.kf_not_erase = set(tables["kf_not_erase"])
    return m


@pytest.fixture(scope="module")
def mapped(small_cfg):
    pcfg = port_cfg(small_cfg)
    seq = SyntheticSequence(n_frames=N_WALK, cam=small_cfg.camera, view="walk")
    system = System(pcfg, fast=True, enable_planes=True, enable_lines=True, enable_surfels=False,
                    device="cpu")
    snaps = []
    process = system.local_mapper.process_keyframe

    def snapshot_then_process(kf_id):
        snaps.append((kf_id, convert.map_to_numpy(system.map),
                      list(system.local_mapper.recent_points)))
        process(kf_id)

    system.local_mapper.process_keyframe = snapshot_then_process
    for i in range(N_WALK):
        ts, gray, depth = seq.frame(i)
        assert system.track(gray, depth, ts) is not None, i
    return system, snaps


@pytest.fixture
def last_kf(mapped, small_cfg):
    """Both packages' maps and mappers, new for each test, at the snapshot
    before the last keyframe's process_keyframe."""
    _, snaps = mapped
    kf_id, tables, recent = snaps[-1]
    pcfg = port_cfg(small_cfg)
    ref = JaxLocalMapper(small_cfg, jax_map(small_cfg, tables))
    port = LocalMapper(pcfg, convert.slam_map_from_numpy(pcfg, tables), CPU)
    ref.recent_points = list(recent)
    convert.load_backend_state({"recent_points": recent}, local_mapper=port)
    return kf_id, tables, ref, port


def _culled(last_kf):
    """last_kf after the event's first stage, point culling, in both
    packages: the keypoints it frees are what triangulation takes."""
    kf_id, _, ref, port = last_kf
    ref.cull_map_points(kf_id)
    port.cull_map_points(kf_id)
    return kf_id, ref, port


def test_walk_makes_keyframes_and_the_back_end_runs(mapped):
    system, snaps = mapped
    assert [kf for kf, _, _ in snaps] == list(range(len(snaps)))
    assert len(snaps) >= 3
    stage = tracing.by_leaf(system.trace.snapshot(), ("create_and_fuse",))["create_and_fuse"]
    assert stage[0] > 0 and stage[1] == system.local_mapper.counts["events"]
    ids = system.map.kf_mp_idx[: system.map.n_kf]
    assert system.map.mp_valid[ids[ids >= 0]].all()
    np.testing.assert_array_equal(system.map.covis, system.map.covis.T)


def test_triangulate_pairs_matches_reference(last_kf):
    kf_id, ref, port = _culled(last_kf)
    job_ref, job = ref._tri_dispatch(kf_id), port._tri_dispatch(kf_id)
    assert job_ref is not None and job is not None
    assert job[1] == job_ref[1]
    n = len(job[1])
    want = {k: np.asarray(v)[:n] for k, v in job_ref[0].items()}
    got = {k: v.numpy() for k, v in job[0].items()}
    np.testing.assert_array_equal(got["ok"], want["ok"])
    np.testing.assert_array_equal(got["idx2"], want["idx2"])
    ok = want["ok"]
    assert ok.sum() >= 1
    poses = port.map.kf_pose
    for j, nb in enumerate(job[1]):
        p = want["pos_w"][j][ok[j]].astype(np.float64)
        tol = solve_tolerance(p, center(poses[kf_id]), center(poses[nb]))
        err = np.linalg.norm(got["pos_w"][j][ok[j]] - p, axis=-1)
        assert (err <= tol).all(), (err, tol)
    # the single pair is the stack at S = 1
    one = ptri.triangulate_pair(
        port._kf_kp_view(kf_id, True), port._kf_kp_view(job[1][0], True),
        torch.from_numpy(port.map.kf_pose[kf_id]), torch.from_numpy(port.map.kf_pose[job[1][0]]),
        port.K, port.cfg.orb.scale_factor)
    np.testing.assert_array_equal(one["ok"].numpy(), got["ok"][0])


def test_fuse_candidates_batch_matches_reference(last_kf):
    kf_id, ref, port = _culled(last_kf)
    job_ref, job = ref._fuse_dispatch(kf_id), port._fuse_dispatch(kf_id)
    assert job_ref is not None and job is not None
    targets = [nb for nb, _, j in job[2] if j is not None]
    assert targets == [nb for nb, _, j in job_ref[2] if j is not None]
    n_bank = len(job[2][0][1])
    np.testing.assert_array_equal(job[2][0][1], job_ref[2][0][1][:n_bank])
    outs, outs_ref = job[0], job_ref[0]
    for k in ("ok", "kp_idx"):
        np.testing.assert_array_equal(
            outs[k].numpy(), np.asarray(outs_ref[k])[: len(targets), :n_bank], err_msg=k)
    assert int(outs["ok"].sum()) >= 1
    if job[1] is not None:
        n2 = len(job[2][-1][1])
        for k in ("ok", "kp_idx"):
            np.testing.assert_array_equal(job[1][k].numpy(), np.asarray(job_ref[1][k])[:n2])


def test_process_keyframe_stage_parity(last_kf):
    kf_id, tables, ref, port = last_kf
    ref.process_keyframe(kf_id)
    port.process_keyframe(kf_id)
    a, b = convert.map_to_numpy(ref.map), convert.map_to_numpy(port.map)
    # the points triangulated in the call and the other keyframe seeing each
    new = np.nonzero(a["mp_valid"] & (a["mp_first_kf"] == kf_id)
                     & (a["mp_pos"] != tables["mp_pos"]).any(-1))[0]
    assert len(new) >= 1, "no point triangulated"
    tol = {k: np.full(a[k].shape[0], 1e-5) for k in FLOAT_TABLES}
    live = np.nonzero(a["kf_valid"][: a["n_kf"]])[0]
    for i in new:
        # the neighbour it was triangulated with: the other keyframe seeing
        # it; when a later point took that keypoint, the least parallax of
        # any keyframe
        seen = np.nonzero((a["kf_mp_idx"][: a["n_kf"]] == i).any(-1))[0]
        others = [k for k in seen if k != kf_id] or [k for k in live if k != kf_id]
        p = a["mp_pos"][i].astype(np.float64)
        t = max(solve_tolerance(p, center(a["kf_pose"][kf_id]), center(a["kf_pose"][k]))
                for k in others)
        dist = np.linalg.norm(p - center(a["kf_pose"][kf_id]))
        tol["mp_pos"][i], tol["mp_normal"][i] = t, 2 * t / dist
        tol["mp_min_dist"][i], tol["mp_max_dist"][i] = t, t * 1.2**7
    for k in a:
        if k in FLOAT_TABLES:
            err = np.abs(b[k] - a[k]).reshape(len(a[k]), -1).max(-1)
            assert (err <= tol[k]).all(), (k, np.nonzero(err > tol[k])[0])
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            assert b[k] == a[k], k
    assert port.recent_points == ref.recent_points
    assert ((tables["kf_mp_idx"] >= 0) & (a["kf_mp_idx"] < 0)).any(), "no point culled"


def _feats_of(m, kf: int) -> dict:
    return {"xy_und": m.kf_xy[kf], "u_right": m.kf_uright[kf], "depth": m.kf_depth[kf],
            "level": m.kf_level[kf], "angle": m.kf_angle[kf], "desc": m.kf_desc[kf],
            "valid": m.kf_kp_valid[kf]}


def test_retire_keyframe_reanchors_and_reuses_the_slot(mapped, small_cfg):
    system, snaps = mapped
    pcfg = port_cfg(small_cfg)
    tables = convert.map_to_numpy(system.map)
    state = convert.backend_state_to_numpy(system.local_mapper, system.reloc_module, system.tracker)
    port = FastTracker(pcfg, convert.slam_map_from_numpy(pcfg, tables), CPU)
    convert.load_backend_state(state, tracker=port)
    ref = JaxFastTracker(small_cfg, jax_map(small_cfg, tables), enable_planes=False,
                         enable_lines=False)
    ref.records = [JaxFrameRecord(t, kf, T.copy(), lost) for t, kf, T, lost in state["records"]]
    port.ref_kf = ref.ref_kf = system.tracker.ref_kf
    before = port.trajectory_rows()
    kf = 1
    assert any(r.ref_kf == kf for r in port.records)
    children = np.nonzero(tables["kf_parent"] == kf)[0]
    for t in (ref, port):
        t.map.retire_keyframe(kf)
    a, b = convert.map_to_numpy(ref.map), convert.map_to_numpy(port.map)
    for k in ("kf_valid", "kf_mp_idx", "kf_pl_idx", "kf_ml_idx", "covis", "kf_parent"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert b["kf_free"] == a["kf_free"] == [kf]
    assert b["last_kf_added"] == a["last_kf_added"]
    assert (b["kf_parent"][children] == tables["kf_parent"][kf]).all()
    assert not any(r.ref_kf == kf for r in port.records)
    for r, r_ref in zip(port.records, ref.records):
        assert r.ref_kf == r_ref.ref_kf
        np.testing.assert_allclose(r.T_cr, r_ref.T_cr, rtol=0, atol=1e-6)
    for (t0, p0, q0), (t1, p1, q1) in zip(before, port.trajectory_rows()):
        assert t0 == t1
        np.testing.assert_allclose(p1, p0, rtol=0, atol=1e-5)
    # the root is never retired
    for t in (ref, port):
        t.map.retire_keyframe(0)
    assert port.map.kf_valid[0] and port.map.kf_free == ref.map.kf_free == [kf]
    # the next keyframe takes the freed slot
    feats = _feats_of(port.map, 0)
    new = [t.map.add_keyframe(port.map.kf_pose[0], 9.0, 99, feats) for t in (ref, port)]
    assert new == [kf, kf] and port.map.kf_free == ref.map.kf_free == []
    assert port.map.kf_parent[kf] == ref.map.kf_parent[kf]


def test_view_after_retire_and_reuse_equals_full_upload(mapped, small_cfg):
    system, _ = mapped
    pcfg = port_cfg(small_cfg)
    m = convert.slam_map_from_numpy(pcfg, convert.map_to_numpy(system.map))
    tracker = FastTracker(pcfg, m, CPU, enable_planes=True, enable_lines=True)
    tracker.ref_kf = system.tracker.ref_kf
    tracker.reg2, tracker.reg3 = system.tracker.reg2.copy(), system.tracker.reg3.copy()
    tracker.refresh_view()

    def assert_view_is_the_map():
        full = pdt.upload_view(
            pdt.build_host_view(pcfg, m, tracker.ref_kf, tracker.reg2, tracker.reg3), CPU)
        for k in full:
            assert torch.equal(tracker.view[k], full[k]), k

    kf = int(np.nonzero(m.kf_valid[1:])[0][0]) + 1
    pose_before = m.kf_pose[kf].copy()
    m.retire_keyframe(kf)
    tracker.refresh_view()
    assert_view_is_the_map()
    assert (tracker.view["kf_pl_idx"][kf] == -1).all()
    T = m.kf_pose[0].copy()
    T[:3, 3] += 0.5
    assert m.add_keyframe(T, 9.0, 99, _feats_of(m, 0)) == kf
    m.kf_pl_idx[kf, 0] = int(np.nonzero(m.pl_valid)[0][0])
    tracker.refresh_view()
    assert_view_is_the_map()
    assert not np.array_equal(tracker.view["kf_pose"][kf].numpy(), pose_before)
