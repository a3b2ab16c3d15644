"""Chunk mode and the pipeline in the port (counterpart of
tests/test_chunked.py and of tests/test_e2e_tracking.py's pipelined reset),
on the CPU at small_cfg size.

- ``pack_frame`` / ``unpack_frame`` against the reference's, on the bounds
  of its round-trip test.
- The port's chunk step (4 frames, one of them lost) bit for bit against
  4 calls of the port's frame step (which tests/test_torch_manhattan.py
  holds against the reference's): results, final carry, and the landmark
  counts against the host-side accumulation of the frame path.
- The one-transfer ``pull_summary`` against a pull of each key.
- tests/test_chunked.py's bounds on the port's System (corner view,
  chunk=4, planes and lines on, as the reference's defaults): every frame
  recorded and tracked, ATE under 5 cm, a map; the partial-chunk flush;
  bench.py's pipelined configuration; the mid-chunk loss recovered from
  the relocalization with the reset carry; the incremental view equal to
  a full upload.
- tests/test_e2e_tracking.py:118-135: a reset with ``pipeline=True`` at
  chunk 1 keeps the flag.

The System against the reference's System(chunk=4) compiles the
reference's chunk step (~85 s on the CPU), so it is marked ``slow`` and
left out of tier-1.
"""

import numpy as np
import pytest
import torch

from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.frontend import device_tracker as jdt
from manhattanslam_tpu.io import trajectory as traj_io
from manhattanslam_tpu_torch.frontend import device_tracker as pdt
from manhattanslam_tpu_torch.frontend.graphed_step import clone_tree
from manhattanslam_tpu_torch.system import System
from torch_parity import port_cfg, rot_angle

CPU = torch.device("cpu")
N_FRAMES = 13


def _ate(system, seq) -> float:
    rows = system.tracker.trajectory_rows()
    gt = seq.gt_rows()
    ts = np.array([r[0] for r in rows])
    return traj_io.ate_rmse(
        (ts, np.array([r[1] for r in rows])),
        (np.array([r[0] for r in gt]), np.array([r[1] for r in gt])))


def _run(system, seq, n=None):
    for i in range(len(seq) if n is None else n):
        ts, gray, depth = seq.frame(i)
        system.track(gray, depth, ts)
    return system


@pytest.fixture(scope="module")
def corner(small_cfg):
    return SyntheticSequence(n_frames=N_FRAMES, cam=small_cfg.camera, view="corner")


@pytest.fixture(scope="module")
def chunked(small_cfg, corner):
    """The port's System(chunk=4) over the 13 corner frames, planes and
    lines on (the defaults), then shut down."""
    system = _run(System(port_cfg(small_cfg), fast=True, enable_surfels=False, chunk=4, device="cpu"), corner)
    system.shutdown()
    return system


def test_pack_unpack_match_reference():
    import jax

    rng = np.random.default_rng(3)
    H, W = 32, 48
    gray = rng.uniform(0, 255, (H, W)).astype(np.float32)
    depth = rng.uniform(0, 12.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.2] = 0.0
    packed = pdt.pack_frame(gray, depth)
    assert packed.dtype == np.uint8 and packed.shape == (H, 3 * W)
    assert np.array_equal(packed, jdt.pack_frame(gray, depth))
    g2, d2 = pdt.unpack_frame(torch.from_numpy(packed), W)
    g_ref, d_ref = jax.jit(lambda p: jdt.unpack_frame(p, W))(packed)
    assert np.array_equal(g2.numpy(), np.asarray(g_ref))
    assert np.array_equal(d2.numpy(), np.asarray(d_ref))
    assert np.array_equal(g2.numpy(), np.round(gray))
    assert np.max(np.abs(d2.numpy() - depth)) <= 0.6 / pdt.DEPTH_QUANT
    assert np.all(d2.numpy()[depth == 0] == 0)


def _chunk_frames(small_cfg, corner):
    """Frames 11, black, 12, 11 of the corner view, as the step takes them."""
    frames = [corner.frame(11)[1:], None, corner.frame(12)[1:], corner.frame(11)[1:]]
    h, w = small_cfg.camera.height, small_cfg.camera.width
    frames[1] = (np.zeros((h, w), np.float32), np.zeros((h, w), np.float32))
    native = [pdt.to_native(g, d) for g, d in frames]
    g8 = torch.from_numpy(np.stack([g for g, _ in native]))
    d16 = torch.from_numpy(np.stack([d.astype(np.int32) for _, d in native]))
    return g8, d16


@pytest.fixture(scope="module")
def stepped(small_cfg, corner, chunked):
    """The chunk step and 4 frame steps from the chunked System's final
    carry, against its view."""
    pcfg = port_cfg(small_cfg)
    tr = chunked.tracker
    g8, d16 = _chunk_frames(small_cfg, corner)
    step = pdt.build_frame_step(pcfg, CPU, True, True)
    carry = clone_tree(tr.carry)
    singles = []
    for i in range(4):
        res, carry = step(g8[i], d16[i], carry, tr.view)
        singles.append(res)
    chunk = pdt.build_chunk_step(pcfg, CPU, True, True)
    results, carry_c = chunk(g8, d16, clone_tree(tr.carry), tr.view)
    return pcfg, singles, carry, results, carry_c


def test_chunk_step_equals_frame_steps(stepped):
    pcfg, singles, carry, results, carry_c = stepped
    assert [bool(r["tracked_ok"]) for r in singles] == [True, False, True, True]
    for k in carry:
        assert torch.equal(carry[k], carry_c[k]), k
    for i, r in enumerate(singles):
        for k in ("core_flat", "kfx_flat", "payload_flat", "plane_membership"):
            assert torch.equal(results[k][i], r[k]), (i, k)
        for k in r["feats"]:
            assert torch.equal(results["feats"][k][i], r["feats"][k]), (i, k)
    # the counts: the frame path's host accumulation (tracked frames only)
    c = pcfg.caps
    lay = pdt.flat_layouts(singles[0])
    cores, stats = pdt.pull_chunk_summary(results, lay["core"], c.max_map_points,
                                          c.max_map_lines)
    want = {k: np.zeros(n, np.int32) for k, n in zip(
        pdt.STAT_KEYS, (c.max_map_points, c.max_map_points, c.max_map_lines, c.max_map_lines))}
    for r, core in zip(singles, cores):
        s = pdt.pull_summary(r)
        assert bool(core["tracked_ok"]) == bool(s["tracked_ok"])
        assert np.array_equal(core["T"], s["T"])
        if not s["tracked_ok"]:
            continue
        want["mp_visible"][s["visible"]] += 1
        want["mp_found"][s["matched"] & s["visible"]] += 1
        want["ml_visible"][s["ml_visible"]] += 1
        np.add.at(want["ml_found"], s["line_assoc"][s["line_assoc"] >= 0], 1)
    assert want["ml_found"].sum() > 0 and want["mp_found"].sum() > 0
    for k in pdt.STAT_KEYS:
        assert np.array_equal(stats[k], want[k]), k


def test_pull_summary_is_one_transfer_of_the_per_key_pull(stepped):
    _, singles, _, _, _ = stepped
    r = singles[0]
    s = pdt.pull_summary(r)
    keys = ("T", "tracked_ok", "n_inliers", "n_map_inliers", "n_matches", "tracked_close",
            "nontracked_close", "kp_mp", "matched", "visible", "manhattan_found",
            "use_manhattan", "new_plane", "plane_assoc", "plane_valid", "line_assoc",
            "ml_visible")
    assert set(s) == set(keys)
    for k in keys:
        assert np.array_equal(s[k], r[k].numpy()), k
    assert s["matched"].any() and s["visible"].any() and s["ml_visible"].any()


def test_chunked_all_frames_recorded_and_tracked(chunked):
    recs = chunked.tracker.records
    assert len(recs) == N_FRAMES
    assert sum(not r.lost for r in recs) == N_FRAMES


def test_chunked_ate(chunked, corner):
    assert _ate(chunked, corner) < 0.05


def test_chunked_builds_map(chunked):
    assert chunked.map.n_kf >= 1
    assert chunked.map.mp_valid.sum() > 50


def test_chunked_flush_partial(small_cfg, corner):
    """A partial trailing chunk is flushed and recorded."""
    system = _run(System(port_cfg(small_cfg), fast=True, enable_surfels=False, chunk=4, device="cpu"), corner, 6)
    assert len(system.tracker.records) == 5
    system.shutdown()
    assert len(system.tracker.records) == 6


def test_chunked_pipelined_bench_config(small_cfg, corner):
    """bench.py's configuration (pipeline and chunks) through flush()."""
    system = _run(System(port_cfg(small_cfg), fast=True, enable_surfels=False, pipeline=True, chunk=4,
                          device="cpu"), corner)
    assert system.tracker.pipeline_depth == 2
    system.shutdown()
    recs = system.tracker.records
    assert len(recs) == N_FRAMES
    assert sum(not r.lost for r in recs) >= N_FRAMES - 1
    assert system.map.n_kf >= 1
    # bench.py's warmup() after the flush changes no result
    n_kf, last = system.map.n_kf, recs[-1].T_cr.copy()
    system.warmup()
    assert len(system.tracker.records) == N_FRAMES and system.map.n_kf == n_kf
    assert np.array_equal(system.tracker.records[-1].T_cr, last)


def test_chunked_midchunk_loss_recovery(small_cfg, corner):
    """A loss inside a chunk followed by a relocalization: the chunk's
    later frames run again from the reset carry, so recovery costs the lost
    frame only, and their poses are right (tests/test_chunked.py)."""
    system = System(port_cfg(small_cfg), fast=True, enable_planes=False, enable_lines=False,
                    enable_surfels=False, chunk=4, device="cpu")
    _run(system, corner, 9)  # 1 init + 2 chunks
    tr, m = system.tracker, system.map
    while m.n_kf <= 5:  # no auto reset (Tracking.cc:517-523)
        feats0 = {"xy_und": m.kf_xy[0], "u_right": m.kf_uright[0], "depth": m.kf_depth[0],
                  "level": m.kf_level[0], "angle": m.kf_angle[0], "desc": m.kf_desc[0],
                  "valid": m.kf_kp_valid[0]}
        kf = m.add_keyframe(m.kf_pose[0], 0.01 * m.n_kf, 0, feats0)
        m.set_kf_matches(kf, m.kf_mp_idx[0])
        tr.reloc_module.add_keyframe(kf)
    # the teleport: the reference keyframe bank no longer overlaps the
    # view, written in place as the graph reads it
    tr.view["ref_mp"].fill_(-1)
    tr._shadow["ref_mp"][:] = -1
    rng = np.random.default_rng(0)
    h, w = small_cfg.camera.height, small_cfg.camera.width
    frames = [(100.0, rng.uniform(0, 255, (h, w)).astype(np.float32),
               rng.uniform(0.5, 6.0, (h, w)).astype(np.float32))]
    frames += [(100.0 + 0.1 * i, *corner.frame(i)[1:]) for i in (1, 2, 3)]
    n_before = len(tr.records)
    for ts, gray, depth in frames:
        system.track(gray, depth, ts)
    system.shutdown()
    recs = tr.records[n_before:]
    assert len(recs) == 4
    assert recs[0].lost
    assert all(not r.lost for r in recs[1:]), [r.lost for r in recs]
    assert tr.counts["relocalized"] >= 1
    T0_inv = np.linalg.inv(corner.poses[0])
    for (_, t_wc, _), i in zip(tr.trajectory_rows()[-3:], (1, 2, 3)):
        c_gt = (T0_inv @ corner.poses[i])[:3, 3]
        assert np.linalg.norm(t_wc - c_gt) < 0.08, (i, t_wc, c_gt)


def test_reset_keeps_the_pipeline(small_cfg):
    """tests/test_e2e_tracking.py:118-135 on the port: a reset with the
    pipeline at chunk 1 keeps the flag and starts a new map."""
    seq = SyntheticSequence(n_frames=12, cam=small_cfg.camera)
    system = System(port_cfg(small_cfg), fast=True, enable_surfels=False, pipeline=True,
                    device="cpu")
    _run(system, seq, 3)
    system.reset()
    assert system.tracker.pipeline is True and system.tracker.chunk == 1
    assert system.map.n_kf == 0
    _run(system, seq, 4)
    system.shutdown()  # finishes the frame in flight
    assert system.map.n_kf >= 1
    assert len(system.tracker.records) == 4


def test_incremental_view_matches_full_rebuild(small_cfg, chunked):
    """After the chunked run's keyframe events and more map changes, the
    view written in place equals a fresh upload of the same map (last:
    it changes the shared System's map)."""
    tr, m = chunked.tracker, chunked.map
    rng = np.random.default_rng(0)
    m.add_points(
        rng.uniform(-2, 2, (17, 3)).astype(np.float32),
        rng.integers(0, 2**32, (17, 8), dtype=np.uint64).astype(np.uint32),
        np.tile(np.float32([0, 0, 1]), (17, 1)), np.zeros(17, np.float32),
        np.full(17, 9.0, np.float32), np.zeros(17, np.int32), 0,
    )
    tr.reg2[3, 4] = tr.reg2[4, 3] = 0
    ptrs = [v.data_ptr() for v in tr.view.values()]
    tr.refresh_view()
    assert [v.data_ptr() for v in tr.view.values()] == ptrs
    fresh = pdt.upload_view(
        pdt.build_host_view(port_cfg(small_cfg), m, tr.ref_kf, tr.reg2, tr.reg3), CPU)
    for k in fresh:
        assert torch.equal(tr.view[k], fresh[k]), k


@pytest.mark.slow
def test_system_chunked_matches_reference(small_cfg, corner, chunked):
    """The port's System(chunk=4) against the reference's
    System(fast=True, enable_surfels=False, chunk=4) on the 13 corner
    frames: poses within 1e-3 m and 1e-3 rad, ATE between the two under
    5 mm, the same keyframe frames."""
    from manhattanslam_tpu.system import System as JaxSystem

    ref = JaxSystem(small_cfg, fast=True, enable_surfels=False, chunk=4)
    for i in range(N_FRAMES):
        ts, gray, depth = corner.frame(i)
        ref.track(gray, depth, ts)
    ref.shutdown()
    rows_ref, rows = ref.tracker.trajectory_rows(), chunked.tracker.trajectory_rows()
    assert len(rows) == len(rows_ref) == N_FRAMES
    for a, b in zip(ref.tracker.records, chunked.tracker.records):
        Ta = a.T_cr.astype(np.float64) @ ref.map.kf_pose[a.ref_kf].astype(np.float64)
        Tb = b.T_cr.astype(np.float64) @ chunked.map.kf_pose[b.ref_kf].astype(np.float64)
        d = np.linalg.inv(Ta) @ Tb
        assert np.linalg.norm(d[:3, 3]) < 1e-3 and rot_angle(d[:3, :3]) < 1e-3
    pos_ref = np.array([r[1] for r in rows_ref])
    pos = np.array([r[1] for r in rows])
    assert np.sqrt(((pos - pos_ref) ** 2).sum(1).mean()) < 5e-3
    kf_ref = [int(f) for f in ref.map.kf_frame_id[: ref.map.n_kf]]
    kf = [int(f) for f in chunked.map.kf_frame_id[: chunked.map.n_kf]]
    print(f"keyframe frames: reference {kf_ref}, port {kf}")
    assert kf == kf_ref
