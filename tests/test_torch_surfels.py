"""Surfels in the port against the reference, on the CPU at small_cfg size.

- ``superpixels`` on three corner frames and tests/test_surfels.py's
  flat and masked frames: labels equal on >= 99.5% of the pixels; for the
  superpixels whose members are the same pixels in both packages, n_pix
  and valid equal, mean and z within 1e-4 m and |dot(normal)| >= 1 - 2e-5,
  but for at most one superpixel a frame, held within 1 cm and 0.1 rad: a
  segment that is not planar, whose trimmed refits keep members by hard
  residual thresholds (corner frame 7 has one).  The port sums each superpixel over its
  24x24 window in a fixed order where the reference scatter-adds, so
  sums differ by ulps, and a pixel at a cost tie may take another label.
- ``fuse_surfels`` and ``add_new_surfels`` given the same superpixels and
  the same state: int and bool fields equal, floats within 1e-5, and a
  nearly full map that drops the overflow.
- The PLY: the port's bytes equal the reference's for the same arrays,
  and the file reads back.
- ``SurfelMapper`` over 4 keyframes at ground-truth poses with the
  reference's plane membership, both packages started from one converted
  state (the reference's after two keyframes, its pose graph extended by
  a chain of 10 keyframes): the active flags, the BFS window (including a
  ref_kf link that reaches back to keyframe 0 and reactivates its
  surfels) and the valid count equal after every keyframe; export_arrays
  within the superpixels' tolerance.
- uint16 depth: the reference's superpixels place a uint16 frame
  DEPTH_QUANT times as far as the float frame (its fault, ROADMAP Queue
  3); the port's mapper converts it and builds the same surfels.
- The port's ``System(fast=True, enable_surfels=True)`` with
  tests/test_fast_tracker.py's and tests/test_surfels.py's bounds; with
  chunk=4 and the pipeline, the surfel mapper receives each keyframe's
  own gray and depth; the System's defaults equal the reference's.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.io import ply as jply
from manhattanslam_tpu.io import trajectory as traj_io
from manhattanslam_tpu.mapping.surfel_mapping import SurfelMapper as JaxSurfelMapper
from manhattanslam_tpu.ops import planes as jplanes
from manhattanslam_tpu.ops import surfels as jsurf
from manhattanslam_tpu.slam_map import SlamMap as JaxSlamMap
from manhattanslam_tpu.system import System as JaxSystem
from manhattanslam_tpu_torch import convert
from manhattanslam_tpu_torch.frontend import device_tracker as dt
from manhattanslam_tpu_torch.io import ply
from manhattanslam_tpu_torch.mapping.surfel_mapping import SurfelMapper
from manhattanslam_tpu_torch.ops import surfels
from manhattanslam_tpu_torch.slam_map import SlamMap
from manhattanslam_tpu_torch.system import System
from torch_parity import port_cfg

H, W = 144, 192
K_NP = np.array([[160.0, 0, 95.5], [0, 160.0, 71.5], [0, 0, 1]], np.float32)
K_T = torch.from_numpy(K_NP)
LABEL_SHARE = 0.995
POS_TOL = 1e-4  # m, mean and z of superpixels with the same members
# 1 - |dot(normal)|: the smallest eigenvector of a float32 covariance
# E[xx^T] - mean mean^T whose moments are summed in another order (corner
# frame 6, superpixel 413 at 2.8 m: 1.01e-5)
NORMAL_TOL = 2e-5
OUTLIER_M = 0.01  # the one superpixel a frame allowed beyond POS_TOL / NORMAL_TOL
OUTLIER_RAD = 0.1
STATE_TOL = 1e-5  # fusion given the same superpixels and state


def _t(a):
    return torch.from_numpy(np.array(a))


def _sp_np(sp: dict) -> dict:
    return {k: np.asarray(v) for k, v in sp.items()}


@pytest.fixture(scope="module")
def corner_seq(small_cfg):
    return SyntheticSequence(n_frames=10, cam=small_cfg.camera, view="corner")


def _gt_T_cw(seq, i):
    """Frame i's camera pose in the frame-0 camera's world (the System's
    gauge)."""
    return (np.linalg.inv(seq.poses[i]) @ seq.poses[0]).astype(np.float32)


def _frames():
    flat_gray = np.full((H, W), 120.0, np.float32)
    flat_depth = np.full((H, W), 2.0, np.float32)
    masked = np.zeros((H, W), bool)
    masked[:, :96] = True
    return flat_gray, flat_depth, masked


@pytest.fixture(scope="module")
def sp_cases(corner_seq):
    """(name, gray, depth, plane_mask, reference superpixels, port
    superpixels) for three corner frames and the flat and masked frames."""
    flat_gray, flat_depth, masked = _frames()
    cases = []
    for i in (0, 6, 7):
        _, gray, depth = corner_seq.frame(i)
        cases.append((f"corner{i}", gray.astype(np.float32), depth.astype(np.float32),
                      np.zeros((H, W), bool)))
    cases.append(("flat", flat_gray, flat_depth, np.zeros((H, W), bool)))
    cases.append(("masked", flat_gray, flat_depth, masked))
    out = []
    for name, g, d, m in cases:
        ref = _sp_np(jsurf.superpixels(jnp.asarray(g), jnp.asarray(d), jnp.asarray(m),
                                       jnp.asarray(K_NP)))
        port = {k: v.numpy() for k, v in surfels.superpixels(_t(g), _t(d), _t(m), K_T).items()}
        out.append((name, g, d, m, ref, port))
    return out


def _same_member_segments(ref_lab: np.ndarray, port_lab: np.ndarray, S: int) -> np.ndarray:
    """Superpixel ids whose member pixels are the same in both label images."""
    diff = ref_lab != port_lab
    touched = np.zeros(S + 1, bool)
    touched[np.where(diff, ref_lab, S)] = True
    touched[np.where(diff, port_lab, S)] = True
    return np.nonzero(~touched[:S])[0]


@pytest.mark.parametrize("case", range(5))
def test_superpixels_match_reference(sp_cases, case):
    name, _, depth, _, ref, port = sp_cases[case]
    share = (ref["labels"] == port["labels"]).mean()
    if share < LABEL_SHARE:
        y, x = np.argwhere(ref["labels"] != port["labels"])[0]
        pytest.fail(f"{name}: labels equal on {share:.4f} of the pixels; first differing "
                    f"pixel ({y}, {x}): reference {ref['labels'][y, x]}, port {port['labels'][y, x]}")
    S = ref["mean"].shape[0]
    same = _same_member_segments(ref["labels"], port["labels"], S)
    assert len(same) >= 0.95 * S
    np.testing.assert_array_equal(ref["n_pix"][same], port["n_pix"][same])
    np.testing.assert_array_equal(ref["valid"][same], port["valid"][same], err_msg=name)
    live = same[ref["n_pix"][same] > 0]
    dots = np.abs((port["normal"][live] * ref["normal"][live]).sum(-1))
    off = ((np.abs(port["mean"][live] - ref["mean"][live]).max(-1) > POS_TOL)
           | (np.abs(port["z"][live] - ref["z"][live]) > POS_TOL) | (dots < 1 - NORMAL_TOL))
    # at most one superpixel a frame beyond the tolerances, within the
    # outlier bounds: a segment that is not planar, whose trimmed refits
    # keep members by hard residual thresholds (corner frame 7: superpixel
    # 244 across the box's edge, depths 5.43-5.85 m, where each package
    # keeps another 38 of its 41 members; it moves 7.7 mm and 2.9 degrees)
    worst = live[off]
    assert len(worst) <= 1, f"{name}: superpixels {worst.tolist()} beyond the tolerances"
    for s in worst:
        d_mean = np.abs(port["mean"][s] - ref["mean"][s]).max()
        d_ang = np.arccos(min(1.0, abs(float(port["normal"][s] @ ref["normal"][s]))))
        assert d_mean < OUTLIER_M and d_ang < OUTLIER_RAD, (name, int(s), d_mean, d_ang)
    np.testing.assert_allclose(port["intensity"][live], ref["intensity"][live], atol=1e-3)


def test_superpixels_reference_bars(sp_cases):
    """tests/test_surfels.py's flat and masked bars, on the port."""
    _, _, _, _, _, flat = sp_cases[3]
    v = flat["valid"]
    assert v.mean() > 0.8
    nrm = flat["normal"][v]
    assert (np.abs(nrm[:, 2]) > 0.99).mean() > 0.95 and (nrm[:, 2] < 0).all()
    np.testing.assert_allclose(flat["z"][v], 2.0, atol=0.02)
    _, _, _, _, _, masked = sp_cases[4]
    assert (masked["labels"][:, :96] == -1).all()
    assert (masked["labels"][:, 100:] >= 0).mean() > 0.9


def _state(cap: int, n_valid: int = 0, seed: int = 0) -> dict:
    """A surfel state with n_valid live slots spread over the capacity."""
    rng = np.random.default_rng(seed)
    s = {k: v.numpy() for k, v in surfels.empty_state(cap, "cpu").items()}
    live = np.sort(rng.choice(cap, n_valid, replace=False))
    s["valid"][live] = True
    s["active"][live] = rng.random(n_valid) < 0.8
    s["pos"][live] = rng.normal(size=(n_valid, 3)).astype(np.float32) + [0, 0, 2]
    nrm = rng.normal(size=(n_valid, 3)).astype(np.float32)
    s["normal"][live] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    s["weight"][live] = rng.uniform(0.1, 1, n_valid)
    s["radius"][live] = rng.uniform(0.01, 0.1, n_valid)
    s["color"][live] = rng.uniform(0, 255, n_valid)
    s["n_updates"][live] = rng.integers(1, 9, n_valid)
    return s


def _check_state(ref: dict, port: dict) -> None:
    for k in convert.SURFEL_KEYS:
        r, p = np.asarray(ref[k]), port[k].numpy()
        if r.dtype.kind == "f":
            np.testing.assert_allclose(p, r, atol=STATE_TOL, err_msg=k)
        else:
            bad = np.argwhere(r != p)
            assert len(bad) == 0, f"{k}: first differing slot {bad[0]}: {r[tuple(bad[0])]} vs " \
                                  f"{p[tuple(bad[0])]}"


@pytest.mark.parametrize("cap,n_valid", [(1024, 0), (1024, 300), (96, 90)])
def test_fuse_and_add_match_reference(sp_cases, corner_seq, cap, n_valid):
    """Frame 6's reference superpixels fused into a state at frame 6's
    ground-truth pose (a state of 90 live slots in 96 drops the overflow)."""
    sp = sp_cases[1][4]
    T_cw = _gt_T_cw(corner_seq, 6)
    T_wc = np.linalg.inv(T_cw)
    state = _state(cap, n_valid)
    ref_s, ref_fused = jsurf.fuse_surfels(
        {k: jnp.asarray(v) for k, v in state.items()}, {k: jnp.asarray(v) for k, v in sp.items()},
        jnp.asarray(T_cw), jnp.asarray(T_wc), jnp.asarray(K_NP), jnp.int32(3), H, W)
    port_s = {k: _t(v) for k, v in state.items()}
    port_sp = {k: _t(v) for k, v in sp.items()}
    fused = surfels.fuse_surfels(port_s, port_sp, _t(T_cw), _t(T_wc), K_T, 3, H, W)
    np.testing.assert_array_equal(fused.numpy(), np.asarray(ref_fused))
    _check_state(ref_s, port_s)
    ref_s = jsurf.add_new_surfels(ref_s, {k: jnp.asarray(v) for k, v in sp.items()}, ref_fused,
                                  jnp.asarray(T_wc), jnp.int32(3))
    surfels.add_new_surfels(port_s, port_sp, fused, _t(T_wc), 3)
    _check_state(ref_s, port_s)
    n_new = int((sp["valid"] & ~np.asarray(ref_fused)).sum())
    assert int(port_s["valid"].sum()) == min(cap, n_valid + n_new)
    if cap == 96:
        assert n_valid + n_new > cap  # the overflow was dropped


def test_ply_bytes_match_reference(tmp_path, rng):
    n = 57
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    inten = rng.uniform(0, 255, n).astype(np.float32)
    qual = rng.uniform(0, 1, n).astype(np.float32)
    rad = rng.uniform(0, 0.1, n).astype(np.float32)
    jply.save_surfel_ply(str(tmp_path / "r.ply"), pos, nrm, inten, qual, rad)
    ply.save_surfel_ply(str(tmp_path / "p.ply"), pos, nrm, inten, qual, rad)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "r.ply").read_bytes()
    back = ply.load_surfel_ply(str(tmp_path / "p.ply"))
    np.testing.assert_array_equal(back["pos"], pos)
    np.testing.assert_array_equal(back["radius"], rad)
    np.testing.assert_array_equal(back["viewport"], [n, 1])


# ------------------------------------------------------------- SurfelMapper
MAPPER_KFS = ((12, 1, 11), (13, 3, 12), (14, 5, 0), (15, 8, None))  # (kf, frame, ref_kf)


@pytest.fixture(scope="module")
def mappers(small_cfg, corner_seq):
    """Both packages' SurfelMapper from one converted state, then the same
    four keyframes; the comparisons after each keyframe."""
    pcfg = port_cfg(small_cfg)
    jmap, pmap = JaxSlamMap(small_cfg), SlamMap(pcfg)
    frames = {}
    for kf, i in ((0, 0), (1, 2)) + tuple((kf, i) for kf, i, _ in MAPPER_KFS):
        _, gray, depth = corner_seq.frame(i)
        memb = np.asarray(jplanes.extract_planes(
            depth, K_NP, small_cfg.caps.max_planes_frame, small_cfg.caps.max_plane_points,
            dist_th=small_cfg.plane.distance_threshold)["membership"])
        frames[kf] = (gray.astype(np.float32), depth.astype(np.float32), memb)
        jmap.kf_pose[kf] = pmap.kf_pose[kf] = _gt_T_cw(corner_seq, i)
    # a map plane, so the export flattens a cloud
    rng = np.random.default_rng(1)
    cloud = np.c_[rng.uniform(0, 2, (50, 2)), 0.01 * rng.normal(size=50)].astype(np.float32)
    for m in (jmap, pmap):
        m.pl_valid[0] = True
        m.pl_coeffs[0] = [0, 0, 1, 0.5]
        m.pl_pts[0, :50] = cloud
        m.pl_n_pts[0] = 50
    ref = JaxSurfelMapper(small_cfg, jmap)
    for kf in (0, 1):
        g, d, memb = frames[kf]
        ref.insert_keyframe(kf, g, d, plane_membership=memb, ref_kf=0)
    # a chain 1 - 2 - ... - 11 of keyframes without surfels: the window of
    # 10 poses leaves keyframes 0 and 1 behind
    state = convert.surfel_state_to_numpy(ref)
    for k in range(2, 12):
        state["pose_links"].setdefault(k - 1, set()).add(k)
        state["pose_links"][k] = {k - 1}
    state["n_keyframes"], state["_last_inserted"] = 12, 11
    ref.surfels = {k: jnp.asarray(v) for k, v in state["surfels"].items()}
    ref.pose_links = {k: set(v) for k, v in state["pose_links"].items()}
    ref.n_keyframes, ref._last_inserted = 12, 11
    port = SurfelMapper(pcfg, pmap, "cpu")
    convert.load_surfel_state(state, port)
    steps = []
    for kf, _, ref_kf in MAPPER_KFS:
        g, d, memb = frames[kf]
        ref.insert_keyframe(kf, g, d, plane_membership=memb, ref_kf=ref_kf)
        port.insert_keyframe(kf, g, d, plane_membership=_t(memb), ref_kf=ref_kf)
        steps.append((kf, convert.surfel_state_to_numpy(ref), convert.surfel_state_to_numpy(port),
                      ref._bfs_window(kf), port._bfs_window(kf)))
    return ref, port, steps


@pytest.mark.parametrize("step", range(len(MAPPER_KFS)))
def test_surfel_mapper_matches_reference(mappers, step):
    _, _, steps = mappers
    kf, ref, port, win_ref, win_port = steps[step]
    assert win_port == win_ref
    assert port["pose_links"] == ref["pose_links"]
    np.testing.assert_array_equal(port["surfels"]["active"], ref["surfels"]["active"])
    assert port["surfels"]["valid"].sum() == ref["surfels"]["valid"].sum()
    if kf == 12:  # keyframes 0 and 1 left the window: their surfels are inactive
        assert {0, 1}.isdisjoint(win_port)
        old = port["surfels"]["valid"] & (port["surfels"]["attach_kf"] <= 1)
        assert old.any() and not port["surfels"]["active"][old].any()
    if kf == 14:  # the link to keyframe 0 reaches back and reactivates it
        assert 0 in win_port and 14 in port["pose_links"][0]


def test_surfel_mapper_export_matches_reference(mappers):
    ref, port, _ = mappers
    a, b = ref.export_arrays(), port.export_arrays()
    assert len(a["pos"]) == len(b["pos"]) > 50
    np.testing.assert_allclose(b["pos"], a["pos"], atol=POS_TOL)
    np.testing.assert_allclose(b["intensity"], a["intensity"], atol=1e-3)
    np.testing.assert_allclose(b["radius"], a["radius"], atol=POS_TOL)
    np.testing.assert_allclose(b["quality"], a["quality"], rtol=1e-4)
    assert (np.abs((a["normal"] * b["normal"]).sum(-1)) >= 1 - NORMAL_TOL).all()


def test_uint16_depth_in_metres(small_cfg, corner_seq):
    """The reference's superpixels read a uint16 frame in 1/DEPTH_QUANT m
    as metres (its z comes out DEPTH_QUANT times the float frame's); the
    port's mapper converts it and builds the same surfels as from the
    float frame."""
    flat_gray, flat_depth, _ = _frames()
    no_mask = np.zeros((H, W), bool)
    d16 = dt.to_native(flat_gray, flat_depth)[1]
    z_f = np.asarray(jsurf.superpixels(jnp.asarray(flat_gray), jnp.asarray(flat_depth),
                                       jnp.asarray(no_mask), jnp.asarray(K_NP))["z"])
    z_16 = np.asarray(jsurf.superpixels(jnp.asarray(flat_gray), jnp.asarray(d16),
                                        jnp.asarray(no_mask), jnp.asarray(K_NP))["z"])
    live = z_f > 0
    np.testing.assert_allclose(z_16[live], dt.DEPTH_QUANT * z_f[live], rtol=1e-5)
    pcfg = port_cfg(small_cfg)
    out = []
    for depth in (flat_depth, d16):
        m = SlamMap(pcfg)
        m.kf_pose[0] = np.eye(4, dtype=np.float32)
        mapper = SurfelMapper(pcfg, m, "cpu")
        mapper.insert_keyframe(0, flat_gray, depth)
        out.append(convert.surfel_state_to_numpy(mapper)["surfels"])
    for k in convert.SURFEL_KEYS:
        np.testing.assert_array_equal(out[1][k], out[0][k], err_msg=k)
    assert out[0]["valid"].sum() > 300
    np.testing.assert_allclose(out[0]["pos"][out[0]["valid"]][:, 2], 2.0, atol=0.02)


# ------------------------------------------------------------------ System
def _ate(system, seq, tmp_path) -> float:
    est = tmp_path / "est.txt"
    system.save_trajectory_tum(str(est))
    ts, pos, _ = traj_io.load_trajectory_tum(str(est))
    gt = seq.gt_rows()
    return traj_io.ate_rmse((ts, pos), (np.array([r[0] for r in gt]), np.array([r[1] for r in gt])))


@pytest.fixture(scope="module")
def fast_surfels(small_cfg, corner_seq):
    """tests/test_fast_tracker.py's traffic on the port's
    System(fast=True, enable_surfels=True): 10 corner frames."""
    system = System(port_cfg(small_cfg), fast=True, enable_surfels=True, device="cpu")
    poses = [system.track(g, d, t) for t, g, d in (corner_seq.frame(i) for i in range(10))]
    return system, poses


def test_fast_surfels_tracker_bars(fast_surfels, corner_seq, tmp_path):
    """tests/test_fast_tracker.py:11-45, 67-76 on the port."""
    system, poses = fast_surfels
    assert all(p is not None for p in poses)
    assert _ate(system, corner_seq, tmp_path) < 0.05
    m = system.map
    assert m.n_kf >= 1 and m.mp_valid.sum() > 100
    assert m.pl_valid.sum() >= 2 and len(m.manhattan_pairs) >= 1
    p = tmp_path / "s.ply"
    system.save_surfels(str(p))
    assert len(ply.load_surfel_ply(str(p))["pos"]) > 100
    assert system.kf_perf["surfel_insert"] > 0


def test_fast_surfels_room_bar(fast_surfels, corner_seq, tmp_path):
    """tests/test_surfels.py:104-115 on the port's fused System."""
    system, _ = fast_surfels
    system.shutdown()
    p = tmp_path / "Surfels.ply"
    system.save_surfels(str(p))
    back = ply.load_surfel_ply(str(p))
    assert len(back["pos"]) > 200
    T0 = corner_seq.poses[0]
    pts_room = back["pos"] @ T0[:3, :3].T + T0[:3, 3]
    inside = (pts_room > -0.5).all(1) & (pts_room < np.array(corner_seq.room.size) + 0.5).all(1)
    assert inside.mean() > 0.9


@pytest.mark.parametrize("native", [False, True], ids=["float", "uint16"])
def test_chunked_pipeline_surfels_get_each_keyframes_frame(small_cfg, native):
    """chunk=4 with the pipeline (the back end deferred past the next
    chunk): the surfel mapper receives each keyframe's own gray and depth,
    as the caller gave them, and its plane membership; a forced keyframe
    mid-run and the policy's keyframes alike."""
    seq = SyntheticSequence(n_frames=24, cam=small_cfg.camera, view="walk")
    system = System(port_cfg(small_cfg), fast=True, pipeline=True, chunk=4, device="cpu")
    frames = {}
    got = []
    insert = system.surfel_mapper.insert_keyframe

    def spy(kf_id, gray, depth, *args, **kwargs):
        got.append((kf_id, gray, depth, kwargs["plane_membership"]))
        return insert(kf_id, gray, depth, *args, **kwargs)

    system.surfel_mapper.insert_keyframe = spy
    for i in range(24):
        t, gray, depth = seq.frame(i)
        if native:
            gray, depth = dt.to_native(gray, depth)
        frames[i] = (gray, depth)
        if i == 9:
            system.tracker.force_keyframe = True
        system.track(gray, depth, t)
    system.shutdown()
    m = system.map
    assert len(got) == int(m.kf_valid[: m.n_kf].sum()) >= 2
    for kf_id, gray, depth, memb in got:
        g, d = frames[int(m.kf_frame_id[kf_id])]
        np.testing.assert_array_equal(gray, g.astype(np.float32))
        assert depth is d  # the caller's own array, converted by the mapper
        assert memb is not None and tuple(memb.shape) == (H // 2, W // 2)
    assert system.surfel_mapper.n_keyframes == len(got)


@pytest.mark.parametrize("surfels", [False, True], ids=["no_surfels", "surfels"])
def test_frame_slot_keeps_membership_only_for_surfels(small_cfg, corner_seq, surfels):
    """At chunk 1 a frame's output slot keeps the plane membership image,
    and a keyframe hands on a copy of it, only when the surfel arm reads
    it: without surfels the fused path copies nothing more than before."""
    system = System(port_cfg(small_cfg), fast=True, enable_surfels=surfels, device="cpu")
    tr = system.tracker
    got = []
    hook = tr.on_keyframe

    def spy(kf_id, kf_frame):
        got.append(kf_frame)
        return hook(kf_id, kf_frame)

    tr.on_keyframe = spy
    for i in range(3):
        t, gray, depth = corner_seq.frame(i)
        assert system.track(gray, depth, t) is not None
    slots = [s for s in tr._out if s is not None]
    assert slots and all(("plane_membership" in s) == surfels for s in slots)
    assert got and all((f.membership is not None) == surfels for f in got)
    assert all(f.gray is not None and f.depth is not None for f in got)


def test_system_defaults_match_reference():
    names = ("use_viewer", "enable_planes", "enable_lines", "enable_surfels", "fast", "pipeline",
             "chunk")
    ref = inspect.signature(JaxSystem.__init__).parameters
    port = inspect.signature(System.__init__).parameters
    assert {n: port[n].default for n in names} == {n: ref[n].default for n in names}
