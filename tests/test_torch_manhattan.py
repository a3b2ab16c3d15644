"""Planes, the Manhattan frame and the full body in the port's solver and
fused step against the reference, on the CPU at small_cfg size, on the
box room's "corner" view (a floor and two perpendicular walls) and its
"near_corner" view.

- The plane maths: ``transform_plane_g2o`` within 1e-6, ``plane_ominus``
  and its parallel and perpendicular forms within 5e-6 (angles near 1.5
  rad through chains of atan2, cos and sin: a few float32 ulps).
- The plane rows' closed-form Jacobian against forward-mode AD of the
  same rows (``torch.func.jvp`` under ``torch.func.vmap``, the reference's
  ``jax.linearize`` scheme): within 1e-5 of the largest entry.
- ``solve_pose`` with plane rows, with and without ``translation_only``,
  against the reference's ``solve_pose``: T within 1e-5 (the plane rows'
  Jacobian comes from forward-mode AD in both; float32 sums in another
  order), the same inliers of every family.
- ``associate_planes_device`` and ``detect_manhattan_device`` on a view
  carried across with ``convert`` from the reference tracker's map and
  registries, both given the reference's extracted planes: the same
  associations and decision, the rotation within 1e-5.
- The slice as a whole, with the full body (planes and lines, the
  reference's defaults; both trackers below share the reference's one
  compiled step): the port's ``FastTracker(enable_planes=True,
  enable_lines=True)`` against the reference's, driven directly (no
  LocalMapper).  12 corner frames: tracked flags, keyframe frames and
  ``manhattan_found`` / ``use_manhattan`` per frame equal; the same map
  planes, pairs and triples; poses within 1e-3 m / 1e-3 rad (the
  extractors' pyramids differ by float32 ulps); port-vs-reference ATE
  under 5 mm.  8 near_corner frames (about 10 line associations a
  frame): tracked flags and keyframes equal, poses within 1e-3 m / 1e-3
  rad, each frame line's associated map line equal on every frame, the
  same map lines (endpoints within 1e-4 m, descriptors within 1e-5) and
  keyframe line slots, the line association of a view carried across
  with ``convert`` equal, and the view after the keyframe row diffs equal
  to a full upload.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.frontend import device_tracker as jdt
from manhattanslam_tpu.frontend.fast_tracking import FastTracker as JaxFastTracker
from manhattanslam_tpu.geometry import se3 as jse3
from manhattanslam_tpu.io import trajectory as traj_io
from manhattanslam_tpu.ops import lines as jlines
from manhattanslam_tpu.ops import lm as jlm
from manhattanslam_tpu.ops import planes as jplanes
from manhattanslam_tpu.slam_map import SlamMap as JaxSlamMap
from manhattanslam_tpu_torch import convert
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence as PortSequence
from manhattanslam_tpu_torch.frontend import device_tracker as pdt
from manhattanslam_tpu_torch.frontend.fast_tracking import FastTracker
from manhattanslam_tpu_torch.geometry import se3 as pse3
from manhattanslam_tpu_torch.ops import lm as plm
from manhattanslam_tpu_torch.slam_map import SlamMap
from torch_parity import port_cfg, rot_angle

N_FRAMES = 12
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.array(a))


def _pose_diff(A, B):
    d = np.linalg.inv(np.asarray(A, np.float64)) @ np.asarray(B, np.float64)
    return float(np.linalg.norm(d[:3, 3])), rot_angle(d[:3, :3])


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the
    reference package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|manhattanslam_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "manhattanslam_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert hits == []


def test_plane_maths_match_reference():
    rng = np.random.default_rng(1)
    n = rng.normal(size=(40, 3))
    pi = np.concatenate([n / np.linalg.norm(n, axis=1, keepdims=True),
                         rng.uniform(-3, 3, (40, 1))], 1).astype(np.float32)
    other = (pi + rng.normal(0, 0.05, pi.shape)).astype(np.float32)
    T = np.asarray(jse3.exp_se3(jnp.float32([0.3, -0.2, 0.5, 0.4, -0.3, 0.2])))
    np.testing.assert_allclose(
        plm.transform_plane_g2o(_t(T), _t(pi)).numpy(),
        np.asarray(jlm.transform_plane_g2o(jnp.asarray(T), jnp.asarray(pi))), rtol=0, atol=1e-6)
    for name in ("plane_ominus", "plane_ominus_par", "plane_ominus_ver"):
        out = getattr(plm, name)(_t(pi), _t(other)).numpy()
        ref = np.asarray(getattr(jlm, name)(jnp.asarray(pi), jnp.asarray(other)))
        np.testing.assert_allclose(out, ref, rtol=0, atol=5e-6, err_msg=name)


@pytest.mark.parametrize("translation_only", [False, True])
def test_plane_rows_jacobian_matches_forward_mode_ad(translation_only):
    """Random planes and poses, every family, B = 3."""
    gen = torch.Generator().manual_seed(0)
    B, P = 3, 8

    def planes():
        n = torch.randn(B, P, 3, generator=gen)
        return torch.cat([n / n.norm(dim=-1, keepdim=True), 2 * torch.randn(B, P, 1, generator=gen)], -1)

    on = torch.ones(B, P, dtype=torch.bool)
    none = [torch.zeros(B, 0, 3)] * 2 + [torch.zeros(B, 0)] + [torch.zeros(B, 0, dtype=torch.bool)] * 2
    prob = plm.PoseProblem(*none, planes(), planes(), on, planes(), planes(), on, planes(), planes(), on)
    T = pse3.exp_se3(0.3 * torch.randn(B, 6, generator=gen))
    masks = (on, on, on)
    dof = 3 if translation_only else 6
    xi0 = torch.zeros(B, dof)

    def rows(xi):
        return plm._plane_rows(plm._retract(T, xi, translation_only), prob, masks)

    basis = torch.eye(dof)[:, None, :].expand(dof, B, dof)
    r_ad, cols = torch.func.vmap(lambda v: torch.func.jvp(rows, (xi0,), (v,)), out_dims=(None, 0))(basis)
    r, J = plm._plane_rows(T, prob, masks, translation_only)
    assert torch.equal(r, r_ad)
    J_ad = cols.permute(1, 2, 0)
    assert float((J - J_ad).abs().max()) <= 1e-5 * float(J_ad.abs().max())


def _plane_problem():
    """Points seen from a known pose plus three perpendicular planes and a
    slanted one as plane, parallel and perpendicular observations, with
    noise and a few masked rows; and a perturbed start pose."""
    rng = np.random.default_rng(0)
    N, P = 64, 8
    K = np.float32([[160, 0, 95.5], [0, 160, 71.5], [0, 0, 1]])
    bf = 12.0
    T_true = np.asarray(jse3.exp_se3(jnp.float32([0.1, -0.05, 0.2, 0.05, 0.1, -0.02])))
    pw = rng.uniform([-1, -1, 2], [1, 1, 4], (N, 3)).astype(np.float32)
    pc = pw @ T_true[:3, :3].T + T_true[:3, 3]
    uv = pc[:, :2] / pc[:, 2:] * 160 + np.float32([95.5, 71.5])
    obs = np.concatenate([uv, (uv[:, 0] - bf / pc[:, 2])[:, None]], 1)
    obs = (obs + rng.normal(0, 0.5, (N, 3))).astype(np.float32)
    pt_mask = np.arange(N) >= 5
    world = np.float32([[1, 0, 0, -2], [0, 1, 0, 1.5], [0, 0, 1, -5], [0.6, 0.8, 0, -1]])
    pl_w = np.zeros((P, 4), np.float32)
    pl_w[:4] = world
    seen = np.asarray(jlm.transform_plane_g2o(jnp.asarray(T_true), jnp.asarray(pl_w)))
    pl_obs = (seen + rng.normal(0, 0.002, seen.shape)).astype(np.float32)
    ver_w = np.zeros((P, 4), np.float32)
    ver_w[:3] = world[[1, 2, 0]]
    masks = [np.arange(P) < k for k in (4, 2, 3)]
    arrays = dict(
        pt_xw=pw, pt_obs=obs, pt_info=np.ones(N, np.float32),
        pt_stereo=rng.uniform(size=N) > 0.3, pt_mask=pt_mask,
        pl_w=pl_w, pl_obs=pl_obs, pl_mask=masks[0], par_w=pl_w, par_obs=pl_obs,
        par_mask=masks[1], ver_w=ver_w, ver_obs=pl_obs, ver_mask=masks[2],
    )
    T0 = np.asarray(jse3.exp_se3(jnp.float32([0.03, -0.02, 0.02, 0.01, 0.0, -0.01]))) @ T_true
    return arrays, K, bf, T_true, T0


@pytest.mark.parametrize(
    "translation_only,gauss_newton,n_rounds,n_iters",
    [(True, True, 2, 4), (False, False, 4, 2)],
    ids=["manhattan_gn", "final_lm"],
)
def test_solve_pose_with_planes_matches_reference(translation_only, gauss_newton, n_rounds, n_iters):
    """The step's two plane schedules: the translation-only damped GN of
    the Manhattan re-solve (2 rounds of 4) and the 6-dof deferred-accept LM
    of the final solve (4 rounds: Huber on, then off; 2 iterations each
    keep the reference's unrolled compile short)."""
    arrays, K, bf, T_true, T0 = _plane_problem()
    if translation_only:  # the Manhattan solve starts from a known rotation
        T0 = T0.copy()
        T0[:3, :3] = T_true[:3, :3]
    lines = dict(ln_xw=jnp.zeros((4, 3)), ln_eq=jnp.zeros((4, 3)), ln_info=jnp.zeros(4),
                 ln_mask=jnp.zeros(4, bool))
    prob_ref = jlm.PoseProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}, **lines)
    kw = dict(translation_only=translation_only, n_rounds=n_rounds, n_iters=n_iters,
              gauss_newton=gauss_newton, use_planes=True)
    ref = jax.device_get(jlm.solve_pose(
        prob_ref, jnp.asarray(T0), jnp.asarray(K), bf, jlm.default_params(), use_lines=False, **kw))
    prob = plm.PoseProblem(**{k: _t(v)[None] for k, v in arrays.items()})
    out = plm.solve_pose(plm.stack_problems([prob, prob]), _t(np.stack([T0, T0])), _t(K), bf,
                         plm.default_params(), **kw)
    for b in range(2):
        np.testing.assert_allclose(out["T"][b].numpy(), ref["T"], rtol=0, atol=1e-5)
        for k in ("inlier_pt", "inlier_pl", "inlier_par", "inlier_ver"):
            np.testing.assert_array_equal(out[k][b].numpy(), ref[k], err_msg=k)
        assert int(out["n_inliers"][b]) == int(ref["n_inliers"])
    assert np.abs(ref["T"] - T_true).max() < 1e-2  # the solve converged


# ---------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def tracked(small_cfg):
    seq = SyntheticSequence(n_frames=N_FRAMES, cam=small_cfg.camera, view="corner")
    ref = JaxFastTracker(small_cfg, JaxSlamMap(small_cfg), enable_planes=True, enable_lines=True)
    pcfg = port_cfg(small_cfg)
    port = FastTracker(pcfg, SlamMap(pcfg), CPU, enable_planes=True, enable_lines=True)
    rows = []
    for i in range(N_FRAMES):
        ts, gray, depth = seq.frame(i)
        a, b = ref.track(ts, gray, depth), port.track(ts, gray, depth)
        flags = None
        if i:
            flags = tuple(
                (bool(jax.device_get(ref.last_result[k])), bool(port.last_result[k]))
                for k in ("manhattan_found", "use_manhattan"))
        rows.append((a, b, flags))
    return seq, ref, port, rows


def test_slice_tracks_like_reference(tracked):
    _, ref, port, rows = tracked
    assert all(a is not None and b is not None for a, b, _ in rows)
    assert [r[2] for r in port.frame_log] == [r[2] for r in ref.frame_log]
    n = ref.map.n_kf
    assert port.map.n_kf == n
    np.testing.assert_array_equal(port.map.kf_frame_id[:n], ref.map.kf_frame_id[:n])


def test_slice_manhattan_decisions_like_reference(tracked):
    _, ref, port, rows = tracked
    for i, (_, _, flags) in enumerate(rows[1:], 1):
        for k, (want, got) in zip(("manhattan_found", "use_manhattan"), flags):
            assert got == want, (i, k)
    # the reference's own bar (tests/test_planes_e2e.py)
    assert sum(f[0][1] for _, _, f in rows[1:]) >= 3
    assert sum(f[1][1] for _, _, f in rows[1:]) >= 1
    assert port.trace.counters["manhattan_frames"] == ref.n_manhattan_frames


def test_slice_map_planes_and_registries_like_reference(tracked):
    _, ref, port, _ = tracked
    np.testing.assert_array_equal(port.map.pl_valid, ref.map.pl_valid)
    assert int(port.map.pl_valid.sum()) >= 2
    v = ref.map.pl_valid
    np.testing.assert_allclose(port.map.pl_coeffs[v], ref.map.pl_coeffs[v], rtol=0, atol=1e-3)
    assert port.map.manhattan_pairs == ref.map.manhattan_pairs
    assert port.map.manhattan_triples == ref.map.manhattan_triples
    assert len(port.map.manhattan_pairs) >= 1
    np.testing.assert_array_equal(port.reg2, ref.reg2)
    np.testing.assert_array_equal(port.reg3, ref.reg3)
    np.testing.assert_array_equal(port.map.kf_pl_idx, ref.map.kf_pl_idx)


def test_slice_poses_and_ate_like_reference(tracked, tmp_path):
    seq, ref, port, rows = tracked
    for i, (a, b, _) in enumerate(rows):
        dt_, dr_ = _pose_diff(a, b)
        assert dt_ < 1e-3 and dr_ < 1e-3, f"frame {i}: {dt_} m, {dr_} rad"
    fa, fb = tmp_path / "ref.txt", tmp_path / "port.txt"
    traj_io.save_trajectory_tum(str(fa), ref.trajectory_rows())
    traj_io.save_trajectory_tum(str(fb), port.trajectory_rows())
    ts_r, p_r, _ = traj_io.load_trajectory_tum(str(fa))
    ts_p, p_p, _ = traj_io.load_trajectory_tum(str(fb))
    assert traj_io.ate_rmse((ts_p, p_p), (ts_r, p_r)) < 5e-3
    gt = seq.gt_rows()
    gt_xyz = (np.array([r[0] for r in gt]), np.array([r[1] for r in gt]))
    assert traj_io.ate_rmse((ts_p, p_p), gt_xyz) < 0.05


def test_view_with_planes_equals_full_upload(tracked):
    """The port's view, updated by row diffs at each keyframe (plane rows,
    keyframe rows, reg3 entries), equals a fresh upload of the map."""
    _, _, port, _ = tracked
    host = pdt.build_host_view(port.cfg, port.map, port.ref_kf, port.reg2, port.reg3)
    full = pdt.upload_view(host, CPU)
    assert set(port.view) == set(full)
    for k in full:
        assert torch.equal(port.view[k], full[k]), k
    assert int((port.view["reg3"] >= 0).sum()) == 6  # one triple, all orders


def test_association_and_manhattan_on_converted_view(tracked, small_cfg):
    """The reference tracker's map and registries carried into the port by
    convert; both devices' association and Manhattan detection on the
    reference's planes of the last frame, at the reference's last pose."""
    seq, ref, _, _ = tracked
    pcfg = port_cfg(small_cfg)
    tables = {k: getattr(ref.map, k)
              for k in convert.MAP_TABLES + convert.MAP_SCALARS + convert.MAP_REGISTRIES}
    m = convert.slam_map_from_numpy(pcfg, tables)
    assert m.manhattan_pairs == ref.map.manhattan_pairs
    reg2, reg3 = convert.registries_from_numpy(pcfg, ref.reg2, ref.reg3)
    view = pdt.upload_view(pdt.build_host_view(pcfg, m, ref.ref_kf, reg2, reg3), CPU)
    view_ref = jdt.build_map_view(small_cfg, ref.map, ref.reg2, ref.reg3)
    for k in ("pl_coeffs", "pl_pts", "pl_npts", "pl_valid", "kf_pl_idx", "kf_plane_coeffs",
              "kf_plane_npts", "kf_pose", "reg2", "reg3"):
        np.testing.assert_array_equal(view[k].numpy(), np.asarray(view_ref[k]), err_msg=k)

    _, _, depth = seq.frame(N_FRAMES - 1)
    h2, w2 = small_cfg.camera.height // 2, small_cfg.camera.width // 2
    K = np.asarray(small_cfg.camera.K)
    planes = jax.device_get(jplanes.extract_planes_device(
        jnp.asarray(depth), jnp.asarray(K), 8, 512, (h2 // 10, w2 // 10),
        jnp.float32(0.04 * h2 * w2), jnp.float32(0.04)))
    T = ref.T_cw
    pc = small_cfg.plane
    ths = [np.float32(x) for x in (pc.association_ang_ref, pc.association_dis_ref,
                                   pc.vertical_threshold, pc.parallel_threshold)]
    ref_assoc = [np.asarray(x) for x in jdt.associate_planes_device(
        jnp.asarray(planes["coeffs"]), jnp.asarray(planes["valid"]), jnp.asarray(T), view_ref,
        *(jnp.float32(x) for x in ths))]
    assoc = pdt.associate_planes_device(
        _t(planes["coeffs"])[None], _t(planes["valid"])[None], _t(T)[None], view,
        *(float(x) for x in ths))
    for name, a, b in zip(("assoc", "par", "ver"), assoc, ref_assoc):
        np.testing.assert_array_equal(a[0].numpy(), b, err_msg=name)
    assert (ref_assoc[0][planes["valid"]] >= 0).all()

    th = np.float32(pc.mf_vertical_threshold)
    R_ref, found_ref = jax.device_get(jdt.detect_manhattan_device(
        jnp.asarray(planes["coeffs"]), jnp.asarray(planes["n_support"]).astype(jnp.int32),
        jnp.asarray(planes["valid"]), jnp.asarray(ref_assoc[0]), view_ref, jnp.float32(th)))
    R, found = pdt.detect_manhattan_device(
        _t(planes["coeffs"])[None], _t(planes["n_support"])[None], _t(planes["valid"])[None],
        assoc[0], view, float(th))
    assert bool(found[0]) == bool(found_ref) and bool(found_ref)
    np.testing.assert_allclose(R[0].numpy(), R_ref, rtol=0, atol=1e-5)
    # the Manhattan rotation is the camera's (up to the gauge of frame 0)
    R_gt = (np.linalg.inv(seq.poses[-1]) @ seq.poses[0])[:3, :3]
    assert rot_angle(R[0].numpy().astype(np.float64) @ R_gt.T) < np.radians(2.0)


# -------------------------------------------------------- lines in the slice
N_LINE_FRAMES = 8


@pytest.fixture(scope="module")
def tracked_lines(small_cfg):
    """The near_corner view (the port's renderer: the floor corner from
    1.8 m) through both full-body trackers; the reference's step is the
    compiled one of the corner run above."""
    seq = PortSequence(n_frames=12, cam=port_cfg(small_cfg).camera, view="near_corner")
    ref = JaxFastTracker(small_cfg, JaxSlamMap(small_cfg), enable_planes=True, enable_lines=True)
    pcfg = port_cfg(small_cfg)
    port = FastTracker(pcfg, SlamMap(pcfg), CPU, enable_planes=True, enable_lines=True)
    rows = []
    for i in range(N_LINE_FRAMES):
        ts, gray, depth = seq.frame(i)
        a, b = ref.track(ts, gray, depth), port.track(ts, gray, depth)
        assoc = None
        if i:
            assoc = (np.asarray(jax.device_get(ref.last_result["line_assoc"])),
                     port.last_result["line_assoc"].numpy())
        rows.append((a, b, assoc))
    return seq, ref, port, rows


def test_full_slice_tracks_like_reference(tracked_lines):
    _, ref, port, rows = tracked_lines
    assert all(a is not None and b is not None for a, b, _ in rows)
    assert [r[2] for r in port.frame_log] == [r[2] for r in ref.frame_log]
    n = ref.map.n_kf
    assert port.map.n_kf == n
    np.testing.assert_array_equal(port.map.kf_frame_id[:n], ref.map.kf_frame_id[:n])
    for i, (a, b, _) in enumerate(rows):
        d = np.linalg.inv(a.astype(np.float64)) @ b.astype(np.float64)
        assert np.linalg.norm(d[:3, 3]) < 1e-3 and rot_angle(d[:3, :3]) < 1e-3, i


def test_full_slice_line_associations_like_reference(tracked_lines):
    _, _, _, rows = tracked_lines
    n_assoc = []
    for i, (_, _, (want, got)) in enumerate(rows[1:], 1):
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")
        n_assoc.append(int((got >= 0).sum()))
    assert min(n_assoc) >= 1


def test_full_slice_map_lines_like_reference(tracked_lines):
    _, ref, port, _ = tracked_lines
    np.testing.assert_array_equal(port.map.ml_valid, ref.map.ml_valid)
    v = ref.map.ml_valid
    assert v.sum() >= 3
    for k in ("ml_sp", "ml_ep"):
        np.testing.assert_allclose(getattr(port.map, k)[v], getattr(ref.map, k)[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.map.ml_desc[v], ref.map.ml_desc[v], rtol=0, atol=1e-5)
    for k in ("ml_n_obs", "ml_visible", "ml_found", "ml_first_kf", "kf_ml_idx"):
        np.testing.assert_array_equal(getattr(port.map, k), getattr(ref.map, k), err_msg=k)


def test_view_with_lines_equals_full_upload(tracked_lines):
    _, _, port, _ = tracked_lines
    host = pdt.build_host_view(port.cfg, port.map, port.ref_kf, port.reg2, port.reg3)
    full = pdt.upload_view(host, CPU)
    assert set(port.view) == set(full)
    for k in full:
        assert torch.equal(port.view[k], full[k]), k
    assert int(port.view["ml_valid"].sum()) >= 3


def test_line_association_on_converted_view(tracked_lines, small_cfg):
    """The reference tracker's map carried into the port by convert; both
    packages' association of the reference's last-frame lines at its last
    pose."""
    seq, ref, _, _ = tracked_lines
    pcfg = port_cfg(small_cfg)
    tables = {k: getattr(ref.map, k) for k in convert.MAP_TABLES + convert.MAP_SCALARS}
    m = convert.slam_map_from_numpy(pcfg, tables)
    view = pdt.upload_view(pdt.build_host_view(pcfg, m, ref.ref_kf), CPU)
    view_ref = jdt.build_map_view(small_cfg, ref.map)
    for k in ("ml_sp", "ml_ep", "ml_desc", "ml_valid"):
        np.testing.assert_array_equal(view[k].numpy(), np.asarray(view_ref[k]), err_msg=k)
    gray = pdt.to_native(*seq.frame(N_LINE_FRAMES - 1)[1:])[0].astype(np.float32)
    det = jax.device_get(jlines.detect_lines(jnp.asarray(gray), small_cfg.caps.max_lines))
    desc = np.asarray(jlines.line_descriptors(jnp.asarray(gray), jnp.asarray(det["sp"]),
                                              jnp.asarray(det["ep"])))
    hw = (small_cfg.camera.height, small_cfg.camera.width)
    K = np.asarray(small_cfg.camera.K, np.float32)
    ref_assoc, ref_vis = (np.asarray(x) for x in jdt.associate_lines_device(
        {k: jnp.asarray(v) for k, v in det.items()}, jnp.asarray(desc), jnp.asarray(ref.T_cw),
        view_ref, jnp.asarray(K), image_hw=hw))
    assoc, vis = pdt.associate_lines_device(
        {k: _t(det[k])[None] for k in ("sp", "ep", "valid", "angle")}, _t(desc)[None],
        _t(ref.T_cw)[None], view, _t(K), hw)
    assoc, vis = assoc[0].numpy(), vis[0].numpy()
    np.testing.assert_array_equal(assoc, ref_assoc)
    np.testing.assert_array_equal(vis, ref_vis)
    assert (ref_assoc >= 0).sum() >= 3
