"""The modular tracker's parts in the port against the reference, on the
CPU at small_cfg size.

The converted map is the port's own: its ``System(device="cpu")`` (the
modular tracker, planes and lines on, surfels off) over 10 corner frames,
carried into a reference SlamMap with convert.map_to_numpy.

- ``SlamMap.local_map_view`` equal for several anchor sets.
- ``track_descriptors`` on keyframe 0's landmark rows against a later
  frame's features (the port's, carried over): the matches and inliers
  equal, the pose within 1e-5 m / rad, from a perturbed seed and, with
  ``translation_only``, from the ground-truth rotation.  Points only: the
  reference's solve with the plane and line families compiles for ~60 s
  on the CPU; those families are held in tests/test_torch_manhattan.py
  and tests/test_torch_lines.py.
- ``extract_planes`` at 192x144 under tests/test_torch_planes.py's
  tolerances for the device path it wraps.
- ``PlaneModule``: given the same frame planes, match, detect_manhattan,
  plane_observations and on_keyframe (the map's plane tables and the
  Manhattan registries) equal on two corner frames.
- ``LineModule``: given the same frame lines, match (associations and
  the map lines' visible / found counts), line_observations and
  on_keyframe equal.
- ``extract_planes(method="ahc")`` runs on the port (held against the
  reference in tests/test_torch_ahc.py); an unknown method raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.frontend import tracking_ops as jtops
from manhattanslam_tpu.frontend.lines_module import LineModule as JaxLineModule
from manhattanslam_tpu.frontend.planes_module import PlaneModule as JaxPlaneModule
from manhattanslam_tpu.ops import lm as jlm
from manhattanslam_tpu.ops import planes as jplanes
from manhattanslam_tpu.slam_map import SlamMap as JaxSlamMap
from manhattanslam_tpu_torch import convert
from manhattanslam_tpu_torch.frontend import tracking_ops
from manhattanslam_tpu_torch.frontend.lines_module import LineModule
from manhattanslam_tpu_torch.frontend.planes_module import PlaneModule
from manhattanslam_tpu_torch.ops import lm, planes
from manhattanslam_tpu_torch.system import System
from test_torch_planes import _assert_planes_match
from torch_parity import port_cfg, rot_angle

CPU = torch.device("cpu")
POSE_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _gt_T_cw(seq, i):
    return (np.linalg.inv(seq.poses[i]) @ seq.poses[0]).astype(np.float32)


@pytest.fixture(scope="module")
def corner(small_cfg):
    seq = SyntheticSequence(n_frames=10, cam=small_cfg.camera, view="corner")
    return seq, [seq.frame(i) for i in range(10)]


@pytest.fixture(scope="module")
def mapped(small_cfg, corner):
    """The port's modular System over the corner frames; its map as numpy."""
    seq, frames = corner
    system = System(port_cfg(small_cfg), enable_surfels=False, device="cpu")
    for t, gray, depth in frames:
        system.track(gray, depth, t)
    assert system.map.pl_valid.sum() >= 2 and system.map.ml_valid.sum() >= 3
    return system, convert.map_to_numpy(system.map)


def _maps(small_cfg, tables):
    """A fresh reference and port SlamMap holding the same tables."""
    jmap = JaxSlamMap(small_cfg)
    for k in convert.MAP_TABLES:
        getattr(jmap, k)[...] = tables[k]
    for k in convert.MAP_SCALARS:
        setattr(jmap, k, int(tables[k]))
    for k in convert.MAP_REGISTRIES:
        setattr(jmap, k, dict(tables[k]))
    jmap.kf_free = list(tables["kf_free"])
    jmap.kf_not_erase = set(tables["kf_not_erase"])
    return jmap, convert.slam_map_from_numpy(port_cfg(small_cfg), tables)


def _assert_maps_equal(jmap, pmap):
    a, b = convert.map_to_numpy(jmap), convert.map_to_numpy(pmap)
    for k in convert.MAP_TABLES:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for k in convert.MAP_REGISTRIES + convert.MAP_SCALARS:
        assert b[k] == a[k], k


@pytest.mark.parametrize("anchors", [[0], [0, 1], "all"])
def test_local_map_view_matches_reference(small_cfg, mapped, anchors):
    _, tables = mapped
    jmap, pmap = _maps(small_cfg, tables)
    ids = np.arange(pmap.n_kf) if anchors == "all" else np.array(anchors)
    a, b = jmap.local_map_view(ids), pmap.local_map_view(ids)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert b["valid"].sum() > 100


@pytest.fixture(scope="module")
def descriptor_case(small_cfg, mapped, corner):
    """Keyframe 0's landmark rows (the modular tracker's reference-keyframe
    view) and frame 6's features, both from the port's run."""
    system, tables = mapped
    seq, frames = corner
    _, gray, depth = frames[6]
    feats = system.tracker.extract(_t(gray.astype(np.float32)), _t(depth.astype(np.float32)))
    ids = tables["kf_mp_idx"][0]
    safe = np.maximum(ids, 0)
    pts = {"pos": tables["mp_pos"][safe], "desc": tables["mp_desc"][safe],
           "valid": (ids >= 0) & tables["mp_valid"][safe], "level": tables["mp_level"][safe]}
    return pts, {k: v.numpy() for k, v in feats.items()}, tables["kf_angle"][0], _gt_T_cw(seq, 6)


def _seed(T: np.ndarray, translation_only: bool) -> np.ndarray:
    """The ground-truth pose with its translation moved by 4 cm and, for a
    full solve, its rotation by ~1 degree."""
    T = T.copy()
    T[:3, 3] += [0.03, -0.02, 0.02]
    if not translation_only:
        a = np.radians(1.0)
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
        T[:3, :3] = R @ T[:3, :3]
    return T


@pytest.mark.parametrize("translation_only", [False, True])
def test_track_descriptors_matches_reference(small_cfg, descriptor_case, translation_only):
    pts, feats, angles, T_gt = descriptor_case
    T0 = _seed(T_gt, translation_only)
    K = np.asarray(small_cfg.camera.K, np.float32)
    P, L = small_cfg.caps.max_planes_frame, small_cfg.caps.max_lines
    jfeats = {k: jnp.asarray(v.view(np.uint32) if k == "desc" else v) for k, v in feats.items()}
    ref = jtops.track_descriptors(
        {k: jnp.asarray(v) for k, v in pts.items()}, jnp.asarray(T0), jfeats, jnp.asarray(angles),
        jnp.asarray(K), jnp.float32(small_cfg.camera.bf), jlm.default_params(small_cfg),
        jtops.empty_plane_obs(P), jtops.empty_line_obs(L), translation_only=translation_only,
        use_planes=False, use_lines=False)
    lead = {k: _t(v.view(np.int32) if v.dtype == np.uint32 else v)[None] for k, v in pts.items()}
    out = tracking_ops.track_descriptors(
        lead, _t(T0)[None], {k: _t(v)[None] for k, v in feats.items()}, _t(angles)[None],
        _t(K), float(small_cfg.camera.bf), lm.default_params(port_cfg(small_cfg)),
        tracking_ops.empty_plane_obs(P, (1,)), tracking_ops.empty_line_obs(L, (1,)),
        translation_only=translation_only)
    for k in ("kp_idx", "matched", "pt_inlier"):
        np.testing.assert_array_equal(out[k][0].numpy(), np.asarray(ref[k]), err_msg=k)
    assert int(out["n_pt_inliers"][0]) == int(ref["n_pt_inliers"]) > 30
    T_r, T_p = np.asarray(ref["T"], np.float64), out["T"][0].numpy().astype(np.float64)
    assert np.abs(T_p[:3, 3] - T_r[:3, 3]).max() < POSE_TOL
    assert rot_angle(T_p[:3, :3] @ T_r[:3, :3].T) < POSE_TOL
    if translation_only:
        np.testing.assert_array_equal(T_p[:3, :3], T0[:3, :3])
    # the solve moved the seed toward the ground truth
    assert np.linalg.norm(T_p[:3, 3] - T_gt[:3, 3]) < np.linalg.norm(T0[:3, 3] - T_gt[:3, 3])


@pytest.fixture(scope="module")
def plane_frames(small_cfg, corner):
    """The reference's and the port's extract_planes on two corner frames."""
    _, frames = corner
    K = np.asarray(small_cfg.camera.K, np.float32)
    c = small_cfg.caps
    out = []
    for i in (5, 9):
        depth = frames[i][2].astype(np.float32)
        ref = jplanes.extract_planes(depth, K, c.max_planes_frame, c.max_plane_points,
                                     dist_th=small_cfg.plane.distance_threshold)
        port = planes.extract_planes(depth, K, c.max_planes_frame, c.max_plane_points,
                                     dist_th=small_cfg.plane.distance_threshold, device=CPU)
        out.append((i, depth, ref, port))
    return out


@pytest.mark.parametrize("case", [0, 1])
def test_extract_planes_matches_reference(small_cfg, plane_frames, case):
    """The host wrapper under tests/test_torch_planes.py's tolerances for
    the device path it runs (float32 sums in another order can move a
    boundary pixel across the distance gate)."""
    _, depth, ref, port = plane_frames[case]
    assert port["valid"].sum() >= 2
    ref = {k: np.asarray(v) for k, v in ref.items()}
    _assert_planes_match(ref, {**port, "membership": port["membership"].numpy()}, depth,
                         np.asarray(small_cfg.camera.K, np.float32))


def test_extract_planes_ahc_not_ported(plane_frames, small_cfg):
    """The exact AHC merge is ported now: method="ahc" finds the corner's
    planes on the CPU; a method that is neither raises."""
    depth = plane_frames[0][1]
    out = planes.extract_planes(depth, small_cfg.camera.K, 8, 64, method="ahc", device=CPU)
    assert out["valid"].sum() >= 2
    with pytest.raises(ValueError, match="method"):
        planes.extract_planes(depth, small_cfg.camera.K, 8, 64, method="peac", device=CPU)


def test_extract_planes_needs_cuda_unless_cpu_is_asked(plane_frames, small_cfg):
    """A host depth with no device goes to CUDA, and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    depth = plane_frames[0][1]
    with pytest.raises(RuntimeError, match="CUDA"):
        planes.extract_planes(depth, small_cfg.camera.K, 8, 64)


@pytest.mark.parametrize("case", [0, 1])
def test_plane_module_matches_reference(small_cfg, mapped, corner, plane_frames, case):
    """match and detect_manhattan at the frame's ground-truth pose,
    plane_observations and on_keyframe, given the same frame planes (the
    reference's process_frame), each package on its own copy of the
    converted map.  (From each package's own extraction the perpendicular
    association can differ: frame plane 0, the floor, is perpendicular to
    both walls, and ver_id keeps the closer of two ~0 cosines.)"""
    system, tables = mapped
    seq, _ = corner
    i, depth, _, _ = plane_frames[case]
    T = _gt_T_cw(seq, i)
    jmap, pmap = _maps(small_cfg, tables)
    ref = JaxPlaneModule(small_cfg, jmap)
    port = PlaneModule(port_cfg(small_cfg), pmap, CPU)
    ref.process_frame(depth, T)
    port.frame_planes = {k: np.array(v) for k, v in ref.frame_planes.items()}
    port.frame_planes["membership"] = _t(port.frame_planes["membership"])
    port.match(T)
    port.manhattan_Rcw = port.detect_manhattan()
    for k in ("assoc", "par_id", "ver_id"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k), err_msg=k)
    assert port.new_plane == ref.new_plane
    assert ref.manhattan_Rcw is not None and port.full_manhattan == ref.full_manhattan
    np.testing.assert_allclose(port.manhattan_Rcw, ref.manhattan_Rcw, atol=1e-6)
    # the Manhattan rotation is the ground-truth camera rotation
    assert rot_angle(port.manhattan_Rcw @ T[:3, :3].T) < np.radians(2.0)
    a, b = ref.plane_observations(), port.plane_observations()
    for k in a._fields:
        np.testing.assert_array_equal(getattr(b, k).numpy(), np.asarray(getattr(a, k)), err_msg=k)
    kf = int(tables["n_kf"])
    ref.on_keyframe(kf, T)
    port.on_keyframe(kf, T)
    np.testing.assert_array_equal(port.assoc, ref.assoc)
    _assert_maps_equal(jmap, pmap)


def test_line_module_matches_reference(small_cfg, mapped, corner):
    """The port's frame lines of corner frame 8, given to both modules:
    match at the ground-truth pose (associations, the map lines' visible
    and found counts), line_observations, on_keyframe."""
    system, tables = mapped
    seq, frames = corner
    _, gray, depth = frames[8]
    T = _gt_T_cw(seq, 8)
    detector = LineModule(port_cfg(small_cfg), _maps(small_cfg, tables)[1], CPU)
    detector.process_frame(_t(gray.astype(np.float32)), _t(depth.astype(np.float32)), T)
    jmap, pmap = _maps(small_cfg, tables)
    ref = JaxLineModule(small_cfg, jmap)
    port = LineModule(port_cfg(small_cfg), pmap, CPU)
    ref.frame_lines = {k: v.copy() for k, v in detector.frame_lines.items()}
    port.frame_lines = {k: v.copy() for k, v in detector.frame_lines.items()}
    n_ref, n_port = ref.match(T), port.match(T)
    assert n_port == n_ref >= 1
    np.testing.assert_array_equal(port.assoc, ref.assoc)
    _assert_maps_equal(jmap, pmap)  # the visible and found counts
    a, b = ref.line_observations(), port.line_observations()
    for k in a._fields:
        np.testing.assert_array_equal(getattr(b, k).numpy(), np.asarray(getattr(a, k)), err_msg=k)
    kf = int(tables["n_kf"])
    ref.on_keyframe(kf, T)
    port.on_keyframe(kf, T)
    np.testing.assert_array_equal(port.assoc, ref.assoc)
    _assert_maps_equal(jmap, pmap)
