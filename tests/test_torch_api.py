"""Public functions of the reference that the port now has under the
reference's names, against the reference on the CPU, with the cases of
tests/test_se3.py, tests/test_matching.py:59-84, tests/test_lm.py and
tests/test_local_mapping.py:138-216.

- geometry/se3: log_so3 (exp/log round trip), rot, trans, compose,
  transform_points, transform_dirs, transform_plane, rotmat_to_quat,
  quat_to_rotmat, project, backproject: within 1e-5 of the reference
  (float32 arithmetic in another order); orthonormalize below.
- ops/matching.search_by_projection: the synthetic frame of
  tests/test_matching.py, uncompacted and compacted to fewer candidates
  than landmarks: bank- and candidate-level results equal.
- ops/orb: gather_patches, hamming_distance and brief_descriptors equal.
- ops/lm.empty_problem: the reference's shapes and dtypes; a solve from
  it stays put, and one filled with tests/test_lm.py's rows recovers the
  pose.
- ops/image: avgpool2_matrix_np and stride_select_matrix_np equal;
  resize_bilinear within 1e-4 (products in another order).
- device_tracker.noop_view_update leaves a view as it was.
- LocalMapper.fuse_neighbors on tests/test_local_mapping.py's two-hop
  scene, and create_new_points on the same scene with free keypoints:
  the map tables after either equal the reference's, the triangulated
  positions (and the distances and normals made from them) within
  tests/test_torch_mapping.py's ``solve_tolerance`` of the two-ray solve;
  create_and_fuse is the two halves with one pull.
- orthonormalize's tolerance is 5e-5: the reference's float32 SVD (XLA)
  and the port's (LAPACK) differ by 1.1e-5 on this matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.geometry import se3 as jse3
from manhattanslam_tpu.mapping import local_mapping as jlmap
from manhattanslam_tpu.ops import image as jimage
from manhattanslam_tpu.ops import lm as jlm
from manhattanslam_tpu.ops import matching as jmatching
from manhattanslam_tpu.ops import orb as jorb
from manhattanslam_tpu.slam_map import SlamMap as JaxSlamMap
from manhattanslam_tpu_torch.frontend import device_tracker as dt
from manhattanslam_tpu_torch.geometry import se3
from manhattanslam_tpu_torch.mapping import local_mapping as lmap
from manhattanslam_tpu_torch.ops import image, lm, matching, orb
from manhattanslam_tpu_torch.slam_map import SlamMap
from test_torch_mapping import solve_tolerance
from torch_parity import port_cfg

CPU = torch.device("cpu")
TOL = 1e-5


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def rngs():
    rng = np.random.default_rng(42)
    ws = (rng.normal(size=(10, 3)) * 0.8).astype(np.float32)
    xis = (rng.normal(size=(4, 6)) * 0.5).astype(np.float32)
    return rng, ws, xis


def test_se3_maps_match_reference(rngs):
    rng, ws, xis = rngs
    R = se3.exp_so3(torch.from_numpy(ws))
    _close(se3.log_so3(R), jse3.log_so3(jnp.asarray(R.numpy())))
    np.testing.assert_allclose(se3.log_so3(R).numpy(), ws, atol=1e-4)  # the round trip
    q = se3.rotmat_to_quat(R)
    _close(q, jse3.rotmat_to_quat(jnp.asarray(R.numpy())))
    _close(se3.quat_to_rotmat(q), jse3.quat_to_rotmat(jnp.asarray(q.numpy())))
    _close(se3.quat_to_rotmat(q), R.numpy())
    T = se3.exp_se3(torch.from_numpy(xis))
    A, B = T[0], T[1]
    jA, jB = jnp.asarray(A.numpy()), jnp.asarray(B.numpy())
    _close(se3.rot(A), jse3.rot(jA))
    _close(se3.trans(A), jse3.trans(jA))
    _close(se3.compose(A, B), jse3.compose(jA, jB))
    pts = rng.normal(size=(3, 3)).astype(np.float32)
    _close(se3.transform_points(A, torch.from_numpy(pts)), jse3.transform_points(jA, pts))
    _close(se3.transform_dirs(A, torch.from_numpy(pts)), jse3.transform_dirs(jA, pts))
    # a plane through the 3 points stays through them (tests/test_se3.py)
    n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
    n = n / np.linalg.norm(n)
    pi = np.concatenate([n, [-n @ pts[0]]]).astype(np.float32)
    pi_t = se3.transform_plane(A, torch.from_numpy(pi))
    _close(pi_t, jse3.transform_plane(jA, pi))
    resid = se3.transform_points(A, torch.from_numpy(pts)) @ pi_t[:3] + pi_t[3]
    np.testing.assert_allclose(resid.numpy(), 0, atol=1e-4)


def test_project_backproject_orthonormalize(rngs):
    rng, ws, _ = rngs
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    pts = rng.uniform(0.5, 5.0, size=(50, 3)).astype(np.float32)
    uv = se3.project(torch.from_numpy(K), torch.from_numpy(pts))
    _close(uv, jse3.project(jnp.asarray(K), jnp.asarray(pts)), 1e-3)
    back = se3.backproject(torch.from_numpy(K), uv, torch.from_numpy(pts[:, 2]))
    _close(back, jse3.backproject(jnp.asarray(K), jnp.asarray(uv.numpy()), pts[:, 2]))
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-3)
    R = se3.exp_so3(torch.from_numpy(ws[:1]))[0].numpy()
    noisy = (R + rng.normal(size=(3, 3)) * 0.01).astype(np.float32)
    for M in (noisy, -noisy):  # -noisy: U V^T is improper
        R2 = se3.orthonormalize(torch.from_numpy(M))
        _close(R2, jse3.orthonormalize(jnp.asarray(M)), 5e-5)
        np.testing.assert_allclose(R2.numpy() @ R2.numpy().T, np.eye(3), atol=1e-5)


@pytest.mark.parametrize("cand_cap", [4096, 32])
def test_search_by_projection_matches_reference(cand_cap):
    """tests/test_matching.py:59-84: keypoints at the exact projections of
    the landmarks; cand_cap 32 < 50 landmarks compacts the frustum."""
    rng = np.random.default_rng(7)
    n = 50
    pts_w = rng.uniform([-2, -2, 2], [2, 2, 6], (n, 3)).astype(np.float32)
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    descs = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    uv, _ = jmatching.project_points(jnp.asarray(T), jnp.asarray(pts_w), jnp.asarray(K))
    feats = {"xy_und": np.asarray(uv), "desc": descs, "valid": np.ones(n, bool),
             "level": np.zeros(n, np.int32)}
    levels = rng.integers(0, 2, n).astype(np.int32)
    args = dict(radius=5.0, cand_cap=cand_cap)
    ref = jmatching.search_by_projection(
        jnp.asarray(pts_w), jnp.asarray(descs), jnp.ones(n, bool), jnp.asarray(T),
        {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(K), (240, 320),
        point_levels=jnp.asarray(levels), **args)
    out = matching.search_by_projection(
        _t(pts_w), _t(descs), torch.ones(n, dtype=torch.bool), _t(T),
        {k: _t(v) for k, v in feats.items()}, _t(K), (240, 320), point_levels=_t(levels),
        **args)
    for k in ("kp_idx", "valid", "c_bank", "c_kp", "c_ok"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in ("dist", "c_dist"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]).astype(np.float32))
    _close(out["proj_uv"], ref["proj_uv"], 1e-3)
    v = out["valid"].numpy()
    assert v.sum() > 20
    np.testing.assert_array_equal(out["kp_idx"].numpy()[v], np.arange(n)[v])


def test_orb_helpers_match_reference():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (40, 60)).astype(np.float32)
    xy = np.array([[0, 0], [30.7, 20.2], [59, 39], [10, 35]], np.float32)
    np.testing.assert_array_equal(orb.gather_patches(_t(img), _t(xy), 5).numpy(),
                                  np.asarray(jorb.gather_patches(jnp.asarray(img), xy, 5)))
    a = rng.integers(0, 2**32, (17, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (23, 8), dtype=np.uint32)
    np.testing.assert_array_equal(
        orb.hamming_distance(_t(a)[:, None], _t(b)[None]).numpy(),
        np.asarray(jorb.hamming_distance(jnp.asarray(a)[:, None], jnp.asarray(b)[None])))
    blurred = np.round(img)
    kp = np.array([[20, 20], [30.4, 19.6], [40, 22]], np.float32)
    ang = np.array([0.0, 1.3, -2.5], np.float32)
    np.testing.assert_array_equal(
        orb.brief_descriptors(_t(blurred), _t(kp), _t(ang)).numpy().view(np.uint32),
        np.asarray(jorb.brief_descriptors(jnp.asarray(blurred), jnp.asarray(kp), jnp.asarray(ang))))


def test_empty_problem_and_solve():
    ref = jlm.empty_problem(npt=256, nl=16)
    port = lm.empty_problem(npt=256, nl=16)
    for name in ref._fields:
        r, p = np.asarray(getattr(ref, name)), getattr(port, name)
        assert tuple(p.shape) == r.shape and (p.dtype == torch.bool) == (r.dtype == bool), name
        assert not p.any(), name
    K = torch.tensor([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    out = lm.solve_pose(lm.empty_problem(lead=(1,)), torch.eye(4)[None], K, 30.0,
                        lm.default_params())
    assert torch.isfinite(out["T"]).all()
    np.testing.assert_allclose(out["T"][0].numpy(), np.eye(4), atol=1e-5)
    # tests/test_lm.py's mono and stereo rows: the solve recovers the pose
    rng = np.random.default_rng(11)
    T_gt = se3.exp_se3(torch.tensor([0.05, -0.03, 0.1, 0.02, -0.04, 0.03])).numpy()
    pts = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], (120, 3)).astype(np.float32)
    pc = pts @ T_gt[:3, :3].T + T_gt[:3, 3]
    u, v = pc[:, 0] / pc[:, 2] * 300 + 160, pc[:, 1] / pc[:, 2] * 300 + 120
    obs = np.stack([u, v, np.where(np.arange(120) >= 60, u - 30.0 / pc[:, 2], 0)], -1)
    prob = lm.empty_problem(npt=256, nl=16, lead=(1,))
    prob.pt_xw[0, :120] = torch.from_numpy(pts)
    prob.pt_obs[0, :120] = torch.from_numpy(obs.astype(np.float32))
    prob.pt_info[0, :120] = 1.0
    prob.pt_stereo[0, 60:120] = True
    prob.pt_mask[0, :120] = True
    out = lm.solve_pose(prob, torch.eye(4)[None], K, 30.0, lm.default_params())
    assert np.abs(out["T"][0].numpy() - T_gt).max() < 2e-3


def test_image_operators_match_reference():
    for n in (31, 144):
        np.testing.assert_array_equal(image.avgpool2_matrix_np(n), jimage.avgpool2_matrix_np(n))
        for s in (2, 3):
            np.testing.assert_array_equal(image.stride_select_matrix_np(n, s),
                                          jimage.stride_select_matrix_np(n, s))
    img = np.random.default_rng(5).uniform(0, 255, (144, 192)).astype(np.float32)
    _close(image.resize_bilinear(_t(img), (120, 160)),
           jimage.resize_bilinear(jnp.asarray(img), (120, 160)), 1e-3)
    same = _t(img)
    assert image.resize_bilinear(same, (144, 192)) is same


def test_noop_view_update_leaves_the_view(small_cfg):
    cfg = port_cfg(small_cfg)
    m = SlamMap(cfg)
    m.add_points(np.ones((3, 3), np.float32), np.ones((3, 8), np.uint32),
                 np.zeros((3, 3), np.float32), np.zeros(3, np.float32),
                 np.ones(3, np.float32), np.zeros(3, np.int32), 0)
    host = dt.build_host_view(cfg, m)
    view = dt.upload_view(host, CPU)
    before = {k: v.clone() for k, v in view.items()}
    dt.apply_view_update(view, [dt.noop_view_update(host)])
    for k in view:
        assert torch.equal(view[k], before[k]), k


def _scene(map_cls, cfg, free_in_a: bool):
    """tests/test_local_mapping.py:138-216's three cameras (0, 5 and 10 cm
    apart) over 40 points; keyframe A holds points 0..19, B shares them
    and holds 20..39, C holds 20..39 and duplicates of 0..19.  With
    free_in_a, A's keypoints 20..39 are free (A and C, 10 cm apart, can
    triangulate them)."""
    rng = np.random.default_rng(17)
    m = map_cls(cfg)
    Kc = np.asarray(cfg.camera.K)
    NKP = cfg.caps.max_keypoints
    pts = rng.uniform([-0.6, -0.4, 2.0], [0.6, 0.4, 3.0], (40, 3)).astype(np.float32)
    descs = rng.integers(0, 2**32, (40, 8), dtype=np.uint32)
    poses = []
    for dx in (0.0, 0.05, 0.10):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -dx
        poses.append(T)

    def feats_for(T):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        uv = np.zeros((NKP, 2), np.float32)
        uv[:40, 0] = pc[:, 0] / pc[:, 2] * Kc[0, 0] + Kc[0, 2]
        uv[:40, 1] = pc[:, 1] / pc[:, 2] * Kc[1, 1] + Kc[1, 2]
        d = np.zeros((NKP, 8), np.uint32)
        d[:40] = descs
        valid = np.zeros(NKP, bool)
        valid[:40] = True
        return {"xy_und": uv, "u_right": np.full(NKP, -1.0, np.float32),
                "depth": np.zeros(NKP, np.float32), "level": np.zeros(NKP, np.int32),
                "angle": np.zeros(NKP, np.float32), "desc": d, "valid": valid}

    A, B, C = (m.add_keyframe(poses[i], float(i), i, feats_for(poses[i])) for i in range(3))

    def add(sl, kf):
        n = sl.stop - sl.start
        return m.add_points(pts[sl], descs[sl], np.zeros((n, 3), np.float32),
                            np.full(n, 0.1, np.float32), np.full(n, 10.0, np.float32),
                            np.zeros(n, np.int32), kf)

    ids_ab, ids_bc, dup = add(slice(0, 20), A), add(slice(20, 40), B), add(slice(0, 20), C)
    assoc = np.full((3, NKP), -1, np.int64)
    assoc[0, :20] = ids_ab
    assoc[1, :20] = ids_ab
    assoc[1, 20:40] = ids_bc
    assoc[2, 20:40] = ids_bc
    assoc[2, :20] = dup
    if free_in_a:
        assoc[2, 20:40] = -1  # C's 20..39 free as well
        assoc[2, :20] = ids_ab
    for kf, a in zip((A, B, C), assoc):
        m.set_kf_matches(kf, a)
    return m, A, dup


def _assert_maps_equal(port, ref, pos_tol=0.0):
    for name in ("mp_valid", "mp_desc", "mp_level", "mp_first_kf", "kf_mp_idx", "covis"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    for name in ("mp_pos", "mp_normal", "mp_min_dist", "mp_max_dist"):
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name), rtol=0,
                                   atol=pos_tol, err_msg=name)


def test_fuse_neighbors_matches_reference(small_cfg):
    cfg = port_cfg(small_cfg)
    pm, A, dup = _scene(SlamMap, cfg, free_in_a=False)
    rm, _, _ = _scene(JaxSlamMap, small_cfg, free_in_a=False)
    lmap.LocalMapper(cfg, pm, CPU).fuse_neighbors(A)
    jlmap.LocalMapper(small_cfg, rm).fuse_neighbors(A)
    assert not pm.mp_valid[dup].any()  # the two-hop duplicates merged
    _assert_maps_equal(pm, rm)
    for k, v in lmap.kf_feats_one(pm, A).items():
        np.testing.assert_array_equal(_t(np.asarray(jlmap.kf_feats_one(rm, A)[k])).numpy(),
                                      v.numpy(), err_msg=k)


def test_create_new_points_matches_reference(small_cfg):
    cfg = port_cfg(small_cfg)
    pm, A, _ = _scene(SlamMap, cfg, free_in_a=True)
    rm, _, _ = _scene(JaxSlamMap, small_cfg, free_in_a=True)
    n0 = int(pm.mp_valid.sum())
    lmap.LocalMapper(cfg, pm, CPU).create_new_points(A)
    jlmap.LocalMapper(small_cfg, rm).create_new_points(A)
    new = np.nonzero(pm.mp_valid)[0][n0:]
    assert len(new) > 10  # A's free keypoints triangulated with C
    tol = solve_tolerance(pm.mp_pos[new].astype(np.float64), np.zeros(3), np.array([0.1, 0, 0]))
    _assert_maps_equal(pm, rm, pos_tol=float(tol.max()))
    # create_and_fuse: both halves against the tables before either applies
    both, A2, _ = _scene(SlamMap, cfg, free_in_a=True)
    halves, _, _ = _scene(SlamMap, cfg, free_in_a=True)
    lmap.LocalMapper(cfg, both, CPU).create_and_fuse(A2)
    mapper = lmap.LocalMapper(cfg, halves, CPU)
    (tri, tri_apply), (fuse, fuse_apply) = (mapper.create_new_points(A2, defer=True),
                                            mapper.fuse_neighbors(A2, defer=True))
    tri_apply(lmap.pull(tri))
    fuse_apply(lmap.pull(fuse))
    _assert_maps_equal(both, halves)
