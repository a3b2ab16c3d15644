"""Parity of the port's matching and pose solver with the JAX reference
(ops/matching.py, ops/lm.py, frontend/tracking_ops.py), on numpy inputs
made from a seed.

Matching decisions are exact: Hamming distances are integers and the gates
compare them.  Poses from the solver agree within 1e-5 (float32 sums in
another order over a few iterations); inlier masks are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.frontend import tracking_ops as jtops
from manhattanslam_tpu.geometry import se3 as jse3
from manhattanslam_tpu.ops import lm as jlm
from manhattanslam_tpu.ops import matching as jm
from manhattanslam_tpu_torch import convert
from manhattanslam_tpu_torch.frontend import tracking_ops as ptops
from manhattanslam_tpu_torch.ops import lm as plm
from manhattanslam_tpu_torch.ops import matching as pm

K = np.array([[160.0, 0, 95.5], [0, 160.0, 71.5], [0, 0, 1]], np.float32)
BF = 12.0


def _t(a):
    return convert.tensor_from_numpy(a, "cpu")


def _descs(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _noisy_copies(rng, desc, flips):
    """Copies of `desc` with `flips` random bits flipped per row."""
    out = desc.copy()
    for i in range(len(out)):
        for b in rng.choice(256, flips[i], replace=False):
            out[i, b // 32] ^= np.uint32(1 << (b % 32))
    return out


def test_hamming_matrix_exact():
    rng = np.random.default_rng(0)
    a, b = _descs(rng, 37), _descs(rng, 53)
    ref = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(pm.hamming_matrix(_t(a), _t(b)).numpy(), ref)


@pytest.mark.parametrize("ratio,max_dist", [(0.0, 100), (0.7, 50)])
def test_match_and_resolve_exact(ratio, max_dist):
    rng = np.random.default_rng(1)
    b = _descs(rng, 60)
    src = rng.integers(0, 60, 80)
    a = _noisy_copies(rng, b[src], rng.integers(0, 70, 80))
    va, vb = rng.uniform(size=80) > 0.1, rng.uniform(size=60) > 0.1
    mask = rng.uniform(size=(80, 60)) > 0.3
    ref = jm.match_descriptors(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb),
        max_dist=max_dist, ratio=ratio, extra_mask=jnp.asarray(mask),
    )
    out = pm.match_descriptors(
        _t(a), _t(b), _t(va), _t(vb), max_dist=max_dist, ratio=ratio, extra_mask=_t(mask)
    )
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    idx, dist, ok = out
    res_ref = jm.resolve_one_to_one(*[jnp.asarray(x.numpy()) for x in out], 60)
    np.testing.assert_array_equal(pm.resolve_one_to_one(idx, dist, ok, 60).numpy(), np.asarray(res_ref))
    assert ok.sum() > 10


def test_rotation_consistency_exact():
    rng = np.random.default_rng(2)
    a = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    b = (a - 0.3 + rng.normal(0, 0.05, 200) * (rng.uniform(size=200) < 0.8)
         + rng.uniform(-3, 3, 200) * (rng.uniform(size=200) >= 0.8)).astype(np.float32)
    valid = rng.uniform(size=200) > 0.1
    ref = jm.rotation_consistency_mask(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid))
    out = pm.rotation_consistency_mask(_t(a), _t(b), _t(valid))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert 0 < out.sum() < valid.sum()


def _scene(rng, n_pts=300, n_kp=256):
    """Map points seen by a camera at T_true, keypoints at their noisy
    projections (some with depth), the rest random."""
    T_true = np.asarray(jse3.exp_se3(jnp.asarray(np.float32([0.05, -0.02, 0.1, 0.02, -0.03, 0.01]))))
    pc = np.stack([rng.uniform(-1.5, 1.5, n_pts), rng.uniform(-1, 1, n_pts), rng.uniform(1.5, 4, n_pts)], -1)
    Twc = np.linalg.inv(T_true)
    pw = (pc @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32)
    uv = pc[:, :2] / pc[:, 2:] * K[[0, 1], [0, 1]] + K[:2, 2]
    n_obs = min(n_pts, n_kp) - 40
    xy = np.concatenate([uv[:n_obs] + rng.normal(0, 0.5, (n_obs, 2)),
                         rng.uniform([0, 0], [192, 144], (n_kp - n_obs, 2))]).astype(np.float32)
    depth = np.concatenate([pc[:n_obs, 2] * (rng.uniform(size=n_obs) > 0.3),
                            np.zeros(n_kp - n_obs)]).astype(np.float32)
    desc_map = _descs(rng, n_pts)
    desc_kp = np.concatenate([_noisy_copies(rng, desc_map[:n_obs], rng.integers(0, 30, n_obs)),
                              _descs(rng, n_kp - n_obs)])
    level = rng.integers(0, 3, n_kp).astype(np.int32)
    feats = {
        "xy_und": xy, "desc": desc_kp, "valid": np.ones(n_kp, bool), "level": level,
        "angle": rng.uniform(-np.pi, np.pi, n_kp).astype(np.float32), "depth": depth,
        "u_right": np.where(depth > 0, xy[:, 0] - BF / np.maximum(depth, 1e-6), -1).astype(np.float32),
        "inv_sigma2": (1.0 / 1.2 ** (2.0 * level)).astype(np.float32),
    }
    dist = np.linalg.norm(pw - Twc[:3, 3], axis=1)
    normal = (pw - Twc[:3, 3]) / dist[:, None]
    pts = {
        "pos": pw, "desc": desc_map, "valid": np.ones(n_pts, bool),
        "normal": normal.astype(np.float32), "min_dist": (dist * 0.4).astype(np.float32),
        "max_dist": (dist * 1.1).astype(np.float32), "level": np.zeros(n_pts, np.int32),
    }
    return T_true, pts, feats


@pytest.fixture(scope="module")
def scene():
    return _scene(np.random.default_rng(3))


def test_frustum_and_projection_problem_exact(scene):
    T_true, pts, feats = scene
    T_seed = np.asarray(jse3.exp_se3(jnp.asarray(np.float32([0.01, 0.0, -0.01, 0.0, 0.005, 0.0])))) @ T_true
    jp = {k: jnp.asarray(v) for k, v in pts.items()}
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    pp = {k: _t(v) for k, v in pts.items()}
    pf = {k: _t(v) for k, v in feats.items()}
    Kj, Kp = jnp.asarray(K), torch.from_numpy(K)
    cand_ref = jm.frustum_candidates(jp, jnp.asarray(T_seed), Kj, (144, 192), 128, use_scale_gate=True)
    cand = pm.frustum_candidates(pp, torch.from_numpy(T_seed), Kp, (144, 192), 128, use_scale_gate=True)
    v = np.asarray(cand_ref["valid"])
    np.testing.assert_array_equal(cand["valid"].numpy(), v)
    np.testing.assert_array_equal(cand["bank_idx"].numpy()[v], np.asarray(cand_ref["bank_idx"])[v])
    np.testing.assert_array_equal(cand["visible_bank"].numpy(), np.asarray(cand_ref["visible_bank"]))
    prob_ref, aux_ref = jtops.projection_problem(
        jp, jnp.asarray(T_seed), jf, Kj, jnp.float32(7.0), (144, 192),
        jtops.empty_plane_obs(8), jtops.empty_line_obs(8), use_scale_gate=True, cand=cand_ref,
    )
    prob, aux = ptops.projection_problem(pp, torch.from_numpy(T_seed), pf, Kp, 7.0, (144, 192), cand)
    np.testing.assert_array_equal(prob.pt_mask[0].numpy(), np.asarray(prob_ref.pt_mask))
    np.testing.assert_array_equal(aux["point_of_kp"].numpy(), np.asarray(aux_ref["point_of_kp"]))
    np.testing.assert_array_equal(aux["kp_idx"].numpy(), np.asarray(aux_ref["kp_idx"]))
    np.testing.assert_array_equal(aux["match_valid"].numpy(), np.asarray(aux_ref["match_valid"]))
    assert int(aux["n_matches"]) > 50


@pytest.mark.parametrize("gauss_newton,n_rounds,n_iters", [(True, 2, 4), (False, 4, 5)])
def test_solve_pose_matches_reference(scene, gauss_newton, n_rounds, n_iters):
    """The candidate (damped GN) and final (deferred-accept LM) schedules,
    from a perturbed pose, on a problem with outliers (random keypoints)."""
    T_true, pts, feats = scene
    n_kp = len(feats["depth"])
    rng = np.random.default_rng(4)
    kp_idx = np.arange(n_kp, dtype=np.int32)
    pos = np.concatenate([pts["pos"][: n_kp - 40], pts["pos"][rng.integers(0, 300, 40)]])
    matched = rng.uniform(size=n_kp) > 0.05
    T0 = np.asarray(jse3.exp_se3(jnp.asarray(np.float32([0.03, -0.02, 0.02, 0.01, 0.0, -0.01])))) @ T_true
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    prob_ref = jtops.build_point_problem(
        jnp.asarray(pos), jnp.asarray(kp_idx), jnp.asarray(matched), jf,
        jtops.empty_plane_obs(8), jtops.empty_line_obs(8),
    )
    ref = jlm.solve_pose(
        prob_ref, jnp.asarray(T0), jnp.asarray(K), BF, jlm.default_params(),
        n_rounds=n_rounds, n_iters=n_iters, gauss_newton=gauss_newton,
        use_planes=False, use_lines=False,
    )
    ref = jax.device_get(ref)
    prob = ptops.build_point_problem(
        _t(pos), _t(kp_idx), _t(matched), {k: _t(v) for k, v in feats.items()}
    )
    out = plm.solve_pose(
        plm.stack_problems([prob, prob]), torch.from_numpy(np.stack([T0, T0])),
        torch.from_numpy(K), BF, n_rounds=n_rounds, n_iters=n_iters, gauss_newton=gauss_newton,
    )
    for b in range(2):
        np.testing.assert_allclose(out["T"][b].numpy(), ref["T"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(out["inlier_pt"][b].numpy(), ref["inlier_pt"])
    assert int(out["n_inliers"][0]) == int(ref["n_inliers"])
    assert np.abs(ref["T"] - T_true).max() < 1e-2  # the solve converged


def test_descriptor_problem_exact(scene):
    T_true, pts, feats = scene
    n_kp = len(feats["depth"])
    ref_pts = {"pos": pts["pos"][:n_kp], "desc": pts["desc"][:n_kp], "valid": pts["valid"][:n_kp]}
    kf_angles = feats["angle"] + np.float32(0.1)
    _, idx_ref, ok_ref = jtops.descriptor_problem(
        {k: jnp.asarray(v) for k, v in ref_pts.items()}, {k: jnp.asarray(v) for k, v in feats.items()},
        jnp.asarray(kf_angles), jtops.empty_plane_obs(8), jtops.empty_line_obs(8),
    )
    _, idx, ok = ptops.descriptor_problem(
        {k: _t(v) for k, v in ref_pts.items()}, {k: _t(v) for k, v in feats.items()}, _t(kf_angles)
    )
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    np.testing.assert_array_equal(idx.numpy()[ok.numpy()], np.asarray(idx_ref)[np.asarray(ok_ref)])
