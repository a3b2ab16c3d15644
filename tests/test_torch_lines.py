"""Lines in the port against the reference, on the CPU.

- ``sobel`` and the 2x2 box downsample: exact, the downsample on
  integer-valued images (the tracker's gray comes from u8) against the
  reference's two banded products.
- ``eig33_largest``: within 1e-6 (the same closed form, float32).
- The sample tables equal ``jnp.linspace``'s values.
- The detector's hazards, each against its JAX counterpart: the edge
  threshold with the population std, the integer vote grid (exact), the
  peaks with ties in index order, and ``nanmedian`` at an even count.
- ``detect_lines`` at small_cfg size (full resolution) and at 640x480
  (the half-resolution branch), on a "wall" and a "near_corner" frame of
  the box room, gray quantized to u8 as the tracker uploads it: ``valid``
  and ``response`` equal; each valid segment's endpoints within 0.02 px
  of the reference's, as an unordered pair (the refit moments are float32
  sums in another order, and a near-vertical line's orientation is the
  sign of a cross moment that is zero up to rounding in both packages);
  B = 2 frames in one call equal two single calls.
- ``line_descriptors`` on the reference's segments: within 1e-5 on the
  valid lines.
- ``lift_lines_3d`` on the reference's segments: ``ok`` and ``n_inliers``
  equal, ``sp3``/``ep3`` within 1e-5 m on the lifted lines.
- ``associate_lines_device`` on a constructed case whose six best
  similarities (an even count) put one line between the threshold of
  numpy's median and that of the lower middle value (torch.nanmedian's):
  the reference's decision.
- The line rows of the solver: the closed-form Jacobian against
  forward-mode AD within 1e-5 of the largest entry; ``solve_pose`` with
  points and lines against the reference's: T within 1e-5, the same
  inliers of both families.
- The slice (the full-body tracker against the reference's) is in
  tests/test_torch_manhattan.py, which shares the reference's compiled
  full step with the planes tests.
- ``System(enable_planes=True, enable_lines=True)`` on the CPU holds the
  reference's line bar (tests/test_lines_e2e.py): every frame tracked,
  at least 3 map lines, each longer than 0.05 m, and a frame line
  associated on the last frame.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.frontend import device_tracker as jdt
from manhattanslam_tpu.geometry import se3 as jse3
from manhattanslam_tpu.ops import eig33 as jeig
from manhattanslam_tpu.ops import image as jimage
from manhattanslam_tpu.ops import lines as jlines
from manhattanslam_tpu.ops import lm as jlm
from manhattanslam_tpu_torch.config import load_config
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu_torch.frontend import device_tracker as pdt
from manhattanslam_tpu_torch.ops import eig33 as peig
from manhattanslam_tpu_torch.ops import image as pimage
from manhattanslam_tpu_torch.ops import lines as plines
from manhattanslam_tpu_torch.ops import lm as plm
from manhattanslam_tpu_torch.system import System
from torch_parity import port_cfg

CPU = torch.device("cpu")
SEG_TOL_PX = 0.02
TUM1 = load_config(str(Path(__file__).resolve().parent.parent / "configs" / "TUM1.yaml"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _u8_frame(seq, i):
    """Frame i with its gray quantized to u8 values and its depth to
    DEPTH_QUANT steps, as the tracker uploads them."""
    _, gray, depth = seq.frame(i)
    g8, d16 = pdt.to_native(gray, depth)
    return g8.astype(np.float32), (d16.astype(np.float32) * np.float32(1.0 / pdt.DEPTH_QUANT))


# ------------------------------------------------------------- image ops
def test_sobel_and_box_downsample_exact():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 37, 53)).astype(np.float32)
    gx, gy = pimage.sobel(_t(img))
    for b in range(2):
        rx, ry = jimage.sobel(jnp.asarray(img[b]))
        np.testing.assert_array_equal(gx[b].numpy(), np.asarray(rx))
        np.testing.assert_array_equal(gy[b].numpy(), np.asarray(ry))
        ay = jnp.asarray(jimage.avgpool2_matrix_np(37))
        ax = jnp.asarray(jimage.avgpool2_matrix_np(53))
        ref = np.asarray(ay @ jnp.asarray(img[b]) @ ax.T)
        out = pimage.avgpool2(_t(img))[b].numpy()
        assert out.shape == (18, 26)
        np.testing.assert_array_equal(out, ref)


def test_eig33_largest_matches_reference():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(50, 3)) * np.float32([3.0, 0.2, 0.05])
    pts = rng.normal(size=(50, 40, 1)) * d[:, None, :] + rng.normal(0, 0.01, (50, 40, 3))
    cen = pts - pts.mean(1, keepdims=True)
    cov = np.einsum("nsi,nsj->nij", cen, cen).astype(np.float32) / 40
    lam, vec = peig.eig33_largest(_t(cov))
    lam_r, vec_r = jeig.eig33_largest(jnp.asarray(cov))
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_r), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(vec.numpy(), np.asarray(vec_r), rtol=0, atol=1e-6)
    w, v = np.linalg.eigh(cov.astype(np.float64))
    assert np.abs(np.abs(np.sum(v[..., 2] * vec.numpy(), -1)) - 1).max() < 1e-4


def test_sample_tables_equal_jnp_linspace():
    for args in ((0.05, 0.95, 24), (0.0, 1.0, 64), (0, 31, 10), (32, 63, 10)):
        np.testing.assert_array_equal(plines.linspace_f32(*args), np.asarray(jnp.linspace(*args)))


# -------------------------------------------------------------- hazards
def test_edge_threshold_is_the_population_std():
    rng = np.random.default_rng(2)
    mag = rng.gamma(2.0, 30.0, (2, 500)).astype(np.float32)
    th = plines.edge_threshold(_t(mag), 40.0).numpy()
    ref = [float(jnp.maximum(jnp.mean(m) + 1.5 * jnp.std(m), 40.0)) for m in jnp.asarray(mag)]
    np.testing.assert_allclose(th, ref, rtol=1e-6)
    sample = [float(m.mean() + 1.5 * m.std(ddof=1)) for m in mag.astype(np.float64)]
    assert np.abs(np.asarray(sample) - ref).min() > 1e-2  # torch's default would differ


def test_vote_grid_counts_exactly():
    """Counts of up to 3000 pixels in one bin, where a float16 one-hot
    product would already round; equal to numpy's histogram."""
    rng = np.random.default_rng(3)
    idx = np.concatenate([rng.integers(0, 500, 4000), np.full(3001, 7)])
    edge = rng.uniform(size=idx.size) > 0.1
    edge[-3001:] = True
    edge[-1] = False
    got = plines.vote_grid(_t(idx), _t(edge), 500).numpy()
    want = np.zeros(500, np.int64)
    np.add.at(want, idx[edge], 1)
    np.testing.assert_array_equal(got, want)
    assert got[7] > 3000


def test_peaks_take_ties_in_index_order():
    rng = np.random.default_rng(4)
    v = rng.integers(0, 4, (3, 2000)).astype(np.float32)  # mostly ties
    v[:, 1500:] = 0.0
    vals, idx = plines.top_peaks(_t(v), 64)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(v), 64)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))


def test_nanmedian_is_numpys_at_even_counts():
    x = np.full((4, 9), np.nan, np.float32)
    x[0, :6] = [0.9, 0.8, 0.7, 0.6, 0.5, 0.35]  # even
    x[1, :5] = [0.3, 0.1, 0.2, 0.5, 0.4]  # odd
    x[2, :2] = [0.25, 0.75]
    got = pdt.nanmedian(_t(x)).numpy()
    ref = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(got, ref)  # row 3 (no values) is nan in both
    assert got[0] == np.float32(0.65) and torch.nanmedian(_t(x[0])).item() != got[0]


# ------------------------------------------------------------- detection
@pytest.fixture(scope="module")
def frames(small_cfg):
    """u8-quantized frames: small_cfg and 640x480 (TUM1), wall and
    near_corner views, frames 0 and 7 of each."""
    out = {}
    for size, cam in (("small", port_cfg(small_cfg).camera), ("640x480", TUM1.camera)):
        for view in ("wall", "near_corner"):
            seq = SyntheticSequence(n_frames=12, cam=cam, view=view)
            out[size, view] = (cam, [_u8_frame(seq, i) for i in (0, 7)])
    return out


def _endpoint_error(sp, ep, sp_r, ep_r):
    """Per segment, the larger endpoint error of the better of the two
    pairings (px)."""
    same = np.maximum(np.abs(sp - sp_r).max(-1), np.abs(ep - ep_r).max(-1))
    swap = np.maximum(np.abs(sp - ep_r).max(-1), np.abs(ep - sp_r).max(-1))
    return np.minimum(same, swap)


@pytest.mark.parametrize("size", ["small", "640x480"])
@pytest.mark.parametrize("view", ["wall", "near_corner"])
def test_detect_descriptors_and_lift_match_reference(frames, size, view):
    cam, pairs = frames[size, view]
    L = 32 if size == "small" else 64
    K = np.asarray(cam.K, np.float32)
    grays = np.stack([g for g, _ in pairs])
    depths = np.stack([d for _, d in pairs])
    both = plines.detect_lines(_t(grays), L)
    for b, (gray, depth) in enumerate(pairs):
        ref = jax.device_get(jlines.detect_lines(jnp.asarray(gray), L))
        out = {k: v.numpy() for k, v in plines.detect_lines(_t(gray), L).items()}
        for k in out:  # B frames in one call = B single calls
            np.testing.assert_array_equal(both[k][b].numpy(), out[k], err_msg=k)
        v = ref["valid"]
        assert v.sum() >= 5
        np.testing.assert_array_equal(out["valid"], v)
        np.testing.assert_array_equal(out["response"], ref["response"])
        err = _endpoint_error(out["sp"][v], out["ep"][v], ref["sp"][v], ref["ep"][v])
        assert err.max() < SEG_TOL_PX, err

        # descriptors and lifting on the reference's own segments
        sp, ep = _t(ref["sp"]), _t(ref["ep"])
        desc = plines.line_descriptors(_t(gray), sp, ep).numpy()
        desc_ref = np.asarray(jlines.line_descriptors(jnp.asarray(gray), jnp.asarray(ref["sp"]),
                                                      jnp.asarray(ref["ep"])))
        np.testing.assert_allclose(desc[v], desc_ref[v], rtol=0, atol=1e-5)
        lift = plines.lift_lines_3d(_t(depth), _t(K), sp, ep, _t(v))
        lift_ref = jax.device_get(jlines.lift_lines_3d(
            jnp.asarray(depth), jnp.asarray(K), jnp.asarray(ref["sp"]), jnp.asarray(ref["ep"]),
            jnp.asarray(v)))
        ok = lift_ref["ok"]
        np.testing.assert_array_equal(lift["ok"].numpy(), ok)
        np.testing.assert_array_equal(lift["n_inliers"].numpy(), lift_ref["n_inliers"])
        assert ok.sum() >= 3
        for k in ("sp3", "ep3"):
            np.testing.assert_allclose(lift[k].numpy()[ok], lift_ref[k][ok], rtol=0, atol=1e-5)


# ----------------------------------------------------------- association
def _constructed_association():
    """Six map lines 2 m in front of the identity pose, far apart in the
    image; frame line j lies on map line j's projection with descriptor
    cosine s1[j] against it and 0 against every other.  Two more frame
    lines are invalid.  The numpy median threshold (0.3164) keeps line 5
    (s1 = 0.35); the lower middle value's (0.3776) would drop it."""
    s1 = np.float32([0.9, 0.8, 0.7, 0.6, 0.5, 0.35])
    K = np.float32([[160, 0, 95.5], [0, 160, 71.5], [0, 0, 1]])
    ML, L, D = 16, 8, plines.DESC_DIM
    ml_sp = np.zeros((ML, 3), np.float32)
    ml_ep = np.zeros((ML, 3), np.float32)
    ml_desc = np.zeros((ML, D), np.float32)
    ml_valid = np.zeros(ML, bool)
    sp = np.zeros((L, 2), np.float32)
    ep = np.zeros((L, 2), np.float32)
    desc = np.zeros((L, D), np.float32)
    for j in range(6):
        x0, y0 = -0.8 + 0.3 * j, -0.4 + 0.12 * j
        ml_sp[j], ml_ep[j] = (x0, y0, 2.0), (x0 + 0.05, y0 + 0.3, 2.0)
        ml_desc[j, j] = 1.0
        ml_valid[j] = True
        for p, q in ((sp, ml_sp), (ep, ml_ep)):
            p[j] = q[j, :2] / q[j, 2] * 160 + K[:2, 2]
        desc[j, j] = s1[j]
        desc[j, 20 + j] = np.sqrt(1 - s1[j] ** 2)
    valid = np.arange(L) < 6
    det = {"sp": sp, "ep": ep, "valid": valid,
           "angle": np.arctan2(ep[:, 1] - sp[:, 1], ep[:, 0] - sp[:, 0]).astype(np.float32)}
    view = {"ml_sp": ml_sp, "ml_ep": ml_ep, "ml_desc": ml_desc, "ml_valid": ml_valid}
    return det, desc, np.eye(4, dtype=np.float32), view, K, s1


def _associate_both(det, desc, T, view, K, hw):
    ref_assoc, ref_vis = jdt.associate_lines_device(
        {k: jnp.asarray(v) for k, v in det.items()}, jnp.asarray(desc), jnp.asarray(T),
        {k: jnp.asarray(v) for k, v in view.items()}, jnp.asarray(K), image_hw=hw)
    assoc, vis = pdt.associate_lines_device(
        {k: _t(v)[None] for k, v in det.items()}, _t(desc)[None], _t(T)[None],
        {k: _t(v) for k, v in view.items()}, _t(K), hw)
    return (np.asarray(ref_assoc), np.asarray(ref_vis)), (assoc[0].numpy(), vis[0].numpy())


def test_association_median_at_an_even_count():
    det, desc, T, view, K, s1 = _constructed_association()
    (ref_assoc, ref_vis), (assoc, vis) = _associate_both(det, desc, T, view, K, (144, 192))
    np.testing.assert_array_equal(assoc, ref_assoc)
    np.testing.assert_array_equal(vis, ref_vis)
    np.testing.assert_array_equal(assoc, [0, 1, 2, 3, 4, 5, -1, -1])
    # with the lower middle value as the median, line 5 would be dropped
    lower = torch.nanmedian(_t(s1)).item()
    mad = torch.nanmedian(torch.abs(_t(s1) - lower)).item()
    assert s1[5] < lower - 1.4826 * 1.5 * mad


# --------------------------------------------------------------- solver
def _line_problem():
    """Points and line endpoints seen from a known pose (observed lines
    with noise, a few rows masked) and a perturbed start pose."""
    rng = np.random.default_rng(5)
    N, NL = 48, 24
    K = np.float32([[160, 0, 95.5], [0, 160, 71.5], [0, 0, 1]])
    bf = 12.0
    T_true = np.asarray(jse3.exp_se3(jnp.float32([0.1, -0.05, 0.2, 0.05, 0.1, -0.02])))

    def project(pw, T):
        pc = pw @ T[:3, :3].T + T[:3, 3]
        return pc[:, :2] / pc[:, 2:] * 160 + K[:2, 2], pc

    pw = rng.uniform([-1, -1, 2], [1, 1, 4], (N, 3)).astype(np.float32)
    uv, pc = project(pw, T_true)
    obs = np.concatenate([uv, (uv[:, 0] - bf / pc[:, 2])[:, None]], 1)
    obs = (obs + rng.normal(0, 0.5, (N, 3))).astype(np.float32)
    a = rng.uniform([-1, -1, 2], [1, 1, 4], (NL // 2, 3)).astype(np.float32)
    b = (a + rng.normal(0, 0.5, a.shape)).astype(np.float32)
    ua, _ = project(a, T_true)
    ub, _ = project(b, T_true)
    ua, ub = ua + rng.normal(0, 0.3, ua.shape), ub + rng.normal(0, 0.3, ub.shape)
    eq = np.cross(np.concatenate([ua, np.ones((NL // 2, 1))], 1),
                  np.concatenate([ub, np.ones((NL // 2, 1))], 1))
    eq = (eq / np.linalg.norm(eq, axis=1, keepdims=True)).astype(np.float32)
    ln_mask = np.repeat(np.arange(NL // 2) >= 2, 2)
    arrays = dict(
        pt_xw=pw, pt_obs=obs, pt_info=np.ones(N, np.float32),
        pt_stereo=rng.uniform(size=N) > 0.3, pt_mask=np.arange(N) >= 4,
        ln_xw=np.stack([a, b], 1).reshape(NL, 3), ln_eq=np.repeat(eq, 2, 0),
        ln_info=ln_mask.astype(np.float32), ln_mask=ln_mask,
    )
    T0 = np.asarray(jse3.exp_se3(jnp.float32([0.03, -0.02, 0.02, 0.01, 0.0, -0.01]))) @ T_true
    return arrays, K, bf, T_true, T0


def _port_problem(arrays, B=1):
    P = 8
    planes = [torch.zeros(B, P, 4), torch.zeros(B, P, 4), torch.zeros(B, P, dtype=torch.bool)] * 3
    f = {k: _t(v)[None].expand((B,) + v.shape) for k, v in arrays.items()}
    return plm.PoseProblem(f["pt_xw"], f["pt_obs"], f["pt_info"], f["pt_stereo"], f["pt_mask"],
                           *planes, f["ln_xw"], f["ln_eq"], f["ln_info"], f["ln_mask"])


@pytest.mark.parametrize("translation_only", [False, True])
def test_line_rows_jacobian_matches_forward_mode_ad(translation_only):
    arrays, K, _, _, T0 = _line_problem()
    prob = _port_problem(arrays, B=2)
    T = _t(np.stack([T0, np.linalg.inv(T0)]))
    dof = 3 if translation_only else 6
    xi0 = torch.zeros(2, dof)

    def rows(xi):
        return plm.line_residuals(plm._retract(T, xi, translation_only), prob, _t(K))

    basis = torch.eye(dof)[:, None, :].expand(dof, 2, dof)
    _, cols = torch.func.vmap(lambda v: torch.func.jvp(rows, (xi0,), (v,)), out_dims=(None, 0))(basis)
    J_ad = cols.permute(1, 2, 0)
    J = plm._line_jacobians(T, prob, _t(K), translation_only)
    assert float((J - J_ad).abs().max()) <= 1e-5 * float(J_ad.abs().max())


def test_solve_pose_with_lines_matches_reference():
    """The final solve's deferred-accept LM with points and lines (4
    rounds: Huber on, then off; 2 iterations each keep the reference's
    unrolled compile short)."""
    arrays, K, bf, T_true, T0 = _line_problem()
    P = 8
    planes = dict(pl_w=jnp.zeros((P, 4)), pl_obs=jnp.zeros((P, 4)), pl_mask=jnp.zeros(P, bool),
                  par_w=jnp.zeros((P, 4)), par_obs=jnp.zeros((P, 4)), par_mask=jnp.zeros(P, bool),
                  ver_w=jnp.zeros((P, 4)), ver_obs=jnp.zeros((P, 4)), ver_mask=jnp.zeros(P, bool))
    prob_ref = jlm.PoseProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}, **planes)
    kw = dict(n_rounds=4, n_iters=2, gauss_newton=False, use_lines=True)
    ref = jax.device_get(jlm.solve_pose(
        prob_ref, jnp.asarray(T0), jnp.asarray(K), bf, jlm.default_params(), use_planes=False, **kw))
    out = plm.solve_pose(_port_problem(arrays, B=2), _t(np.stack([T0, T0])), _t(K), bf,
                         plm.default_params(), **kw)
    for b in range(2):
        np.testing.assert_allclose(out["T"][b].numpy(), ref["T"], rtol=0, atol=1e-5)
        for k in ("inlier_pt", "inlier_ln"):
            np.testing.assert_array_equal(out[k][b].numpy(), ref[k], err_msg=k)
        assert int(out["n_inliers"][b]) == int(ref["n_inliers"])
    assert 0 < ref["inlier_ln"].sum() < arrays["ln_mask"].sum() + 1
    assert np.abs(ref["T"] - T_true).max() < 1e-2  # the solve converged


def test_system_with_lines_holds_the_reference_line_bar(small_cfg):
    seq = SyntheticSequence(n_frames=6, cam=port_cfg(small_cfg).camera, view="near_corner")
    system = System(port_cfg(small_cfg), fast=True, enable_planes=True, enable_lines=True,
                    enable_surfels=False, device="cpu")
    poses = [system.track(g, d, ts) for ts, g, d in (seq.frame(i) for i in range(6))]
    assert all(p is not None for p in poses)
    m = system.map
    assert int(m.ml_valid.sum()) >= 3
    for j in np.nonzero(m.ml_valid)[0]:
        assert np.linalg.norm(m.ml_sp[j] - m.ml_ep[j]) > 0.05
    assert int((system.tracker.last_result["line_assoc"] >= 0).sum()) >= 1
