"""The plain reference of the fused tracking step: a frozen copy of the
port's ``frontend/device_tracker.py`` body (``build_batched_body``) and of
its plane, Manhattan and line association helpers, in plain PyTorch with
no kernel: features from ``reference/orb.py``, planes from
``reference/planes.py``, lines from ``reference/lines.py``, matching and
the pose solves from ``reference/matching.py``, ``tracking_ops.py`` and
``lm.py``.

``build_body(p, device)`` returns ``body(gray, depth, carry, view)`` for B
streams that share one map view, exactly as the port's: the motion-model
seed, the temporal landmark bank, the three candidate solves, the plane
association, the Manhattan frame and its translation-only re-solve, the
line association and the final solve with point, line and plane rows.
``p`` holds the configuration's numbers (``judge.reference_params``).
The carry and the view are the program's state at the frame (the map the
frame is tracked against); the body works out everything of the frame
from the sensor frame itself.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from portbench.reference import lines as line_ops
from portbench.reference import lm, matching, se3, tracking_ops
from portbench.reference import orb as ref_orb
from portbench.reference import planes as plane_ops

CAND_CAP = 2048  # frustum candidates shared by the frame's solves


def _f32(x) -> float:
    """A threshold as the float32 value the reference compares with."""
    return float(np.float32(x))


def frame_features(gray: torch.Tensor, depth: torch.Tensor, p: dict) -> dict:
    """The frame's features as the port's extractor returns them: the ORB
    slots of ``reference/orb.py`` with each keypoint's depth, its
    undistorted position (the configuration has no distortion), the
    virtual right coordinate uR = u - bf/d and 1/sigma^2 of its level."""
    orb = p["orb"]
    feats = ref_orb.extract(gray, orb, p["max_keypoints"])
    H, W = gray.shape[-2:]
    xi = torch.clamp(torch.round(feats["xy"][..., 0]).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.round(feats["xy"][..., 1]).to(torch.int64), 0, H - 1)
    d = ref_orb.gather_pixels(depth, yi * W + xi)
    feats["depth"] = torch.where(feats["valid"], d, torch.zeros_like(d))
    feats["xy_und"] = feats["xy"]
    feats["u_right"] = torch.where(
        d > 0, feats["xy_und"][..., 0] - p["bf"] / torch.clamp(d, min=1e-6),
        torch.full_like(d, -1.0))
    feats["inv_sigma2"] = 1.0 / torch.pow(orb["scale_factor"],
                                          2.0 * feats["level"].to(torch.float32))
    return feats


# -------------------------------------------------------- planes, Manhattan
def associate_planes_device(fp_coeffs, fp_valid, T_cw, view, ang_th, dis_th, ver_th, par_th):
    """PlaneMatcher::SearchMapByCoefficients for B streams: each frame
    plane (B, P, 4) against every map plane -> (assoc, par, ver) (B, P)
    map-plane ids or -1: the associated plane (normals within ang_th, the
    nearest cloud point within dis_th, least distance wins), the most
    perpendicular and the most parallel one."""
    pi_w = lm.transform_plane_g2o(se3.inverse(T_cw), fp_coeffs)  # (B, P, 4)
    ang = pi_w[..., :3] @ view["pl_coeffs"][:, :3].T  # (B, P, M)
    pts = view["pl_pts"]  # (M, K, 3)
    d_all = torch.abs(
        torch.einsum("mki,bpi->bpmk", pts, pi_w[..., :3]) + pi_w[..., 3, None, None]
    )
    pt_ok = torch.arange(pts.shape[1], device=pts.device) < view["pl_npts"][:, None]
    d_min = torch.where(pt_ok, d_all, torch.full_like(d_all, 1e9)).amin(-1)  # (B, P, M)
    base = fp_valid[..., None] & view["pl_valid"]
    big = torch.full_like(ang, 1e9)

    def pick(ok, cost):
        cost = torch.where(ok, cost, big)
        best = torch.argmin(cost, -1).to(torch.int32)
        return torch.where(cost.amin(-1) < 1e9, best, -1)

    assoc = pick(base & (ang > ang_th) & (d_min < dis_th), d_min)
    ver = pick(base & (ang.abs() < ver_th), ang.abs())
    par = pick(base & (ang.abs() > par_th), -ang.abs())
    return assoc, par, ver


@functools.lru_cache(maxsize=None)
def _pair_triple_index(P: int, device: torch.device) -> tuple:
    """The P planes' pairs (i < j) and every (i, j, k) with its i < j < k
    mask, as the reference enumerates them."""
    pi, pj = torch.triu_indices(P, P, 1, device=device)
    idx = torch.arange(P, device=device)
    ti, tj, tk = (a.reshape(-1) for a in torch.meshgrid(idx, idx, idx, indexing="ij"))
    return pi, pj, ti, tj, tk, (ti < tj) & (tj < tk)


def detect_manhattan_device(fp_coeffs, fp_support, fp_valid, assoc, view, mf_ver_th):
    """Tracking::DetectManhattan (Tracking.cc:651-844) for B streams: the
    best mutually perpendicular pair or triple of associated frame planes
    that a keyframe registered, scored by support; its camera-frame
    normals (MFc) against the keyframe's own observations (MFm) give the
    rotation.  Returns (R_cw (B, 3, 3), found (B,))."""
    P = fp_coeffs.shape[-2]
    n = fp_coeffs[..., :3]
    ok_pl = fp_valid & (assoc >= 0)
    a_s = torch.clamp(assoc, min=0).long()
    pi, pj, ti, tj, tk, tmask = _pair_triple_index(P, fp_coeffs.device)
    kf_pl, kf_np, kf_co = view["kf_pl_idx"], view["kf_plane_npts"], view["kf_plane_coeffs"]

    def kf_slot(kf, mp_id):
        """Slot of map plane mp_id among keyframe kf's planes (-1 none)."""
        eq = kf_pl[kf] == mp_id[..., None]
        return torch.where(eq.any(-1), torch.argmax(eq.to(torch.int32), -1), -1)

    def perp(a, b):
        return torch.abs(torch.sum(n[:, a] * n[:, b], -1)) < mf_ver_th

    def npts(kf, slot):
        return kf_np[torch.clamp(kf, min=0), torch.clamp(slot, min=0)]

    # pairs
    kf2 = view["reg2"][a_s[:, pi], a_s[:, pj]].long()
    k2 = torch.clamp(kf2, min=0)
    s_i, s_j = kf_slot(k2, a_s[:, pi]), kf_slot(k2, a_s[:, pj])
    pair_ok = ok_pl[:, pi] & ok_pl[:, pj] & perp(pi, pj)
    pair_ok = pair_ok & (kf2 >= 0) & (s_i >= 0) & (s_j >= 0)
    pair_score = torch.where(
        pair_ok, npts(kf2, s_i) + npts(kf2, s_j) + fp_support[:, pi] + fp_support[:, pj], -1)
    # triples
    kf3 = view["reg3"][a_s[:, ti], a_s[:, tj], a_s[:, tk]].long()
    k3 = torch.clamp(kf3, min=0)
    t_i, t_j, t_k = kf_slot(k3, a_s[:, ti]), kf_slot(k3, a_s[:, tj]), kf_slot(k3, a_s[:, tk])
    tr_ok = tmask & perp(ti, tj) & perp(ti, tk) & perp(tj, tk)
    tr_ok = tr_ok & ok_pl[:, ti] & ok_pl[:, tj] & ok_pl[:, tk]
    tr_ok = tr_ok & (kf3 >= 0) & (t_i >= 0) & (t_j >= 0) & (t_k >= 0)
    np3 = npts(kf3, t_i) + npts(kf3, t_j) + npts(kf3, t_k)
    tr_score = torch.where(
        tr_ok, np3 + fp_support[:, ti] + fp_support[:, tj] + fp_support[:, tk], -1)

    best_pair = torch.argmax(pair_score, -1, keepdim=True)
    best_tr = torch.argmax(tr_score, -1, keepdim=True)
    top_pair = pair_score.gather(-1, best_pair)[:, 0]
    top_tr = tr_score.gather(-1, best_tr)[:, 0]
    use_triple = top_tr >= torch.clamp(top_pair, min=0)
    found = (top_tr > 0) | (top_pair > 0)

    def at(x, best):  # x (B, Q) -> (B,) at each stream's best entry
        return x.gather(-1, best)[:, 0]

    def normal(idx, best):  # the frame normal of plane idx[best]
        return n.gather(1, idx[best][..., None].expand(-1, 1, 3))[:, 0]

    def coeff(kf, slot):
        return kf_co[torch.clamp(kf, min=0), torch.clamp(slot, min=0), :3]

    u3 = use_triple[:, None]
    c1 = torch.where(u3, normal(ti, best_tr), normal(pi, best_pair))
    c2 = torch.where(u3, normal(tj, best_tr), normal(pj, best_pair))
    kf_t, kf_p = at(kf3, best_tr), at(kf2, best_pair)
    m1 = torch.where(u3, coeff(kf_t, at(t_i, best_tr)), coeff(kf_p, at(s_i, best_pair)))
    m2 = torch.where(u3, coeff(kf_t, at(t_j, best_tr)), coeff(kf_p, at(s_j, best_pair)))
    c3 = torch.where(u3, normal(tk, best_tr), torch.linalg.cross(c1, c2))
    m3 = torch.where(u3, coeff(kf_t, at(t_k, best_tr)), torch.linalg.cross(m1, m2))

    def ortho(a, b, c, fix_det):
        M = torch.stack([a, b, c], -1)  # the normals as columns
        det = (
            M[:, 0, 0] * (M[:, 1, 1] * M[:, 2, 2] - M[:, 1, 2] * M[:, 2, 1])
            - M[:, 0, 1] * (M[:, 1, 0] * M[:, 2, 2] - M[:, 1, 2] * M[:, 2, 0])
            + M[:, 0, 2] * (M[:, 1, 0] * M[:, 2, 1] - M[:, 1, 1] * M[:, 2, 0])
        )
        flip = fix_det & (torch.abs(det + 1.0) < 0.5)
        M = torch.cat([M[..., :2], M[..., 2:] * torch.where(flip, -1.0, 1.0)[:, None, None]], -1)
        return se3.polar_rotation(M)

    MFc = ortho(c1, c2, c3, ~use_triple)
    MFm = ortho(m1, m2, m3, ~use_triple)
    kf_best = torch.clamp(torch.where(use_triple, kf_t, kf_p), min=0)
    R_wc = view["kf_pose"][kf_best][:, :3, :3].transpose(-1, -2) @ MFm @ MFc.transpose(-1, -2)
    return R_wc.transpose(-1, -2), found


def build_plane_obs_device(fp_coeffs, assoc, par, ver, view) -> tracking_ops.PlaneObs:
    """The frame planes against their associated, parallel and
    perpendicular map planes."""
    def w(ids):
        return view["pl_coeffs"][torch.clamp(ids, min=0).long()]

    return tracking_ops.PlaneObs(
        w(assoc), fp_coeffs, assoc >= 0, w(par), fp_coeffs, par >= 0, w(ver), fp_coeffs, ver >= 0)


# ------------------------------------------------------------------ lines
def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis ignoring NaNs, as ``jnp.nanmedian``
    computes it: the mean of the two middle values for an even count (not
    torch.nanmedian's lower one), NaN for none; no host sync."""
    srt = torch.sort(x, dim=-1).values  # NaNs last
    n = (~torch.isnan(x)).sum(-1).to(x.dtype)
    q = 0.5 * (n - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    w_lo = 1.0 - w_hi

    def at(i):
        i = torch.maximum(torch.minimum(i, n - 1.0), torch.zeros_like(i))
        return srt.gather(-1, i.long()[..., None])[..., 0]

    return at(lo) * w_lo + at(hi) * w_hi


def associate_lines_device(det, desc, T_cw, view, K, image_hw, mid_px: float = 40.0,
                           ang_deg: float = 12.0):
    """LSDmatcher semantics for B streams: each frame line (B, L) against
    every map line by descriptor cosine, within the midpoint (mid_px) and
    angle (ang_deg) windows of its projection at T_cw (B, 4, 4), with the
    nearest-neighbour ratio 1/1.5 (LSDmatcher.cpp:214-223) and the
    MAD-adaptive absolute threshold over the frame's best similarities
    (lineDescriptorMAD, :384-409).  Returns (assoc (B, L) map-line ids or
    -1, visible (B, ML): map lines whose projected midpoint is in the
    image)."""
    h, w = image_hw
    R, t = T_cw[:, :3, :3], T_cw[:, None, :3, 3]

    def proj(p):  # (ML, 3) -> (B, ML, 2) pixels and (B, ML) depths
        pc = p @ R.transpose(-1, -2) + t
        z = torch.clamp(pc[..., 2], min=1e-6)
        uv = torch.stack([pc[..., 0] / z * K[0, 0] + K[0, 2], pc[..., 1] / z * K[1, 1] + K[1, 2]], -1)
        return uv, pc[..., 2]

    sp2, z1 = proj(view["ml_sp"])
    ep2, z2 = proj(view["ml_ep"])
    front = (z1 > 0.05) & (z2 > 0.05) & view["ml_valid"]
    mid_map = 0.5 * (sp2 + ep2)
    visible = (front & (mid_map[..., 0] >= 0) & (mid_map[..., 0] < w)
               & (mid_map[..., 1] >= 0) & (mid_map[..., 1] < h))
    ang_map = torch.atan2(ep2[..., 1] - sp2[..., 1], ep2[..., 0] - sp2[..., 0])
    mid_f = 0.5 * (det["sp"] + det["ep"])
    sim = desc @ view["ml_desc"].T  # (B, L, ML)
    d_mid = torch.linalg.vector_norm(mid_f[:, :, None] - mid_map[:, None], dim=-1)
    d_ang = torch.abs(torch.remainder(
        (det["angle"][:, :, None] - ang_map[:, None]) + math.pi / 2, math.pi) - math.pi / 2)
    # jnp.radians: the degrees times pi/180, both float32
    ang_th = float(np.float32(ang_deg) * np.float32(np.pi / 180))
    allow = (det["valid"][:, :, None] & front[:, None] & (d_mid < mid_px) & (d_ang < ang_th))
    sim = torch.where(allow, sim, torch.full_like(sim, -math.inf))
    top2 = torch.topk(sim, 2, dim=-1).values
    s1, s2 = top2[..., 0], top2[..., 1]
    best = torch.argmax(sim, -1).to(torch.int32)  # the first of equal bests
    has = torch.isfinite(s1)
    # NN ratio in distance space (1 - sim): d1 / d2 < 1 / 1.5
    ratio_ok = ~torch.isfinite(s2) | ((1.0 - s1) < (1.0 - s2) / 1.5)
    s1_val = torch.where(has, s1, torch.full_like(s1, math.nan))
    med = nanmedian(s1_val)
    mad = nanmedian(torch.abs(s1_val - med[:, None]))
    thr = torch.where(has.sum(-1) >= 4, torch.clamp(med - 1.4826 * 1.5 * mad, max=0.7), 0.7)
    ok = has & ratio_ok & (s1 > thr[:, None])
    return torch.where(ok, best, -1), visible


def build_line_obs_device(det, assoc, view) -> tracking_ops.LineObs:
    """Two endpoint rows per frame line (B, 2L): the associated map line's
    world endpoints against the frame line's equation."""
    B, L = assoc.shape
    a = torch.clamp(assoc, min=0).long()
    xw = torch.stack([view["ml_sp"][a], view["ml_ep"][a]], -2).reshape(B, 2 * L, 3)
    mask = (assoc >= 0).repeat_interleave(2, dim=-1)
    return tracking_ops.LineObs(
        xw, det["eq"].repeat_interleave(2, dim=-2), mask.to(torch.float32), mask)



def build_body(p: dict, device):
    """Returns body(gray (B,H,W) f32, depth (B,H,W) f32 m, carry, view) ->
    result: the port's batched body with planes and lines on, every
    carry and result tensor with a leading stream axis B, the view
    shared.  The result holds the pose ``T``, ``tracked_ok``,
    ``manhattan_found``, ``use_manhattan``, the features (``feats``), the
    planes and the lines, and the next frame's ``carry``."""
    device = torch.device(device)
    params = lm.SolveParams(**p["lm"])
    K = torch.tensor(p["K"], dtype=torch.float32, device=device)
    bf = float(p["bf"])
    hw = tuple(p["hw"])
    sf = p["orb"]["scale_factor"]
    nl = p["orb"]["n_levels"]
    sf_t = torch.tensor(sf, dtype=torch.float32, device=device)
    pl, ln = p["planes"], p["lines"]

    def body(gray, depth, carry, view):
        B = gray.shape[0]

        def shared(x):  # the one view, broadcast to the B streams (no copy)
            return x.expand((B,) + x.shape)

        feats = frame_features(gray, depth, p)
        T_last = carry["T_last"]
        have_vel = carry["have_velocity"]
        T_seed = torch.where(have_vel[:, None, None], carry["velocity"] @ T_last, T_last)

        # temporal landmarks: the previous frame's keypoints with depth,
        # back-projected with the previous pose
        T_last_wc = se3.inverse(T_last)
        pd = carry["prev_depth"]
        pxy = carry["prev_xy_und"]
        vo_cam = torch.stack(
            [(pxy[..., 0] - K[0, 2]) / K[0, 0] * pd, (pxy[..., 1] - K[1, 2]) / K[1, 1] * pd, pd],
            -1,
        )
        vo_pos = vo_cam @ T_last_wc[:, :3, :3].transpose(-1, -2) + T_last_wc[:, None, :3, 3]
        vo_on = carry["map_inl_last"] < 30
        vo_valid = (
            carry["prev_valid"] & (pd > 0) & (have_vel & carry["vo_points"] & vo_on)[:, None]
        )
        vo_dir = vo_pos - T_last_wc[:, None, :3, 3]
        vo_dist = torch.linalg.norm(vo_dir, dim=-1).clamp(min=1e-6)

        n_map = view["mp_pos"].shape[0]
        mp_view = {
            "pos": torch.cat([shared(view["mp_pos"]), vo_pos], 1),
            "desc": torch.cat([shared(view["mp_desc"]), carry["prev_desc"]], 1),
            "valid": torch.cat([shared(view["mp_valid"]), vo_valid], 1),
            "normal": torch.cat([shared(view["mp_normal"]), vo_dir / vo_dist[..., None]], 1),
            "min_dist": torch.cat([shared(view["mp_min"]), torch.zeros_like(vo_dist)], 1),
            "max_dist": torch.cat(
                [
                    shared(view["mp_max"]),
                    vo_dist * torch.pow(sf_t, carry["prev_level"].to(torch.float32)) * 2.0,
                ],
                1,
            ),
            "angle": torch.cat([torch.zeros((B, n_map), device=device), carry["prev_angle"]], 1),
            "rot_gate": torch.cat(
                [torch.zeros((B, n_map), dtype=torch.bool, device=device), vo_valid], 1
            ),
        }
        cand = matching.frustum_candidates(
            mp_view, T_seed, K, hw, CAND_CAP, scale_factor=sf, n_levels=nl,
            use_scale_gate=True,
        )

        # the candidate solves: motion-model projection (r=7), reference-KF
        # descriptors, and the widened projection retry (r=14)
        prob_a, aux_a = tracking_ops.projection_problem(
            mp_view, T_seed, feats, K, 7.0, hw, cand, scale_factor=sf, bank_stats=False
        )
        ref_safe = torch.clamp(view["ref_mp"], min=0).long()
        ref_view = {
            "pos": shared(view["mp_pos"][ref_safe]),
            "desc": shared(view["ref_desc"]),
            "valid": shared((view["ref_mp"] >= 0) & view["mp_valid"][ref_safe]),
        }
        prob_c, _, _ = tracking_ops.descriptor_problem(ref_view, feats, shared(view["ref_angle"]))
        prob_r, _ = tracking_ops.projection_problem(
            mp_view, T_seed, feats, K, 14.0, hw, cand, scale_factor=sf, bank_stats=False
        )
        outs = lm.solve_pose(
            lm.stack_problems([prob_a, prob_c, prob_r]),
            torch.cat([T_seed, T_last, T_seed]), K, bf, params,
            n_rounds=2, n_iters=4, gauss_newton=True,
        )
        T_a, T_c, T_r = outs["T"].reshape(3, B, 4, 4)
        n_a, n_c, n_r = outs["n_inliers"].reshape(3, B)
        take_a = aux_a["n_matches"] >= 20
        T_ab = torch.where(take_a[:, None, None], T_a, T_r)
        n_ab = torch.where(take_a, n_a, n_r)
        ok_ab = (n_ab >= 10) & have_vel
        ok_c = n_c >= 10
        T_init = torch.where(ok_ab[:, None, None], T_ab, T_c)
        init_ok = ok_ab | ok_c

        # planes, associated at the motion-model seed pose
        planes = plane_ops.extract_planes_device(
            depth, K, pl["max_planes"], pl["max_points"], tuple(pl["grid"]), pl["min_support"],
            pl["dist_th"],
        )
        assoc, par, ver = associate_planes_device(
            planes["coeffs"], planes["valid"], T_seed, view,
            _f32(pl["ang_ref"]), _f32(pl["dis_ref"]), _f32(pl["ver_th"]), _f32(pl["par_th"]),
        )
        man_R, man_found = detect_manhattan_device(
            planes["coeffs"], planes["n_support"], planes["valid"], assoc, view,
            _f32(pl["mf_ver_th"]),
        )
        plane_obs = build_plane_obs_device(planes["coeffs"], assoc, par, ver, view)

        # the Manhattan translation-only re-solve from the Manhattan
        # rotation, by projection (r=7) and by descriptors as its fallback
        T_manh = T_init.clone()
        T_manh[:, :3, :3] = man_R
        prob_t, _ = tracking_ops.projection_problem(
            mp_view, T_manh, feats, K, 7.0, hw, cand, scale_factor=sf, bank_stats=False,
            plane_obs=plane_obs,
        )
        prob_t2 = prob_c._replace(**plane_obs._asdict())
        out_t = lm.solve_pose(
            lm.stack_problems([prob_t, prob_t2]), torch.cat([T_manh, T_manh]), K, bf,
            params, translation_only=True, n_rounds=2, n_iters=4, gauss_newton=True,
            use_planes=True,
        )
        T_t, T_t2 = out_t["T"].reshape(2, B, 4, 4)
        n_t, n_t2 = out_t["inlier_pt"].sum(-1).reshape(2, B)
        ok_t = n_t >= 7
        fallback = man_found & ~ok_t
        use_manh = man_found & (ok_t | (fallback & (n_t2 >= 7)))
        T_man = torch.where(ok_t[:, None, None], T_t, T_t2)
        T_mid = torch.where(use_manh[:, None, None], T_man, T_init)

        # lines, associated at the initial pose, enter the final solve only
        det = line_ops.detect_lines(
            gray, ln["max_lines"], ln["mag_th"], ln["min_support"], ln["min_density"],
            ln["min_length"],
        )
        ldesc = line_ops.line_descriptors(gray, det["sp"], det["ep"])
        lifted = line_ops.lift_lines_3d(depth, K, det["sp"], det["ep"], det["valid"])
        l_assoc, _ = associate_lines_device(
            det, ldesc, T_init, view, K, hw, mid_px=ln["assoc_mid_px"],
            ang_deg=ln["assoc_ang_deg"],
        )
        line_obs = build_line_obs_device(det, l_assoc, view)

        # the final solve with the line and plane rows: 4 chi2-gated rounds
        # of 5 LM iterations, then one polar projection of the rotation
        out_f = tracking_ops.track_projection(
            mp_view, T_mid, feats, K, bf, 4.0, hw, cand, scale_factor=sf,
            n_rounds=4, n_iters=5, bank_stats=True, plane_obs=plane_obs, params=params,
            use_planes=True, line_obs=line_obs, use_lines=True,
        )
        T_final = out_f["T"].clone()
        T_final[:, :3, :3] = se3.polar_rotation(T_final[:, :3, :3], iters=2)
        n_pt_f = out_f["n_pt_inliers"].to(torch.int32)
        n_ln_f = out_f["inlier_ln"].unflatten(-1, (-1, 2)).any(-1).sum(-1).to(torch.int32)
        n_pl_f = out_f["inlier_pl"].sum(-1).to(torch.int32)
        n_inl = n_pt_f + n_ln_f + n_pl_f
        reachable = init_ok | use_manh
        tracked_ok = reachable & (n_pt_f >= 7) & (n_inl >= 7)
        ok3 = tracked_ok[:, None, None]

        kp_mp_ext = out_f["kp_mp"]
        kp_mp = torch.where(kp_mp_ext >= n_map, -1, kp_mp_ext)
        n_map_inliers = n_ln_f + n_pl_f + (kp_mp >= 0).sum(-1).to(torch.int32)
        new_carry = {
            "T_last": torch.where(ok3, T_final, T_last),
            "velocity": torch.where(ok3, T_final @ se3.inverse(T_last), carry["velocity"]),
            "have_velocity": tracked_ok,
            "vo_points": carry["vo_points"],
            "map_inl_last": torch.where(tracked_ok, n_map_inliers, 0),
            "prev_xy_und": feats["xy_und"],
            "prev_depth": feats["depth"],
            "prev_desc": feats["desc"],
            "prev_level": feats["level"],
            "prev_angle": feats["angle"],
            "prev_valid": feats["valid"] & tracked_ok[:, None],
        }
        return {
            "T": T_final,
            "tracked_ok": tracked_ok,
            "manhattan_found": man_found,
            "use_manhattan": use_manh,
            "feats": feats,
            "plane_coeffs": planes["coeffs"],
            "plane_valid": planes["valid"],
            "line_valid": det["valid"],
            "line_sp3": lifted["sp3"],
            "line_ep3": lifted["ep3"],
            "line_has3d": lifted["ok"],
            "carry": new_carry,
        }

    return body
