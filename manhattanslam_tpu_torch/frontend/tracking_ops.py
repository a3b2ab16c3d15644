"""Match-and-solve composites of the tracking hot path (counterpart of
manhattanslam_tpu/frontend/tracking_ops.py).

Projection matching (TrackWithMotionModel / TrackLocalMap) and pure
descriptor matching against the reference keyframe (TrackReferenceKeyFrame)
each become a keypoint-indexed ``PoseProblem`` that also carries the
frame's plane associations (``PlaneObs``) and line associations
(``LineObs``); ``track_projection`` adds the
solve, with the rotation frozen for the Manhattan decoupled solve
(``translation_only``), and the match bookkeeping; ``track_descriptors``
the solve of the descriptor problem.  The fused step
(frontend/device_tracker.py) builds its problems from these and solves
them in batches; the modular tracker (frontend/tracking.py) calls
``track_projection`` and ``track_descriptors`` one frame at a time.

The functions take one frame's arrays or B streams' arrays with a leading
stream axis (the reference's vmapped replay).  A PoseProblem always has
one batch axis: B streams give a batch of B, one frame a batch of one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manhattanslam_tpu_torch.ops import lm, matching


class PlaneObs(NamedTuple):
    """Per-frame plane associations (..., P, 4): the world coeffs of the
    matched map plane and the observed camera-frame coeffs, for the
    matched, parallel and perpendicular map planes; masks (..., P)."""

    pl_w: torch.Tensor
    pl_obs: torch.Tensor
    pl_mask: torch.Tensor
    par_w: torch.Tensor
    par_obs: torch.Tensor
    par_mask: torch.Tensor
    ver_w: torch.Tensor
    ver_obs: torch.Tensor
    ver_mask: torch.Tensor


def empty_plane_obs(np_: int = 8, lead: tuple = (), device=None) -> PlaneObs:
    """No plane observations: np_ masked-out rows per family."""
    z = torch.zeros(lead + (np_, 4), device=device)
    off = torch.zeros(lead + (np_,), dtype=torch.bool, device=device)
    return PlaneObs(z, z, off, z, z, off, z, z, off)


class LineObs(NamedTuple):
    """Per-frame line associations, two endpoint rows per frame line
    (..., 2L): the matched map line's world endpoint, the frame line's
    normalized image equation, the information and the mask."""

    xw: torch.Tensor
    eq: torch.Tensor
    info: torch.Tensor
    mask: torch.Tensor


def empty_line_obs(n_lines: int = 64, lead: tuple = (), device=None) -> LineObs:
    """No line observations: 2 * n_lines masked-out endpoint rows."""
    z = torch.zeros(lead + (2 * n_lines, 3), device=device)
    return LineObs(z, z, torch.zeros(lead + (2 * n_lines,), device=device),
                   torch.zeros(lead + (2 * n_lines,), dtype=torch.bool, device=device))


def build_point_problem(
    pts_pos: torch.Tensor,
    kp_idx: torch.Tensor,
    matched: torch.Tensor,
    feats: dict,
    plane_obs: PlaneObs | None = None,
    line_obs: LineObs | None = None,
) -> lm.PoseProblem:
    """Gather matched observations into a (B, N) PoseProblem (B = 1 for
    one frame's (N,) arrays): stereo (u, v, uR) when the keypoint has depth
    (uR > 0), mono otherwise; plus the plane and line observations (no
    rows when plane_obs / line_obs is None)."""
    kp = kp_idx.long()
    uv = matching.take_rows(feats["xy_und"], kp)
    ur = feats["u_right"].gather(-1, kp)
    if plane_obs is None:
        plane_obs = empty_plane_obs(0, kp.shape[:-1], kp.device)
    if line_obs is None:
        line_obs = empty_line_obs(0, kp.shape[:-1], kp.device)
    prob = lm.PoseProblem(
        pts_pos,
        torch.cat([uv, ur[..., None]], -1),
        feats["inv_sigma2"].gather(-1, kp),
        ur > 0,
        matched,
        *plane_obs,
        *line_obs,
    )
    return prob if kp.dim() == 2 else lm.PoseProblem(*(f[None] for f in prob))


def projection_problem(
    pts: dict,
    T_seed: torch.Tensor,
    feats: dict,
    K: torch.Tensor,
    radius: float,
    image_hw: tuple[int, int],
    cand: dict,
    scale_factor: float = 1.2,
    bank_stats: bool = True,
    plane_obs: PlaneObs | None = None,
    line_obs: LineObs | None = None,
) -> tuple[lm.PoseProblem, dict]:
    """Projection matching in the shared frustum candidate set `cand`
    (matching.frustum_candidates) -> keypoint-indexed PoseProblem with the
    plane and line observations (no solve).  bank_stats=False skips the
    bank-level scatter outputs."""
    n_kp = feats["desc"].shape[-2]
    n_bank = pts["pos"].shape[-2]
    CAND = cand["pos"].shape[-2]
    h, w = image_hw
    uv, z = matching.project_points(T_seed, cand["pos"], K)
    in_img = (
        (z > 0.05) & (uv[..., 0] >= 0) & (uv[..., 0] < w) & (uv[..., 1] >= 0) & (uv[..., 1] < h)
    )
    c_valid = cand["valid"] & in_img
    rad = radius * torch.pow(scale_factor, cand["level"].to(torch.float32))[..., None]
    duv = feats["xy_und"][..., None, :, :] - uv[..., :, None, :]  # (..., CAND, n_kp, 2)
    pix_ok = (duv[..., 0].abs() <= rad) & (duv[..., 1].abs() <= rad)
    pix_ok = pix_ok & ((feats["level"][..., None, :] - cand["level"][..., :, None]).abs() <= 1)
    c_kp, c_dist, c_ok = matching.match_descriptors(
        cand["desc"], feats["desc"], c_valid, feats["valid"],
        max_dist=matching.TH_HIGH, extra_mask=pix_ok,
    )
    c_ok = matching.resolve_one_to_one(c_kp, c_dist, c_ok, n_kp)
    if "rot_gate" in cand:
        # rotation-histogram filter over the temporal last-frame block
        # (ORBmatcher::SearchByProjection(Frame, Frame)); map points carry
        # no keypoint angle and pass through untouched
        gated = cand["rot_gate"] & c_valid
        rot_ok = matching.rotation_consistency_mask(
            cand["angle"], feats["angle"].gather(-1, c_kp.long()), gated & c_ok
        )
        c_ok = torch.where(gated, rot_ok, c_ok)
    # candidate -> keypoint assignment (one-to-one after resolution)
    tgt = torch.where(c_ok, c_kp, torch.full_like(c_kp, n_kp))
    cand_of_kp = matching.segment_max(
        torch.arange(CAND, dtype=torch.int32, device=tgt.device), tgt, n_kp, -1
    )
    matched_kp = cand_of_kp >= 0
    safe_c = torch.clamp(cand_of_kp, min=0).long()
    point_of_kp = torch.where(matched_kp, cand["bank_idx"].gather(-1, safe_c), -1)
    prob = build_point_problem(
        matching.take_rows(cand["pos"], safe_c),
        torch.arange(n_kp, dtype=torch.int32, device=tgt.device).expand(matched_kp.shape),
        matched_kp, feats, plane_obs, line_obs,
    )
    aux = {
        "point_of_kp": point_of_kp,
        "matched_kp": matched_kp,
        "visible": cand["visible_bank"],
        "n_matches": matched_kp.sum(-1),
    }
    if bank_stats:
        tgt_bank = torch.where(c_ok, cand["bank_idx"], n_bank).long()
        lead = tgt_bank.shape[:-1]
        aux["kp_idx"] = torch.zeros(
            lead + (n_bank + 1,), dtype=torch.int32, device=tgt.device
        ).scatter(-1, tgt_bank, c_kp)[..., :n_bank]
        aux["match_valid"] = torch.zeros(
            lead + (n_bank + 1,), dtype=torch.bool, device=tgt.device
        ).scatter(-1, tgt_bank, torch.ones_like(c_ok))[..., :n_bank]
    return prob, aux


def projection_post(out: dict, aux: dict, n_bank: int) -> dict:
    """Attach match bookkeeping (B streams, (B, ...)) to the solve result
    of their B problems."""
    point_of_kp = aux["point_of_kp"]
    matched_kp = aux["matched_kp"]
    kp_inlier = out["inlier_pt"]
    hit = kp_inlier & matched_kp
    res = {
        "T": out["T"],
        "kp_mp": torch.where(kp_inlier, point_of_kp, -1),
        "kp_inlier": kp_inlier,
        "inlier_pl": out["inlier_pl"],
        "inlier_ln": out["inlier_ln"],
        "n_matches": aux["n_matches"],
        "n_pt_inliers": hit.sum(-1),
        "visible": aux["visible"],
    }
    if "match_valid" in aux:
        tgt = torch.where(hit, point_of_kp, n_bank).long()
        inlier_bank = torch.zeros(
            tgt.shape[:-1] + (n_bank + 1,), dtype=torch.bool, device=tgt.device
        ).scatter(-1, tgt, torch.ones_like(hit))[..., :n_bank]
        res.update(
            matched=aux["match_valid"] & inlier_bank,
            pt_inlier=inlier_bank,
            kp_idx=aux["kp_idx"],
        )
    return res


def track_projection(
    pts: dict,
    T_seed: torch.Tensor,
    feats: dict,
    K: torch.Tensor,
    bf,
    radius: float,
    image_hw: tuple[int, int],
    cand: dict | None = None,
    scale_factor: float = 1.2,
    n_rounds: int = 4,
    n_iters: int = 10,
    gauss_newton: bool = False,
    bank_stats: bool = True,
    plane_obs: PlaneObs | None = None,
    params: lm.SolveParams | None = None,
    translation_only: bool = False,
    use_planes: bool = False,
    line_obs: LineObs | None = None,
    use_lines: bool = False,
    n_levels: int = 8,
    use_scale_gate: bool = False,
) -> dict:
    """Project each stream's landmark bank (B, N, ...) from its seed pose
    T_seed (B, 4, 4), match, solve: one batch of B problems.  `cand`: the
    frame's shared frustum candidates; when None they are compacted here
    (the reference's 4096 rows; use_scale_gate adds the local map's
    viewing gates, matching.frustum_candidates)."""
    if cand is None:
        cand = matching.frustum_candidates(
            pts, T_seed, K, image_hw, 4096, scale_factor=scale_factor,
            n_levels=n_levels, use_scale_gate=use_scale_gate,
        )
    prob, aux = projection_problem(
        pts, T_seed, feats, K, radius, image_hw, cand,
        scale_factor=scale_factor, bank_stats=bank_stats, plane_obs=plane_obs,
        line_obs=line_obs,
    )
    out = lm.solve_pose(
        prob, T_seed, K, bf, params, translation_only=translation_only,
        n_rounds=n_rounds, n_iters=n_iters, gauss_newton=gauss_newton,
        use_planes=use_planes, use_lines=use_lines,
    )
    return projection_post(out, aux, pts["pos"].shape[-2])


def descriptor_problem(
    pts: dict, feats: dict, kf_angles: torch.Tensor, plane_obs: PlaneObs | None = None,
    line_obs: LineObs | None = None,
) -> tuple[lm.PoseProblem, torch.Tensor, torch.Tensor]:
    """Pure-descriptor matching -> PoseProblem (no solve): SearchByBoW
    semantics (NN ratio 0.7, TH_LOW, rotation-histogram filter) minus the
    BoW bucketing.  Returns (problem, kp_idx, matched)."""
    idx, dist, ok = matching.match_descriptors(
        pts["desc"], feats["desc"], pts["valid"], feats["valid"],
        max_dist=matching.TH_LOW, ratio=0.7,
    )
    ok = matching.rotation_consistency_mask(kf_angles, feats["angle"].gather(-1, idx.long()), ok)
    ok = matching.resolve_one_to_one(idx, dist, ok, feats["desc"].shape[-2])
    return build_point_problem(pts["pos"], idx, ok, feats, plane_obs, line_obs), idx, ok


def track_descriptors(
    pts: dict,
    T_seed: torch.Tensor,
    feats: dict,
    kf_angles: torch.Tensor,
    K: torch.Tensor,
    bf,
    params: lm.SolveParams | None = None,
    plane_obs: PlaneObs | None = None,
    line_obs: LineObs | None = None,
    translation_only: bool = False,
    n_rounds: int = 4,
    n_iters: int = 10,
    gauss_newton: bool = False,
    use_planes: bool = False,
    use_lines: bool = False,
) -> dict:
    """SearchByBoW-style descriptor matching of each stream's bank (B, N,
    ...) against its frame, and the solve from T_seed (B, 4, 4)
    (TrackReferenceKeyFrame; with translation_only the Manhattan
    decoupled TranslationEstimation, Tracking.cc:846-944).  The bank rows
    are the problem's point rows: kp_idx, matched and pt_inlier are per
    bank row."""
    prob, idx, ok = descriptor_problem(pts, feats, kf_angles, plane_obs, line_obs)
    out = lm.solve_pose(
        prob, T_seed, K, bf, params, translation_only=translation_only,
        n_rounds=n_rounds, n_iters=n_iters, gauss_newton=gauss_newton,
        use_planes=use_planes, use_lines=use_lines,
    )
    pt_inlier = out["inlier_pt"]
    return {
        "T": out["T"],
        "kp_idx": idx,
        "matched": ok,
        "pt_inlier": pt_inlier,
        "n_matches": ok.sum(-1),
        "n_pt_inliers": pt_inlier.sum(-1),
    }
