"""Epipolar matching, two-view triangulation and landmark fusion
candidates (counterpart of manhattanslam_tpu/mapping/triangulation.py).

LocalMapping::CreateNewMapPoints (LocalMapping.cc:303-522): the free
keypoints of one keyframe are matched against a neighbour's along
epipolar lines (ORBmatcher::SearchForTriangulation with
CheckDistEpipolarLine's 3.84 sigma gate), triangulated as the midpoint
of the two rays, and kept under the reference's gates: parallax,
positive depth and a chi2 5.991 reprojection error in both views, and
the scale-consistency ratio.  ORBmatcher::Fuse (ORBmatcher.cc:408-546):
landmarks projected into a keyframe find the keypoint they land on.

Both are written once for a stack of S keyframes with a leading axis
(the reference vmaps them over a padded stack of neighbours and of
fusion targets); ``triangulate_pair`` and ``fuse_candidates`` are the
stack at S = 1.
"""

from __future__ import annotations

import torch

from manhattanslam_tpu_torch.ops import matching


def _homogeneous(xy: torch.Tensor) -> torch.Tensor:
    return torch.cat([xy, torch.ones_like(xy[..., :1])], -1)


def fundamental_matrix(T1_cw: torch.Tensor, T2_cw: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """F12 (..., 3, 3) with x1^T F12 x2 = 0, for T2_cw (..., 4, 4)
    (ComputeF12, LocalMapping.cc:624-640)."""
    T12 = T1_cw @ torch.linalg.inv(T2_cw)
    R12, t = T12[..., :3, :3], T12[..., :3, 3]
    zero = torch.zeros_like(t[..., 0])
    tx = torch.stack([
        torch.stack([zero, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], zero, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], zero], -1),
    ], -2)
    Kinv = torch.linalg.inv(K)
    return Kinv.T @ tx @ R12 @ Kinv


def _camera_pixels(pos_w: torch.Tensor, T_cw: torch.Tensor, K: torch.Tensor):
    """(S, N, 3) world points in the cameras T_cw ((4, 4) or (S, 4, 4))
    -> (u, v, z), each (S, N)."""
    pc = pos_w @ T_cw[..., :3, :3].transpose(-1, -2) + T_cw[..., None, :3, 3]
    z = pc[..., 2]
    zi = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return pc[..., 0] / zi * K[0, 0] + K[0, 2], pc[..., 1] / zi * K[1, 1] + K[1, 2], z


def triangulate_pairs(
    kp1: dict,
    kp2s: dict,
    T1_cw: torch.Tensor,
    T2s_cw: torch.Tensor,
    K: torch.Tensor,
    scale_factor: float,
) -> dict:
    """Match the free keypoints of keyframe 1 against each of S keyframes
    and triangulate.

    kp1: xy (N, 2) undistorted, desc (N, 8) int32 words, valid (N,)
    (free and valid), level (N,), inv_sigma2 (N,); kp2s: the same keys
    with a leading stack axis (S, N2, ...), stack rows with valid all
    False match nothing.  T2s_cw (S, 4, 4).  Returns, per stack row and
    keyframe-1 keypoint, idx2 (S, N) int32, pos_w (S, N, 3), ok (S, N)
    and dist (S, N)."""
    S = T2s_cw.shape[0]
    F12 = fundamental_matrix(T1_cw, T2s_cw, K)
    # epipolar distance of each kp2 to the line of each kp1, l2 = x1^T F12
    x1h = _homogeneous(kp1["xy"])  # (N, 3)
    l2 = x1h @ F12  # (S, N, 3)
    x2h = _homogeneous(kp2s["xy"])  # (S, N2, 3)
    num = (l2 @ x2h.transpose(-1, -2)).abs()
    den = torch.sqrt(l2[..., 0] ** 2 + l2[..., 1] ** 2).clamp(min=1e-9)[..., None]
    sigma2 = 1.0 / kp2s["inv_sigma2"]
    epi_ok = num / den < 3.84 * torch.sqrt(sigma2)[..., None, :]
    n1 = kp1["desc"].shape[0]
    idx2, dist, ok = matching.match_descriptors(
        kp1["desc"].expand(S, n1, 8), kp2s["desc"], kp1["valid"].expand(S, n1), kp2s["valid"],
        max_dist=matching.TH_LOW, extra_mask=epi_ok,
    )
    # the midpoint of the closest approach of the two rays
    Kinv = torch.linalg.inv(K)
    T1_wc = torch.linalg.inv(T1_cw)
    T2_wc = torch.linalg.inv(T2s_cw)
    r1 = (x1h @ Kinv.T) @ T1_wc[:3, :3].T  # (N, 3) world ray directions
    r2 = matching.take_rows((x2h @ Kinv.T) @ T2_wc[:, :3, :3].transpose(-1, -2), idx2.long())
    o1 = T1_wc[:3, 3]
    o2 = T2_wc[:, None, :3, 3]  # (S, 1, 3)
    w0 = o1 - o2
    a = torch.sum(r1 * r1, -1)
    b = torch.sum(r1 * r2, -1)
    c = torch.sum(r2 * r2, -1)
    d = torch.sum(r1 * w0, -1)
    e = torch.sum(r2 * w0, -1)
    denom = a * c - b * b
    denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
    s = (b * e - c * d) / denom
    t = (a * e - b * d) / denom
    pos_w = 0.5 * ((o1 + s[..., None] * r1) + (o2 + t[..., None] * r2))
    cos_par = b / torch.sqrt(a * c).clamp(min=1e-9)

    def reproj_ok(T_cw, xy, inv_sigma2):
        u, v, z = _camera_pixels(pos_w, T_cw, K)
        err = (u - xy[..., 0]) ** 2 + (v - xy[..., 1]) ** 2
        return (z > 0) & (err * inv_sigma2 < 5.991)

    idx = idx2.long()
    ok = (
        ok
        & (cos_par < 0.9998)
        & reproj_ok(T1_cw, kp1["xy"], kp1["inv_sigma2"])
        & reproj_ok(T2s_cw, matching.take_rows(kp2s["xy"], idx),
                    kp2s["inv_sigma2"].gather(-1, idx))
    )
    # scale consistency (LocalMapping.cc:476-501)
    ratio_dist = torch.linalg.norm(pos_w - o1, dim=-1) / torch.linalg.norm(
        pos_w - o2, dim=-1).clamp(min=1e-9)
    ratio_octave = torch.pow(
        torch.tensor(scale_factor, dtype=torch.float32, device=pos_w.device),
        (kp1["level"] - kp2s["level"].gather(-1, idx)).to(torch.float32),
    )
    ok = ok & (ratio_dist > ratio_octave / 1.5) & (ratio_dist < ratio_octave * 1.5)
    return {"idx2": idx2, "pos_w": pos_w, "ok": ok, "dist": dist}


def triangulate_pair(kp1: dict, kp2: dict, T1_cw, T2_cw, K, scale_factor: float) -> dict:
    """triangulate_pairs for one neighbour: (N,) outputs."""
    out = triangulate_pairs(kp1, {k: v[None] for k, v in kp2.items()}, T1_cw, T2_cw[None], K,
                            scale_factor)
    return {k: v[0] for k, v in out.items()}


def fuse_candidates_batch(
    mp_pos: torch.Tensor,
    mp_desc: torch.Tensor,
    mp_valid: torch.Tensor,
    T_cws: torch.Tensor,
    kf_feats_s: dict,
    K: torch.Tensor,
    image_h: float,
    image_w: float,
) -> dict:
    """A bank of P landmarks projected into each of S keyframes (T_cws
    (S, 4, 4); kf_feats_s: xy, desc, valid, level, each (S, N, ...)):
    per landmark and keyframe the keypoint within 3 px scaled by its
    octave with the nearest descriptor under TH_LOW, one landmark per
    keypoint.  Returns kp_idx (S, P) int32, ok (S, P) and dist (S, P)."""
    S = T_cws.shape[0]
    uv, z = matching.project_points(T_cws, mp_pos, K)  # (S, P, 2), (S, P)
    in_img = (
        (z > 0.05)
        & (uv[..., 0] >= 0) & (uv[..., 0] < image_w)
        & (uv[..., 1] >= 0) & (uv[..., 1] < image_h)
    )
    xy = kf_feats_s["xy"]
    rad = (3.0 * torch.pow(1.2, kf_feats_s["level"].to(torch.float32)))[:, None, :]
    near = ((xy[:, None, :, 0] - uv[..., :, None, 0]).abs() <= rad) & (
        (xy[:, None, :, 1] - uv[..., :, None, 1]).abs() <= rad)
    P = mp_desc.shape[0]
    idx, dist, ok = matching.match_descriptors(
        mp_desc.expand(S, P, 8), kf_feats_s["desc"], mp_valid & in_img, kf_feats_s["valid"],
        max_dist=matching.TH_LOW, extra_mask=near,
    )
    ok = matching.resolve_one_to_one(idx, dist, ok, kf_feats_s["desc"].shape[-2])
    return {"kp_idx": idx, "ok": ok, "dist": dist}


def fuse_candidates(mp_pos, mp_desc, mp_valid, T_cw, kf_feats: dict, K, image_h, image_w) -> dict:
    """fuse_candidates_batch for one keyframe: (P,) outputs."""
    out = fuse_candidates_batch(mp_pos, mp_desc, mp_valid, T_cw[None],
                                {k: v[None] for k, v in kf_feats.items()}, K, image_h, image_w)
    return {k: v[0] for k, v in out.items()}
