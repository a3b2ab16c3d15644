"""Pose from correspondences by RANSAC (counterpart of
manhattanslam_tpu/ops/ransac_pose.py), replacing the reference's
EPnP + RANSAC relocalizer (PnPsolver.cc).

An RGB-D frame has depth at most keypoints, so each hypothesis is a
closed-form Kabsch fit of 3 world / camera point pairs, all hypotheses
in one batch; the depthless fallback fits EPnP (the single-beta case) to
6 world point / pixel pairs.  Inliers are counted by reprojection error
against 4 x 5.991 px^2 (the reference package's gate), the best
hypothesis is refitted on its inliers, and the refit is kept when it has
at least as many.

Each RANSAC is a sampler and a core: ``sample_hypotheses`` draws the
hypotheses' correspondence indices from an explicit torch.Generator
(weighted by `valid`, without replacement), and ``*_from_samples`` fits,
scores and refits given those indices.  The reference draws its indices
from a JAX key, a stream torch cannot reproduce; the cores are held
against the reference given the reference's own indices.  The batched
3x3 SVD and 12x12 eigh run as one library call each (cuSOLVER on the
card).
"""

from __future__ import annotations

import torch

CHI2_TH = 5.991


def kabsch(A: torch.Tensor, B: torch.Tensor, w: torch.Tensor | None = None):
    """Rigid (R, t) with B ~= A @ R.T + t for A, B (..., n, 3) and
    optional weights w (..., n): R (..., 3, 3), t (..., 3)."""
    if w is None:
        w = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    ws = w.sum(-1).clamp(min=1e-9)[..., None]
    ca = (A * w[..., None]).sum(-2) / ws
    cb = (B * w[..., None]).sum(-2) / ws
    H = (A - ca[..., None, :]).transpose(-1, -2) @ ((B - cb[..., None, :]) * w[..., None])
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = V @ D @ Ut
    return R, cb - (R @ ca[..., None])[..., 0]


def sample_hypotheses(valid: torch.Tensor, n_hyp: int, n_sample: int,
                      generator: torch.Generator) -> torch.Tensor:
    """(n_hyp, n_sample) int64 correspondence indices, each row drawn
    without replacement uniformly among the valid ones (`valid` needs at
    least n_sample set)."""
    p = valid.to(torch.float32).expand(n_hyp, -1)
    return torch.multinomial(p, n_sample, replacement=False, generator=generator)


def _score(Rs, ts, pts_w, uv_obs, valid, K, chi2_th):
    """Reprojection inliers (..., N) of the poses (R, t) (..., 3, 3), (..., 3)."""
    pc = pts_w @ Rs.transpose(-1, -2) + ts[..., None, :]
    z = pc[..., 2]
    zi = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = pc[..., 0] / zi * K[0, 0] + K[0, 2]
    v = pc[..., 1] / zi * K[1, 1] + K[1, 2]
    err2 = (u - uv_obs[..., 0]) ** 2 + (v - uv_obs[..., 1]) ** 2
    return (err2 < chi2_th * 4.0) & (z > 0.05) & valid


def _select_and_refit(Rs, ts, pts_w, uv_obs, valid, K, chi2_th, refit) -> dict:
    """The hypothesis with the most inliers, refitted on them by
    refit(weights); the refit wins ties.  All outputs stay on the device."""
    inl = _score(Rs, ts, pts_w, uv_obs, valid, K, chi2_th)
    best = torch.argmax(inl.sum(-1))
    R_b, t_b, mask_b = Rs[best], ts[best], inl[best]
    R_f, t_f = refit(mask_b.to(pts_w.dtype))
    mask_f = _score(R_f, t_f, pts_w, uv_obs, valid, K, chi2_th)
    better = mask_f.sum() >= mask_b.sum()
    mask = torch.where(better, mask_f, mask_b)
    n = mask.sum()
    return {"R": torch.where(better, R_f, R_b), "t": torch.where(better, t_f, t_b),
            "inlier_mask": mask, "n_inliers": n, "ok": n >= 10}


def pose_ransac_3d3d_from_samples(pts_w, pts_c, uv_obs, valid, K, sel,
                                  chi2_th: float = CHI2_TH) -> dict:
    """T_cw from world points pts_w (N, 3) and back-projected keypoints
    pts_c (N, 3) with observed pixels uv_obs (N, 2), given hypotheses'
    indices sel (H, 3).  Returns R, t, inlier_mask, n_inliers, ok."""
    Rs, ts = kabsch(pts_w[sel], pts_c[sel])
    return _select_and_refit(Rs, ts, pts_w, uv_obs, valid, K, chi2_th,
                             lambda w: kabsch(pts_w, pts_c, w))


def pose_ransac_3d3d(pts_w, pts_c, uv_obs, valid, K, generator: torch.Generator,
                     n_hyp: int = 256, chi2_th: float = CHI2_TH) -> dict:
    """RANSAC T_cw from 3D(world)-3D(camera) pairs: n_hyp 3-point Kabsch
    hypotheses among the valid pairs."""
    sel = sample_hypotheses(valid, n_hyp, 3, generator)
    return pose_ransac_3d3d_from_samples(pts_w, pts_c, uv_obs, valid, K, sel, chi2_th)


def epnp(Pw: torch.Tensor, uv: torch.Tensor, K: torch.Tensor, w: torch.Tensor | None = None):
    """EPnP (Lepetit et al., the single-beta case) for world points Pw
    (..., n, 3) and pixels uv (..., n, 2) with optional weights w (..., n):
    control points at the centroid and the principal axes, the camera
    control points from the null vector of M^T M (a 12x12 eigh), the
    scale from the control-point distances, the sign that puts the points
    in front of the camera, then Kabsch.  Returns (R, t), X_c = R X_w + t."""
    if w is None:
        w = torch.ones(Pw.shape[:-1], dtype=Pw.dtype, device=Pw.device)
    ws = w.sum(-1).clamp(min=1e-9)[..., None]
    c0 = (Pw * w[..., None]).sum(-2) / ws
    cen = Pw - c0[..., None, :]
    cov = (cen * w[..., None]).transpose(-1, -2) @ cen / ws[..., None]
    ew, V = torch.linalg.eigh(cov)  # ascending
    scales = torch.sqrt(ew.clamp(min=1e-8))
    axes = V * scales[..., None, :]  # column k: scales[k] * V[:, k]
    Cw = torch.stack([c0, c0 + axes[..., 2], c0 + axes[..., 1], c0 + axes[..., 0]], -2)
    B = (Cw[..., 1:, :] - Cw[..., :1, :]).transpose(-1, -2)
    a_rest = torch.linalg.solve(B, cen.transpose(-1, -2)).transpose(-1, -2)
    alpha = torch.cat([1.0 - a_rest.sum(-1, keepdim=True), a_rest], -1)  # (..., n, 4)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = uv[..., 0], uv[..., 1]
    zero = torch.zeros_like(alpha)
    n = Pw.shape[-2]
    lead = Pw.shape[:-2]
    Mx = torch.stack([alpha * fx, zero, alpha * (cx - u)[..., None]], -1).reshape(lead + (n, 12))
    My = torch.stack([zero, alpha * fy, alpha * (cy - v)[..., None]], -1).reshape(lead + (n, 12))
    M = torch.cat([Mx * w[..., None], My * w[..., None]], -2)
    _, evec = torch.linalg.eigh(M.transpose(-1, -2) @ M)
    cc = evec[..., :, 0].reshape(lead + (4, 3))
    iu, ju = torch.triu_indices(4, 4, 1, device=Pw.device)
    dc = torch.linalg.norm(cc[..., iu, :] - cc[..., ju, :], dim=-1)
    dw = torch.linalg.norm(Cw[..., iu, :] - Cw[..., ju, :], dim=-1)
    beta = (dc * dw).sum(-1) / (dc * dc).sum(-1).clamp(min=1e-12)
    pc = alpha @ (cc * beta[..., None, None])
    # cheirality: the null vector's sign is arbitrary
    flip = (pc[..., 2] * w).sum(-1) < 0
    pc = torch.where(flip[..., None, None], -pc, pc)
    return kabsch(Pw, pc, w)


def pose_ransac_pnp_from_samples(pts_w, uv_obs, valid, K, sel,
                                 chi2_th: float = CHI2_TH) -> dict:
    """T_cw from world points pts_w (N, 3) and pixels uv_obs (N, 2) alone,
    given hypotheses' indices sel (H, n_sample)."""
    Rs, ts = epnp(pts_w[sel], uv_obs[sel], K)
    return _select_and_refit(Rs, ts, pts_w, uv_obs, valid, K, chi2_th,
                             lambda w: epnp(pts_w, uv_obs, K, w))


def pose_ransac_pnp(pts_w, uv_obs, valid, K, generator: torch.Generator, n_hyp: int = 128,
                    n_sample: int = 6, chi2_th: float = CHI2_TH) -> dict:
    """RANSAC T_cw from 2D-3D pairs (the depthless relocalization path,
    Tracking.cc:1937-1957): n_hyp 6-point EPnP hypotheses."""
    sel = sample_hypotheses(valid, n_hyp, n_sample, generator)
    return pose_ransac_pnp_from_samples(pts_w, uv_obs, valid, K, sel, chi2_th)
