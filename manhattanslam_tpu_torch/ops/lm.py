"""Pose solver over point residuals (counterpart of
manhattanslam_tpu/ops/lm.py, point family only).

The reference solves one 6-dof SE(3) pose with unary edges, so the g2o
machinery reduces to accumulating a 6x6 normal system.  Point rows fuse
the mono and stereo edges: the residual is obs (u, v, uR) minus the
projection (u, v, u - bf/z), with the uR component weighted out for rows
without depth.  The schedule is the reference's: rounds of iterations,
chi2 re-gating of the edges between rounds (5.991 mono / 7.815 stereo)
against the ORIGINAL masks, the Huber kernel on for the first two rounds.

Every function takes a batch dimension B written out: the frame step
solves its candidate problems as one batch.  The line and plane families
come with the slices that observe lines and planes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manhattanslam_tpu_torch.geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseProblem(NamedTuple):
    """Fixed-capacity point observations, (B, N, ...); masks select rows."""

    pt_xw: torch.Tensor  # (B, N, 3)
    pt_obs: torch.Tensor  # (B, N, 3) (u, v, uR)
    pt_info: torch.Tensor  # (B, N) invSigma2
    pt_stereo: torch.Tensor  # (B, N) bool
    pt_mask: torch.Tensor  # (B, N) bool


def stack_problems(probs: list[PoseProblem]) -> PoseProblem:
    """Concatenate problems along the batch axis."""
    return PoseProblem(*(torch.cat(fields) for fields in zip(*probs)))


def _comp_mask(prob: PoseProblem) -> torch.Tensor:
    """(B, N, 3) multiplier: the uR component only for stereo rows."""
    one = torch.ones_like(prob.pt_info)
    return torch.stack([one, one, prob.pt_stereo.to(one.dtype)], -1)


def _camera_points(T: torch.Tensor, xw: torch.Tensor) -> torch.Tensor:
    return xw @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def residuals(T: torch.Tensor, prob: PoseProblem, K: torch.Tensor, bf) -> torch.Tensor:
    """(B, N, 3) raw point residuals obs - (u, v, u - bf/z) at poses T."""
    pc = _camera_points(T, prob.pt_xw)
    zi = _safe_z(pc[..., 2])
    u = pc[..., 0] / zi * K[0, 0] + K[0, 2]
    v = pc[..., 1] / zi * K[1, 1] + K[1, 2]
    ur = u - bf / zi
    return (prob.pt_obs - torch.stack([u, v, ur], -1)) * _comp_mask(prob)


def chi2(r: torch.Tensor, prob: PoseProblem) -> torch.Tensor:
    """Per-edge chi2 (information-weighted squared residual)."""
    return torch.sum(r * r, -1) * prob.pt_info


def chi2_threshold(prob: PoseProblem) -> torch.Tensor:
    """Per-row chi2 threshold: 5.991 mono / 7.815 stereo."""
    return torch.where(prob.pt_stereo, CHI2_STEREO, CHI2_MONO)


def _huber_w(c2: torch.Tensor, delta2: torch.Tensor, mask: torch.Tensor, huber_on: bool):
    """Per-edge Huber sqrt-weight at chi2 c2 with threshold delta2."""
    if huber_on:
        e = torch.sqrt(torch.clamp(c2, min=1e-12))
        delta = torch.sqrt(delta2)
        w = torch.where(e <= delta, torch.ones_like(e), torch.sqrt(delta / e))
    else:
        w = torch.ones_like(c2)
    return torch.where(mask, w, torch.zeros_like(w))


def _jacobians(T: torch.Tensor, prob: PoseProblem, K: torch.Tensor, bf) -> torch.Tensor:
    """(B, N, 3, 6) closed-form Jacobians of the point residuals wrt the
    left-multiplied twist (translation first): d pc / d xi = [I | -hat(pc)]."""
    fx, fy = K[0, 0], K[1, 1]
    pc = _camera_points(T, prob.pt_xw)
    zi = 1.0 / _safe_z(pc[..., 2])
    zero = torch.zeros_like(zi)
    row_u = torch.stack([fx * zi, zero, -fx * pc[..., 0] * zi * zi], -1)
    row_v = torch.stack([zero, fy * zi, -fy * pc[..., 1] * zi * zi], -1)
    row_ur = row_u + torch.stack([zero, zero, bf * zi * zi], -1)
    A = torch.stack([row_u, row_v, row_ur], -2)  # (B, N, 3, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape + (3,))
    dpc = torch.cat([eye, -se3.hat(pc)], dim=-1)  # (B, N, 3, 6)
    return -(A @ dpc) * _comp_mask(prob)[..., None]


def _solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve A x = b through a Cholesky factor and two
    triangular solves (no host sync: a failed factorization leaves
    non-finite entries that the callers reject).  Not cholesky_solve: on
    CUDA it synchronizes with the host once per call for a batch of more
    than one system."""
    L, _ = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]


def _all_finite(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x).all(dim=-1)


def _full_system(T, prob, K, bf, mask, huber_on):
    """H (B,6,6), g (B,6), cost (B,) of the weighted point rows at T."""
    r = residuals(T, prob, K, bf)
    w = _huber_w(chi2(r, prob), chi2_threshold(prob), mask, huber_on) * torch.sqrt(prob.pt_info)
    B = T.shape[0]
    J = (_jacobians(T, prob, K, bf) * w[..., None, None]).reshape(B, -1, 6)
    rw = (r * w[..., None]).reshape(B, -1)
    Jt = J.transpose(-1, -2)
    return Jt @ J, (Jt @ rw[..., None])[..., 0], 0.5 * torch.sum(rw * rw, -1)


def _cost(T, prob, K, bf, mask, huber_on):
    r = residuals(T, prob, K, bf)
    w = _huber_w(chi2(r, prob), chi2_threshold(prob), mask, huber_on) * torch.sqrt(prob.pt_info)
    return 0.5 * torch.sum((r * w[..., None]) ** 2, dim=(-1, -2))


def _where(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-batch select: c (B,) broadcast over a's trailing dims."""
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - 1)), a, b)


def _round_gn(T, prob, K, bf, mask, huber_on, n_iters):
    """Damped Gauss-Newton (no accept/reject pass): the candidate solves."""
    lam = 1e-3
    eye = torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(n_iters):
        H, g, _ = _full_system(T, prob, K, bf, mask, huber_on)
        step = -_solve_spd(H + lam * eye, g)
        ok = _all_finite(step) & (torch.linalg.norm(step, dim=-1) < 1.0)
        step = torch.where(ok[:, None], step, torch.zeros_like(step))
        T = _where(ok, se3.exp_se3(step) @ T, T)
    return T


def _round_lm(T, prob, K, bf, mask, huber_on, n_iters):
    """Deferred-accept LM: each iteration's one system evaluation both
    adjudicates the previous proposal against the stored accepted cost and
    provides the next linearization; a rejected step re-solves from the
    stored system with a raised lambda."""
    B = T.shape[0]
    eye = torch.eye(6, dtype=T.dtype, device=T.device)
    lam = torch.full((B,), 1e-3, dtype=T.dtype, device=T.device)
    T_acc = T
    H_acc = torch.zeros((B, 6, 6), dtype=T.dtype, device=T.device)
    g_acc = torch.zeros((B, 6), dtype=T.dtype, device=T.device)
    c_acc = torch.full((B,), float("inf"), dtype=T.dtype, device=T.device)
    for _ in range(n_iters):
        H, g, c = _full_system(T, prob, K, bf, mask, huber_on)
        ok = torch.isfinite(c) & (c < c_acc)
        T_acc = _where(ok, T, T_acc)
        H_acc = _where(ok, H, H_acc)
        g_acc = _where(ok, g, g_acc)
        c_acc = torch.where(ok, c, c_acc)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e6)
        step = -_solve_spd(H_acc + lam[:, None, None] * eye, g_acc)
        step = torch.where(_all_finite(step)[:, None], step, torch.zeros_like(step))
        T = se3.exp_se3(step) @ T_acc
    # the last proposal left the loop unevaluated: one cost-only pass
    # decides between it and the best accepted iterate
    return _where(_cost(T, prob, K, bf, mask, huber_on) < c_acc, T, T_acc)


def solve_pose(
    prob: PoseProblem,
    T0: torch.Tensor,
    K: torch.Tensor,
    bf,
    n_rounds: int = 4,
    n_iters: int = 10,
    gauss_newton: bool = False,
) -> dict:
    """Run the round schedule on a batch of problems from poses T0 (B,4,4).

    Returns T (B,4,4), inlier_pt (B,N), n_inliers (B,), chi2 (B,).
    """
    T = T0
    mask = prob.pt_mask
    th = chi2_threshold(prob)
    run_round = _round_gn if gauss_newton else _round_lm
    for rnd in range(n_rounds):
        T = run_round(T, prob, K, bf, mask, rnd < 2, n_iters)
        # re-gate against the ORIGINAL mask (edges can come back)
        mask = prob.pt_mask & (chi2(residuals(T, prob, K, bf), prob) <= th)
    c = chi2(residuals(T, prob, K, bf), prob)
    return {
        "T": T,
        "inlier_pt": mask,
        "n_inliers": mask.sum(-1),
        "chi2": torch.where(mask, c, torch.zeros_like(c)).sum(-1),
    }
