"""Pose solver over point, line and plane residuals (counterpart of
manhattanslam_tpu/ops/lm.py).

The reference solves one 6-dof SE(3) pose with unary edges, so the g2o
machinery reduces to accumulating a 6x6 (or, translation only, 3x3) normal
system.  Point rows fuse the mono and stereo edges: the residual is obs
(u, v, uR) minus the projection (u, v, u - bf/z), with the uR component
weighted out for rows without depth.  Line rows are one per endpoint of a
matched map line: the observed image line l (normalized) at the projected
endpoint, l . (u, v, 1).  Plane rows compare a map plane,
moved into the camera by the pose, with the observed plane:
``plane_ominus`` (3 rows), ``plane_ominus_par`` and ``plane_ominus_ver``
(2 rows each, parallel and perpendicular structural planes).  The
schedule is the reference's: rounds of iterations, chi2 re-gating of every
family between rounds (5.991 mono / 7.815 stereo / 2 x 5.991 line /
Plane.Chi / Plane.VPChi) against the ORIGINAL masks, the Huber kernel on
for the first two rounds (lines at 7.815, weighted by sqrt(ln_info)).
``translation_only`` freezes the rotation (the Manhattan decoupled solve):
3 dof, retracted by adding to the translation.

Point and line Jacobians are closed-form, and so are the plane rows' (the
reference linearizes those with ``jax.linearize``): the map plane moved by
the pose is differentiated wrt the increment, then carried through the
normalization, the azimuth/elevation frame of the moved plane and the
residual angles; their IRLS weights are applied as row scales afterwards.
Every function takes a batch dimension B written out: the frame step
solves its candidate problems as one batch.

``solve_pose`` is the wrapper of the hand-written kernel ``csrc/lm_solve.cu``
(see the bound and design notes there): for CPU tensors it runs the plain
PyTorch version ``solve_pose_plain``; for CUDA tensors it makes ONE launch
of the kernel (``solve_pose_cuda``, counted) for the whole round schedule
of every problem of the batch, or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import numbers
from typing import NamedTuple

import numpy as np
import torch

from manhattanslam_tpu_torch.geometry import se3
from manhattanslam_tpu_torch.ops import kernel_build

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseProblem(NamedTuple):
    """Fixed-capacity observations, (B, N, ...); masks select rows."""

    pt_xw: torch.Tensor  # (B, N, 3)
    pt_obs: torch.Tensor  # (B, N, 3) (u, v, uR)
    pt_info: torch.Tensor  # (B, N) invSigma2
    pt_stereo: torch.Tensor  # (B, N) bool
    pt_mask: torch.Tensor  # (B, N) bool
    # planes: world coeffs of the matched map plane vs the observed
    # camera-frame coeffs (B, P, 4); parallel and perpendicular ones alike
    pl_w: torch.Tensor
    pl_obs: torch.Tensor
    pl_mask: torch.Tensor
    par_w: torch.Tensor
    par_obs: torch.Tensor
    par_mask: torch.Tensor
    ver_w: torch.Tensor
    ver_obs: torch.Tensor
    ver_mask: torch.Tensor
    # line endpoints, two rows per matched line (B, 2L, ...): the world
    # endpoint and the observed normalized image line; None: no lines
    ln_xw: torch.Tensor | None = None  # (B, NL, 3)
    ln_eq: torch.Tensor | None = None  # (B, NL, 3)
    ln_info: torch.Tensor | None = None  # (B, NL)
    ln_mask: torch.Tensor | None = None  # (B, NL) bool


def empty_problem(npt=512, nl=128, np_=8, npar=8, nver=8, lead: tuple = (),
                  device=None) -> PoseProblem:
    """A problem with every row masked out (lead: its batch axes)."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    off = torch.bool
    return PoseProblem(
        pt_xw=z(npt, 3), pt_obs=z(npt, 3), pt_info=z(npt), pt_stereo=z(npt, dtype=off),
        pt_mask=z(npt, dtype=off),
        pl_w=z(np_, 4), pl_obs=z(np_, 4), pl_mask=z(np_, dtype=off),
        par_w=z(npar, 4), par_obs=z(npar, 4), par_mask=z(npar, dtype=off),
        ver_w=z(nver, 4), ver_obs=z(nver, 4), ver_mask=z(nver, dtype=off),
        ln_xw=z(nl, 3), ln_eq=z(nl, 3), ln_info=z(nl), ln_mask=z(nl, dtype=off),
    )


def stack_problems(probs: list[PoseProblem]) -> PoseProblem:
    """Concatenate problems along the batch axis (a family that none of
    them carries stays None)."""
    return PoseProblem(*(
        None if fields[0] is None else torch.cat(fields) for fields in zip(*probs)))


class SolveParams(NamedTuple):
    """Plane-family weights and gates (float32 values)."""

    angle_info: float  # 3282.8 / AngleInfo^2
    dis_info: float  # DistanceInfo^2
    par_info: float
    ver_info: float
    plane_chi: float
    vp_chi: float


def default_params(cfg=None) -> SolveParams:
    if cfg is None:
        a, d, p, v, c, vc = 0.5, 50.0, 0.5, 0.5, 100.0, 50.0
    else:
        pc = cfg.plane
        a, d, p, v, c, vc = (
            pc.angle_info, pc.distance_info, pc.parallel_info,
            pc.vertical_info, pc.chi, pc.vp_chi,
        )
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    return SolveParams(
        angle_info=f32(3282.8 / (a * a)),
        dis_info=f32(d * d),
        par_info=f32(3282.8 / (p * p)),
        ver_info=f32(3282.8 / (v * v)),
        plane_chi=f32(c),
        vp_chi=f32(vc),
    )


# ---------------------------------------------------------------- plane math
# The plane helpers take a value and, optionally, its tangent: the
# derivative wrt the pose increment, with a trailing axis of the dof (None:
# the value alone).  A value is computed the same way with or without its
# tangent, so the linearized plane rows equal the rows.  Only the map
# plane moves with the pose; the observed plane is constant.
def _transform(T: torch.Tensor, pi: torch.Tensor, translation_only: bool | None = None):
    """Plane3D operator*: coeffs (..., N, 4) moved by the point transforms
    T (..., 4, 4), w >= 0.  With translation_only set, also the tangent
    (..., N, 4, dof) wrt the retraction at 0: exp(xi) @ T turns the normal
    by -hat(n) phi and shifts the offset by -n . rho (a rotation about the
    camera keeps the plane's distance); adding xi to t shifts it by -n . xi."""
    n2 = pi[..., :3] @ T[..., :3, :3].transpose(-1, -2)
    d2 = pi[..., 3] - torch.sum(T[..., None, :3, 3] * n2, -1)
    out = torch.cat([n2, d2[..., None]], -1)
    flip = out[..., 3:4] < 0
    out = torch.where(flip, -out, out)
    if translation_only is None:
        return out, None
    zero = torch.zeros(n2.shape + (3,), dtype=n2.dtype, device=n2.device)
    if translation_only:
        J = torch.cat([zero, -n2[..., None, :]], -2)
    else:
        J = torch.cat([
            torch.cat([zero, -se3.hat(n2)], -1),
            torch.cat([-n2, torch.zeros_like(n2)], -1)[..., None, :],
        ], -2)
    return out, torch.where(flip[..., None], -J, J)


def transform_plane_g2o(T: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """Plane3D operator*: plane coeffs (..., N, 4) moved by the point
    transforms T (..., 4, 4); w >= 0."""
    return _transform(T, pi)[0]


def _normalize(p, dp=None):
    nn = torch.linalg.vector_norm(p[..., :3], dim=-1, keepdim=True)
    s = torch.clamp(nn, min=1e-12)
    q = p / s
    flip = q[..., 3:4] < 0
    if dp is None:
        return torch.where(flip, -q, q), None
    ds = torch.where(nn > 1e-12, torch.sum(p[..., :3, None] * dp[..., :3, :], -2) / s, 0.0)
    dq = dp / s[..., None] - q[..., None] * (ds / s)[..., None, :]
    return torch.where(flip, -q, q), torch.where(flip[..., None], -dq, dq)


def normalize_plane(pi: torch.Tensor) -> torch.Tensor:
    """Plane3D::normalize: unit normal, w-coefficient >= 0."""
    return _normalize(pi)[0]


def plane_azimuth(v: torch.Tensor) -> torch.Tensor:
    return torch.atan2(v[..., 1], v[..., 0])


def plane_elevation(v: torch.Tensor) -> torch.Tensor:
    return torch.atan2(v[..., 2], torch.clamp(torch.linalg.vector_norm(v[..., :2], dim=-1), min=1e-12))


def _d_atan2(y, x, dy, dx):
    return (x[..., None] * dy - y[..., None] * dx) / (x * x + y * y)[..., None]


def _angles(v, dv=None):
    """Azimuth and elevation of v (..., 3), and their tangents."""
    az, el = plane_azimuth(v), plane_elevation(v)
    if dv is None:
        return az, el, None, None
    nn = torch.linalg.vector_norm(v[..., :2], dim=-1)
    r = torch.clamp(nn, min=1e-12)
    dr = torch.where(
        (nn > 1e-12)[..., None],
        (v[..., 0, None] * dv[..., 0, :] + v[..., 1, None] * dv[..., 1, :]) / r[..., None], 0.0)
    return (az, el, _d_atan2(v[..., 1], v[..., 0], dv[..., 1, :], dv[..., 0, :]),
            _d_atan2(v[..., 2], r, dv[..., 2, :], dr))


def _rotation_from_normal(n: torch.Tensor, angles=None) -> torch.Tensor:
    """Plane3D::rotation, Rz(azimuth) @ Ry(-elevation): maps (1,0,0) -> n;
    and, given the angles' tangents, the matrix's tangent."""
    az, el, daz, del_ = angles if angles is not None else _angles(n)
    ca, sa = torch.cos(az), torch.sin(az)
    ce, se_ = torch.cos(el), torch.sin(el)
    z = torch.zeros_like(az)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    R = mat([[ca * ce, -sa, -ca * se_], [sa * ce, ca, -sa * se_], [se_, z, ce]])
    if daz is None:
        return R
    dR_az = mat([[-sa * ce, -ca, sa * se_], [ca * ce, -sa, -ca * se_], [z, z, z]])
    dR_el = mat([[-ca * se_, z, -ca * ce], [-sa * se_, z, -sa * ce], [ce, z, -se_]])
    return R, dR_az[..., None] * daz[..., None, None, :] + dR_el[..., None] * del_[..., None, None, :]


def _rotate_into(n, dn, o):
    """R(n)^T o for a constant o (..., 3), and its tangent through n."""
    if dn is None:
        return (_rotation_from_normal(n).transpose(-1, -2) @ o[..., None])[..., 0], None
    R, dR = _rotation_from_normal(n, _angles(n, dn))
    return (R.transpose(-1, -2) @ o[..., None])[..., 0], torch.sum(dR * o[..., :, None, None], -3)


def _rodrigues(axis: torch.Tensor, angle: float) -> torch.Tensor:
    """Axis-angle rotation matrix for unit axes (..., 3) and one angle."""
    W = se3.hat(axis)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(W.shape)
    return eye + math.sin(angle) * W + (1 - math.cos(angle)) * (W @ W)


def _frame_normal(kind: str, s, ds, o):
    """The normal whose azimuth/elevation frame measures the observed
    plane o: the map plane's own ("pl"); its normal turned toward o's
    ("par", sign-invariant); or, for a perpendicular pair, its normal
    turned 90 deg toward o's about their common perpendicular ("ver")."""
    ns, no = s[..., :3], o[..., :3]
    dns = None if ds is None else ds[..., :3, :]
    if kind == "pl":
        return ns, dns
    if kind == "par":
        flip = torch.sum(no * ns, -1, keepdim=True) < 0
        return (torch.where(flip, -ns, ns),
                None if ds is None else torch.where(flip[..., None], -dns, dns))
    v = torch.linalg.cross(ns, no)
    nn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    sv = torch.clamp(nn, min=1e-12)
    vn = v / sv
    b = (_rodrigues(vn, math.pi / 2) @ ns[..., None])[..., 0]
    if ds is None:
        return b, None

    def cross(a, da):  # a x da for a (..., 3) and tangents da (..., 3, dof)
        return torch.linalg.cross(a[..., None].expand(da.shape), da, dim=-2)

    dv = -cross(no, dns)
    dsv = torch.where(nn > 1e-12, torch.sum(v[..., None] * dv, -2) / sv, 0.0)
    dvn = dv / sv[..., None] - vn[..., None] * (dsv / sv)[..., None, :]
    # b = ns + sin(a) vn x ns + (1 - cos(a)) vn x (vn x ns) at a = pi/2
    a1, a2 = math.sin(math.pi / 2), 1 - math.cos(math.pi / 2)
    w = torch.linalg.cross(vn, ns)
    dw = cross(vn, dns) - cross(ns, dvn)
    return b, dns + a1 * dw + a2 * (cross(vn, dw) - cross(w, dvn))


def _ominus(kind: str, pi_self, pi_other):
    s, _ = _normalize(pi_self)
    o = normalize_plane(pi_other)
    m, _ = _rotate_into(_frame_normal(kind, s, None, o)[0], None, o[..., :3])
    az, el, _, _ = _angles(m)
    if kind != "pl":
        return torch.stack([az, el], -1)
    return torch.stack([az, el, (-s[..., 3]) - (-o[..., 3])], -1)


def plane_ominus(pi_self: torch.Tensor, pi_other: torch.Tensor) -> torch.Tensor:
    """Plane3D::ominus: (azimuth, elevation, d_self - d_other) of the other
    plane's normal in the frame of this one; distance() = -coeffs(3)."""
    return _ominus("pl", pi_self, pi_other)


def plane_ominus_par(pi_self: torch.Tensor, pi_other: torch.Tensor) -> torch.Tensor:
    """Plane3D::ominus_par: sign-invariant azimuth/elevation residual."""
    return _ominus("par", pi_self, pi_other)


def plane_ominus_ver(pi_self: torch.Tensor, pi_other: torch.Tensor) -> torch.Tensor:
    """Plane3D::ominus_ver: the residual after rotating this plane's normal
    90 deg toward the other's."""
    return _ominus("ver", pi_self, pi_other)


# ------------------------------------------------------------- point family
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
    """Per-edge chi2 of the point rows (information-weighted)."""
    return torch.sum(r * r, -1) * prob.pt_info


def chi2_threshold(prob: PoseProblem) -> torch.Tensor:
    """Per-row chi2 threshold: 5.991 mono / 7.815 stereo."""
    return torch.where(prob.pt_stereo, CHI2_STEREO, CHI2_MONO)


def _huber_w(c2: torch.Tensor, delta2, mask: torch.Tensor, huber_on: bool):
    """Per-edge Huber sqrt-weight at chi2 c2 with threshold delta2 (a
    tensor, or one float for a whole family)."""
    if huber_on:
        e = torch.sqrt(torch.clamp(c2, min=1e-12))
        delta = torch.sqrt(delta2) if isinstance(delta2, torch.Tensor) else math.sqrt(delta2)
        w = torch.where(e <= delta, torch.ones_like(e), torch.sqrt(delta / e))
    else:
        w = torch.ones_like(c2)
    return torch.where(mask, w, torch.zeros_like(w))


def _jacobians(T, prob: PoseProblem, K, bf, translation_only: bool = False) -> torch.Tensor:
    """(B, N, 3, dof) closed-form Jacobians of the point residuals wrt the
    left-multiplied twist (translation first): d pc / d xi = [I | -hat(pc)]
    (the translation block alone when the rotation is frozen)."""
    fx, fy = K[0, 0], K[1, 1]
    pc = _camera_points(T, prob.pt_xw)
    zi = 1.0 / _safe_z(pc[..., 2])
    zero = torch.zeros_like(zi)
    row_u = torch.stack([fx * zi, zero, -fx * pc[..., 0] * zi * zi], -1)
    row_v = torch.stack([zero, fy * zi, -fy * pc[..., 1] * zi * zi], -1)
    row_ur = row_u + torch.stack([zero, zero, bf * zi * zi], -1)
    A = torch.stack([row_u, row_v, row_ur], -2)  # (B, N, 3, 3)
    if translation_only:
        return -A * _comp_mask(prob)[..., None]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape + (3,))
    dpc = torch.cat([eye, -se3.hat(pc)], dim=-1)  # (B, N, 3, 6)
    return -(A @ dpc) * _comp_mask(prob)[..., None]


# -------------------------------------------------------------- line family
def _project(T: torch.Tensor, xw: torch.Tensor, K: torch.Tensor):
    """Camera points (B, N, 3) of world points and their pixel (u, v)."""
    pc = _camera_points(T, xw)
    zi = _safe_z(pc[..., 2])
    return pc, pc[..., 0] / zi * K[0, 0] + K[0, 2], pc[..., 1] / zi * K[1, 1] + K[1, 2]


def line_residuals(T: torch.Tensor, prob: PoseProblem, K: torch.Tensor) -> torch.Tensor:
    """(B, NL) raw endpoint residuals l . (u, v, 1) at poses T."""
    _, u, v = _project(T, prob.ln_xw, K)
    eq = prob.ln_eq
    return eq[..., 0] * u + eq[..., 1] * v + eq[..., 2]


def _line_jacobians(T, prob: PoseProblem, K, translation_only: bool = False) -> torch.Tensor:
    """(B, NL, dof) closed-form Jacobians of the endpoint residuals wrt the
    left-multiplied twist: l0 du/dpc + l1 dv/dpc, times [I | -hat(pc)]."""
    fx, fy = K[0, 0], K[1, 1]
    pc = _camera_points(T, prob.ln_xw)
    zi = 1.0 / _safe_z(pc[..., 2])
    zero = torch.zeros_like(zi)
    row_u = torch.stack([fx * zi, zero, -fx * pc[..., 0] * zi * zi], -1)
    row_v = torch.stack([zero, fy * zi, -fy * pc[..., 1] * zi * zi], -1)
    eq = prob.ln_eq
    lrow = eq[..., 0, None] * row_u + eq[..., 1, None] * row_v  # (B, NL, 3)
    if translation_only:
        return lrow
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape + (3,))
    dpc = torch.cat([eye, -se3.hat(pc)], dim=-1)  # (B, NL, 3, 6)
    return (lrow[..., None, :] @ dpc)[..., 0, :]


def line_chi2(r: torch.Tensor, prob: PoseProblem) -> torch.Tensor:
    return r * r * prob.ln_info


# ------------------------------------------------------------- plane family
def _plane_rows(T: torch.Tensor, prob: PoseProblem, masks, translation_only: bool | None = None):
    """UNWEIGHTED masked plane-family rows at poses T, (B, R):
    [pl (P*3), par (P*2), ver (P*2)]; with translation_only set, also their
    Jacobian (B, R, dof) wrt the retraction increment, in closed form (the
    reference linearizes the same rows with jax.linearize).  The three
    families run as one batch of rows but for the frame normal of each.
    The IRLS weights are row scales applied outside, so one linearization
    serves weights and system."""
    sizes = [m.shape[-1] for m in masks]
    w = torch.cat([prob.pl_w, prob.par_w, prob.ver_w], -2)
    obs = torch.cat([prob.pl_obs, prob.par_obs, prob.ver_obs], -2)
    s, ds = _normalize(*_transform(T, w, translation_only))
    o = normalize_plane(obs)
    P, Q = sizes[0], sizes[0] + sizes[1]
    # with the rotation frozen the normals do not move: only the offset
    # rows have a tangent
    dn = None if translation_only else ds
    parts = [
        _frame_normal(kind, s[..., sl, :], None if dn is None else dn[..., sl, :, :], o[..., sl, :])
        for kind, sl in (("pl", slice(0, P)), ("par", slice(P, Q)), ("ver", slice(Q, None)))
    ]
    nor = torch.cat([n for n, _ in parts], -2)
    dnor = None if dn is None else torch.cat([d for _, d in parts], -3)
    az, el, daz, del_ = _angles(*_rotate_into(nor, dnor, o[..., :3]))
    ang = torch.stack([az, el], -1)
    rows = [torch.cat([ang[..., :P, :], ((-s[..., :P, 3]) - (-o[..., :P, 3]))[..., None]], -1),
            ang[..., P:Q, :], ang[..., Q:, :]]

    def guard(mask, x, n_tail):  # where(): a masked row's nan tangent stays out
        mask = mask.reshape(mask.shape + (1,) * n_tail)
        return torch.where(mask, x, torch.zeros_like(x)).flatten(-1 - n_tail, -n_tail)

    r = torch.cat([guard(m, x, 1) for m, x in zip(masks, rows)], -1)
    if ds is None:
        return r
    dang = (torch.stack([daz, del_], -2) if dn is not None
            else ds.new_zeros(az.shape + (2, ds.shape[-1])))
    drows = [torch.cat([dang[..., :P, :, :], -ds[..., :P, 3:, :]], -2),
             dang[..., P:Q, :, :], dang[..., Q:, :, :]]
    return r, torch.cat([guard(m, x, 2) for m, x in zip(masks, drows)], -2)


@functools.lru_cache(maxsize=None)
def _plane_weights(angle_info: float, dis_info: float, device: torch.device) -> torch.Tensor:
    """The plane rows' (angle, angle, distance) information, made once per
    device (a fresh host tensor per call would be an upload each time)."""
    return torch.tensor([angle_info, angle_info, dis_info], dtype=torch.float32, device=device)


def _plane_chi2(rp_raw: torch.Tensor, prob: PoseProblem, params: SolveParams):
    """Per-edge chi2 of the three plane families from their raw rows."""
    P = prob.pl_mask.shape[-1]
    Q = prob.par_mask.shape[-1]
    r_pl = rp_raw[..., : P * 3].unflatten(-1, (P, 3))
    r_par = rp_raw[..., P * 3: P * 3 + Q * 2].unflatten(-1, (Q, 2))
    r_ver = rp_raw[..., P * 3 + Q * 2:].unflatten(-1, (-1, 2))
    w_pl = _plane_weights(params.angle_info, params.dis_info, rp_raw.device)
    return (
        torch.sum(r_pl * r_pl * w_pl, -1),
        torch.sum(r_par * r_par, -1) * params.par_info,
        torch.sum(r_ver * r_ver, -1) * params.ver_info,
    ), w_pl


def _plane_row_scales(rp_raw, prob, params: SolveParams, masks, huber_on: bool) -> torch.Tensor:
    """(B, R) per-row scale (sqrt-info x Huber x mask) of the raw rows."""
    (chi_pl, chi_par, chi_ver), w_pl_c = _plane_chi2(rp_raw, prob, params)
    m_pl, m_par, m_ver = masks
    w_pl = _huber_w(chi_pl, params.plane_chi, m_pl, huber_on)
    w_par = _huber_w(chi_par, params.vp_chi, m_par, huber_on)
    w_ver = _huber_w(chi_ver, params.vp_chi, m_ver, huber_on)
    return torch.cat(
        [
            (w_pl[..., None] * torch.sqrt(w_pl_c)).flatten(-2),
            (w_par * math.sqrt(params.par_info)).repeat_interleave(2, -1),
            (w_ver * math.sqrt(params.ver_info)).repeat_interleave(2, -1),
        ],
        -1,
    )


def _retract(T: torch.Tensor, xi: torch.Tensor, translation_only: bool) -> torch.Tensor:
    if translation_only:
        return T + torch.nn.functional.pad(xi[..., None], (3, 0, 0, 1))
    return se3.exp_se3(xi) @ T


# ----------------------------------------------------------------- solving
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


def _where(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-batch select: c (B,) broadcast over a's trailing dims."""
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - 1)), a, b)


class _Solver:
    """One solve's fixed problem and options; T is (B, 4, 4).  The masks
    are a dict over the families in use: "pt", then "ln" with lines, then
    "pl", "par", "ver" with planes."""

    def __init__(self, prob, K, bf, params, translation_only, use_planes, use_lines):
        self.prob, self.K, self.bf, self.params = prob, K, bf, params
        self.translation_only = translation_only
        self.use_planes = use_planes
        self.use_lines = use_lines
        self.dof = 3 if translation_only else 6

    @staticmethod
    def plane_masks(masks):
        return masks["pl"], masks["par"], masks["ver"]

    def point_rows(self, T, m_pt, huber_on):
        r = residuals(T, self.prob, self.K, self.bf)
        w = _huber_w(chi2(r, self.prob), chi2_threshold(self.prob), m_pt, huber_on)
        return r, w * torch.sqrt(self.prob.pt_info)

    def line_rows(self, T, m_ln, huber_on):
        r = line_residuals(T, self.prob, self.K)
        w = _huber_w(line_chi2(r, self.prob), CHI2_STEREO, m_ln, huber_on)
        return r, w * torch.sqrt(self.prob.ln_info)

    def full_system(self, T, masks, huber_on):
        """H (B,dof,dof), g (B,dof), cost (B,) of every weighted row at T."""
        B = T.shape[0]
        r, w = self.point_rows(T, masks["pt"], huber_on)
        J = _jacobians(T, self.prob, self.K, self.bf, self.translation_only) * w[..., None, None]
        Js, rs = [J.reshape(B, -1, self.dof)], [(r * w[..., None]).reshape(B, -1)]
        if self.use_lines:
            rl, wl = self.line_rows(T, masks["ln"], huber_on)
            Js.append(_line_jacobians(T, self.prob, self.K, self.translation_only) * wl[..., None])
            rs.append(rl * wl)
        if self.use_planes:
            pm = self.plane_masks(masks)
            rp, Jq = _plane_rows(T, self.prob, pm, self.translation_only)
            s = _plane_row_scales(rp, self.prob, self.params, pm, huber_on)
            Js.append(Jq * s[..., None])
            rs.append(rp * s)
        J, rw = (torch.cat(Js, 1), torch.cat(rs, 1)) if len(Js) > 1 else (Js[0], rs[0])
        Jt = J.transpose(-1, -2)
        return Jt @ J, (Jt @ rw[..., None])[..., 0], 0.5 * torch.sum(rw * rw, -1)

    def cost(self, T, masks, huber_on):
        r, w = self.point_rows(T, masks["pt"], huber_on)
        c = torch.sum((r * w[..., None]) ** 2, dim=(-1, -2))
        if self.use_lines:
            rl, wl = self.line_rows(T, masks["ln"], huber_on)
            c = c + torch.sum((rl * wl) ** 2, -1)
        c = 0.5 * c
        if self.use_planes:
            pm = self.plane_masks(masks)
            rp = _plane_rows(T, self.prob, pm)
            s = _plane_row_scales(rp, self.prob, self.params, pm, huber_on)
            c = c + 0.5 * torch.sum((rp * s) ** 2, -1)
        return c

    def retract(self, T, xi):
        return _retract(T, xi, self.translation_only)

    def round_gn(self, T, masks, huber_on, n_iters):
        """Damped Gauss-Newton (no accept/reject pass): short schedules."""
        eye = torch.eye(self.dof, dtype=T.dtype, device=T.device)
        for _ in range(n_iters):
            H, g, _ = self.full_system(T, masks, huber_on)
            step = -_solve_spd(H + 1e-3 * eye, g)
            ok = _all_finite(step) & (torch.linalg.norm(step, dim=-1) < 1.0)
            step = torch.where(ok[:, None], step, torch.zeros_like(step))
            T = _where(ok, self.retract(T, step), T)
        return T

    def round_lm(self, T, masks, huber_on, n_iters):
        """Deferred-accept LM: each iteration's one system evaluation both
        adjudicates the previous proposal against the stored accepted cost
        and provides the next linearization; a rejected step re-solves
        from the stored system with a raised lambda."""
        B, dof = T.shape[0], self.dof
        eye = torch.eye(dof, dtype=T.dtype, device=T.device)
        lam = torch.full((B,), 1e-3, dtype=T.dtype, device=T.device)
        T_acc = T
        H_acc = torch.zeros((B, dof, dof), dtype=T.dtype, device=T.device)
        g_acc = torch.zeros((B, dof), dtype=T.dtype, device=T.device)
        c_acc = torch.full((B,), float("inf"), dtype=T.dtype, device=T.device)
        for _ in range(n_iters):
            H, g, c = self.full_system(T, masks, huber_on)
            ok = torch.isfinite(c) & (c < c_acc)
            T_acc = _where(ok, T, T_acc)
            H_acc = _where(ok, H, H_acc)
            g_acc = _where(ok, g, g_acc)
            c_acc = torch.where(ok, c, c_acc)
            lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            step = -_solve_spd(H_acc + lam[:, None, None] * eye, g_acc)
            step = torch.where(_all_finite(step)[:, None], step, torch.zeros_like(step))
            T = self.retract(T_acc, step)
        # the last proposal left the loop unevaluated: one cost-only pass
        # decides between it and the best accepted iterate
        return _where(self.cost(T, masks, huber_on) < c_acc, T, T_acc)

    def chi(self, T) -> dict:
        """Per-edge chi2 of each family in use at T."""
        p = self.prob
        out = {"pt": chi2(residuals(T, p, self.K, self.bf), p)}
        if self.use_lines:
            out["ln"] = line_chi2(line_residuals(T, p, self.K), p)
        if self.use_planes:
            rp = _plane_rows(T, p, (p.pl_mask, p.par_mask, p.ver_mask))
            out.update(zip(("pl", "par", "ver"), _plane_chi2(rp, p, self.params)[0]))
        return out


def solve_pose(
    prob: PoseProblem,
    T0: torch.Tensor,
    K: torch.Tensor,
    bf,
    params: SolveParams | None = None,
    translation_only: bool = False,
    n_rounds: int = 4,
    n_iters: int = 10,
    gauss_newton: bool = False,
    use_planes: bool = False,
    use_lines: bool = False,
) -> dict:
    """Run the round schedule on a batch of problems from poses T0 (B,4,4).
    use_planes / use_lines=False leave those families out (the candidate
    solves); use_lines needs the problem's line rows.

    Returns T (B,4,4), inlier_pt / inlier_ln / inlier_pl / inlier_par /
    inlier_ver masks, n_inliers (B,) over every family and chi2 (B,).
    The plain version on the CPU; on the card one launch of the kernel
    (``solve_pose_cuda``)."""
    solve = solve_pose_plain if T0.device.type == "cpu" else solve_pose_cuda
    return solve(prob, T0, K, bf, params, translation_only, n_rounds, n_iters, gauss_newton,
                 use_planes, use_lines)


# The kernel's inputs by field: (family, trailing shape, dtype); the
# fields in PoseProblem's order are the kernel's, then T0 and K.
_KERNEL_SPEC = {
    **{f"{fam}_{k}": (fam, tail, dtype) for fam in ("pl", "par", "ver")
       for k, tail, dtype in (("w", (4,), torch.float32), ("obs", (4,), torch.float32),
                              ("mask", (), torch.bool))},
    "pt_xw": ("pt", (3,), torch.float32), "pt_obs": ("pt", (3,), torch.float32),
    "pt_info": ("pt", (), torch.float32), "pt_stereo": ("pt", (), torch.bool),
    "pt_mask": ("pt", (), torch.bool),
    "ln_xw": ("ln", (3,), torch.float32), "ln_eq": ("ln", (3,), torch.float32),
    "ln_info": ("ln", (), torch.float32), "ln_mask": ("ln", (), torch.bool),
}


def kernel_inputs(prob: PoseProblem, T0: torch.Tensor, K: torch.Tensor, use_planes: bool,
                  use_lines: bool) -> tuple[list, list[int]]:
    """The tensors of one csrc/lm_solve.cu launch, in its order: the
    problem's fields as they are (no copy; None for a family the solve
    leaves out), then T0 and K; and the row counts [B, points, line
    endpoints, pl, par, ver].  Raises on a device, dtype, shape or layout
    the kernel does not take: every tensor on T0's device, float32 or
    bool, contiguous, each family's rows (B, n, ...) with one n."""
    if T0.dtype != torch.float32 or T0.dim() != 3 or T0.shape[1:] != (4, 4):
        raise ValueError("solve_pose: T0 must be a (B, 4, 4) float32 tensor")
    dev, B = T0.device, T0.shape[0]
    used = {"pt"} | ({"ln"} if use_lines else set()) | ({"pl", "par", "ver"} if use_planes else set())
    tensors, rows = [], {}
    for name, x in zip(PoseProblem._fields, prob):
        fam, tail, dtype = _KERNEL_SPEC[name]
        if fam not in used:
            tensors.append(None)
            continue
        if x is None:
            raise ValueError(f"solve_pose: {name} is None but its family is in the solve")
        n = rows.setdefault(fam, x.shape[1] if x.dim() > 1 else -1)
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != (B, n) + tail:
            raise ValueError(f"solve_pose: {name} must be a {(B, n) + tail} {dtype} tensor on "
                             f"{dev}, not {tuple(x.shape)} {x.dtype} on {x.device}")
        tensors.append(x)
    if K.device != dev or K.dtype != torch.float32 or K.shape != (3, 3):
        raise ValueError(f"solve_pose: K must be a (3, 3) float32 tensor on {dev}")
    tensors += [T0, K]
    if not all(t is None or t.is_contiguous() for t in tensors):
        raise ValueError("solve_pose: the kernel takes contiguous tensors")
    return tensors, [B, rows["pt"], rows.get("ln", 0), rows.get("pl", 0), rows.get("par", 0),
                     rows.get("ver", 0)]


def solve_pose_cuda(
    prob: PoseProblem,
    T0: torch.Tensor,
    K: torch.Tensor,
    bf,
    params: SolveParams | None = None,
    translation_only: bool = False,
    n_rounds: int = 4,
    n_iters: int = 10,
    gauss_newton: bool = False,
    use_planes: bool = False,
    use_lines: bool = False,
) -> dict:
    """``solve_pose`` as ONE launch of csrc/lm_solve.cu on T0's CUDA device
    (one block per problem), on the current stream with no host sync:
    outputs as the plain version's, allocated here.  bf is a number (a
    device tensor would need a sync)."""
    if T0.device.type != "cuda":
        raise ValueError(f"solve_pose_cuda: unsupported device {T0.device}")
    if isinstance(bf, torch.Tensor) or not isinstance(bf, numbers.Real):
        raise ValueError("solve_pose_cuda: bf must be a number")
    if min(n_rounds, n_iters) < 0:
        raise ValueError("solve_pose_cuda: negative n_rounds or n_iters")
    params = default_params() if params is None else params
    tensors, dims = kernel_inputs(prob, T0, K, use_planes, use_lines)
    B, n_pt, dev = dims[0], dims[1], T0.device
    # output mask widths: a family left out returns zeros of the plain
    # version's shapes (pl_mask's for all three plane families)
    P = prob.pl_mask.shape[-1]
    widths = [0 if prob.ln_mask is None else prob.ln_mask.shape[-1], P,
              dims[4] if use_planes else P, dims[5] if use_planes else P]

    def mask(n):
        return torch.empty((B, n), dtype=torch.bool, device=dev)

    out = {
        "T": torch.empty((B, 4, 4), dtype=torch.float32, device=dev),
        "inlier_pt": mask(n_pt),
        **{"inlier_" + k: mask(n) for k, n in zip(("ln", "pl", "par", "ver"), widths)},
        "n_inliers": torch.empty((B,), dtype=torch.int64, device=dev),
        "chi2": torch.empty((B,), dtype=torch.float32, device=dev),
    }
    err = kernel_build.kernel("lm_solve")(
        kernel_build.c_array(ctypes.c_void_p, [None if t is None else t.data_ptr() for t in tensors]),
        kernel_build.c_array(ctypes.c_void_p, [t.data_ptr() for t in out.values()]),
        kernel_build.c_array(ctypes.c_int, dims + widths),
        kernel_build.c_array(ctypes.c_float, [float(bf), *params]),
        3 if translation_only else 6, int(gauss_newton), int(use_lines), int(use_planes),
        int(n_rounds), int(n_iters), torch.cuda.current_stream(dev).cuda_stream,
    )
    kernel_build.check_launch("lm_solve", err)
    solve_pose_cuda.launches += 1
    return out


solve_pose_cuda.launches = 0


def solve_pose_plain(
    prob: PoseProblem,
    T0: torch.Tensor,
    K: torch.Tensor,
    bf,
    params: SolveParams | None = None,
    translation_only: bool = False,
    n_rounds: int = 4,
    n_iters: int = 10,
    gauss_newton: bool = False,
    use_planes: bool = False,
    use_lines: bool = False,
) -> dict:
    """``solve_pose`` in plain PyTorch (the CPU's path; on the card the
    kernel's yardstick)."""
    params = default_params() if params is None else params
    s = _Solver(prob, K, bf, params, translation_only, use_planes, use_lines)
    masks0 = {"pt": prob.pt_mask}
    ths = {"pt": chi2_threshold(prob)}
    if use_lines:
        masks0["ln"], ths["ln"] = prob.ln_mask, 2.0 * CHI2_MONO
    if use_planes:
        masks0.update(pl=prob.pl_mask, par=prob.par_mask, ver=prob.ver_mask)
        ths.update(pl=params.plane_chi, par=params.vp_chi, ver=params.vp_chi)
    run_round = s.round_gn if gauss_newton else s.round_lm
    T, masks = T0, masks0
    for rnd in range(n_rounds):
        T = run_round(T, masks, rnd < 2, n_iters)
        # re-gate against the ORIGINAL masks (edges can come back)
        chis = s.chi(T)
        masks = {k: m & (chis[k] <= ths[k]) for k, m in masks0.items()}
    chis = s.chi(T)
    if not use_planes:
        off = torch.zeros_like(prob.pl_mask)
        masks_out = dict(masks, pl=off, par=off, ver=off)
    else:
        masks_out = dict(masks)
    if not use_lines:
        masks_out["ln"] = (torch.zeros_like(prob.ln_mask) if prob.ln_mask is not None
                           else prob.pt_mask.new_zeros(prob.pt_mask.shape[:-1] + (0,)))
    return {
        "T": T,
        **{"inlier_" + k: masks_out[k] for k in ("pt", "ln", "pl", "par", "ver")},
        "n_inliers": _total(m.sum(-1) for m in masks.values()),
        "chi2": _total(torch.where(m, chis[k], torch.zeros_like(chis[k])).sum(-1)
                       for k, m in masks.items()),
    }


def _total(xs):
    """The sum of the tensors, with no add for a single one."""
    xs = list(xs)
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out
