"""Line features: detection, band descriptors and lifting to 3D
(counterpart of manhattanslam_tpu/ops/lines.py).

- ``detect_lines``: a gradient-guided Hough transform (one vote per edge
  pixel into the (angle, rho) bin of its gradient direction), a 3x3 box
  sum and 5x5 non-maximum suppression of the vote grid, the top
  ``n_lines`` peaks, each edge pixel given to the strongest peak whose
  +-4 x +-2 bin neighbourhood holds its own bin, and a least-squares refit
  and extent per line.  At 200 px and more on the short side it runs on
  the 2x2 box-downsampled image and scales the endpoints back.
- ``line_descriptors``: gradient statistics in 7 bands along the segment
  (mean and population std of the along- and across-line components at 24
  samples), L2-normalized.
- ``lift_lines_3d``: up to 64 depth samples along the segment, 2-point
  RANSAC under the per-point anisotropic Mahalanobis point-line distance,
  two refit/re-select rounds, endpoints from the inliers' projections and
  an occupancy check of 10 cells.

Every function takes one frame's arrays or B streams' with a leading
stream axis; reductions, scatters and orderings run per stream.  Where the
reference leans on the TPU's matrix unit, the port uses the exact
equivalent: the vote grid is an int32 scatter-add (the reference's bf16
one-hot product counts exactly), the ownership grid an int32 scatter-max,
and the refit moments and extents are segment sums and minima over the
pixels (the reference's one-hot products, float32 sums in another order).
``jax.lax.top_k`` puts the lower index first among equal votes, so the
peaks come from a stable descending sort; std is the population std; the
sample tables are ``jnp.linspace``'s float32 values, built in numpy.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from manhattanslam_tpu_torch.ops import eig33
from manhattanslam_tpu_torch.ops.image import avgpool2, sobel

N_ANGLES = 120
RHO_BIN = 2.0  # pixels per rho bin
MIN_SEG_LEN = 20.0  # pixels
DESC_BANDS = 7
DESC_DIM = 4 * DESC_BANDS
DESC_SAMPLES = 24
ANG_W, RHO_W = 4, 2  # a peak's claimed bin neighbourhood
LIFT_SAMPLES = 64
LIFT_HYPOTHESES = 10


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` with constant bounds, value for
    value as XLA compiles it in float32: the step i / (num - 1) becomes
    i * r with r = 1 / (num - 1) rounded, and stop * step regroups as
    i * (stop * r); the last entry is stop itself."""
    f = np.float32
    i = np.arange(num - 1, dtype=f)
    r = f(1.0) / f(num - 1)
    out = f(start) * (f(1.0) - i * r) + i * (f(stop) * r)
    return np.concatenate([out, [f(stop)]]).astype(f)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The constant tables of the line ops on `device`, made once (a fresh
    host tensor per call would be an upload each time)."""
    half = LIFT_SAMPLES // 2
    tables = {
        "pi": np.float32(np.pi),
        "desc_ts": linspace_f32(0.05, 0.95, DESC_SAMPLES),
        "bands": np.arange(DESC_BANDS, dtype=np.float32) - (DESC_BANDS - 1) / 2,
        "lift_ts": linspace_f32(0.0, 1.0, LIFT_SAMPLES),
        "hyp0": linspace_f32(0, half - 1, LIFT_HYPOTHESES).astype(np.int64),
        "hyp1": linspace_f32(half, LIFT_SAMPLES - 1, LIFT_HYPOTHESES).astype(np.int64),
        "das": np.arange(-ANG_W, ANG_W + 1, dtype=np.int64),
        "drs": np.arange(-RHO_W, RHO_W + 1, dtype=np.int64),
        "cells": np.arange(10, dtype=np.int32),
    }
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in tables.items()}


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, in jnp.cross's term order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over a last axis of 3, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _sq3(v: torch.Tensor) -> torch.Tensor:
    return _dot3(v, v)


def line_equations(sp: torch.Tensor, ep: torch.Tensor) -> torch.Tensor:
    """Normalized homogeneous line through sp and ep (..., 3): (sp, 1) x
    (ep, 1) over its norm (LSDextractor.cpp:35-44 convention)."""
    one = torch.ones_like(sp[..., :1])
    eq = _cross(torch.cat([sp, one], -1), torch.cat([ep, one], -1))
    return eq / torch.clamp(torch.sqrt(_sq3(eq))[..., None], min=1e-9)


def edge_threshold(mag: torch.Tensor, mag_th: float) -> torch.Tensor:
    """The adaptive edge threshold of each stream's gradient magnitudes
    (B, N): mean + 1.5 std, at least mag_th.  The std is the population
    std, as ``jnp.std`` (torch's default divides by N - 1)."""
    std, mean = torch.std_mean(mag, dim=-1, correction=0)
    return torch.clamp(mean + 1.5 * std, min=mag_th)


def vote_grid(bin_idx: torch.Tensor, edge: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Edge-pixel counts per bin, (n_bins,) int32: an integer scatter-add,
    exact in any order (the reference counts with a bf16 one-hot matrix
    product accumulated in float32, also exact)."""
    return torch.zeros(n_bins, dtype=torch.int32, device=edge.device).index_add_(
        0, bin_idx.reshape(-1), edge.reshape(-1).to(torch.int32))


def top_peaks(v: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of each row of v (B, N) and their indices,
    equal values in index order as ``jax.lax.top_k`` gives them (a stable
    descending sort: the vote grid is integer, with many ties)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def detect_lines(
    gray: torch.Tensor,
    n_lines: int = 64,
    mag_th: float = 40.0,
    min_support: float = 15.0,
    min_density: float = 0.2,
    min_length: float = MIN_SEG_LEN,
) -> dict:
    """Hough segments of gray (..., H, W): sp, ep (..., L, 2) endpoints
    (x, y) in full-resolution pixels, eq (..., L, 3), response (..., L) (the
    supporting pixels), valid (..., L), angle (..., L).  Images of 200 px
    and more on the short side are detected at half resolution."""
    H0, W0 = gray.shape[-2:]
    gates = (mag_th, min_support, min_density, min_length)
    if min(H0, W0) >= 200:
        out = _detect_lines_impl(avgpool2(gray), n_lines, *gates)
        sp, ep = out["sp"] * 2.0, out["ep"] * 2.0
        return dict(out, sp=sp, ep=ep, eq=line_equations(sp, ep))
    return _detect_lines_impl(gray, n_lines, *gates)


def _detect_lines_impl(
    gray: torch.Tensor,
    n_lines: int,
    mag_th: float = 40.0,
    min_support: float = 15.0,
    min_density: float = 0.2,
    min_length: float = MIN_SEG_LEN,
) -> dict:
    lead = gray.shape[:-2]
    h, w = gray.shape[-2:]
    g = gray.reshape((-1, h, w))
    B, dev, L = g.shape[0], g.device, n_lines
    tab = _tables(dev)
    gx, gy = sobel(g)
    mag = torch.sqrt(gx * gx + gy * gy).reshape(B, -1)
    edge = mag > edge_threshold(mag, mag_th)[:, None]  # (B, HW)

    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w).reshape(-1)
    xs = torch.arange(w, dtype=torch.float32, device=dev).expand(h, w).reshape(-1)
    diag = float(np.hypot(h, w))
    A, R = N_ANGLES, int(2 * diag / RHO_BIN) + 2

    # one vote per edge pixel, in the angle bin of its gradient direction
    ga = torch.remainder(torch.atan2(gy, gx).reshape(B, -1), math.pi)
    abin = torch.clamp((ga / tab["pi"] * N_ANGLES).to(torch.int32), 0, A - 1)
    abin_ang = abin.to(torch.float32) * (math.pi / N_ANGLES)
    rho = xs * torch.cos(abin_ang) + ys * torch.sin(abin_ang)
    rbin = torch.clamp(((rho + diag) / RHO_BIN).to(torch.int32), 0, R - 1)
    offs = torch.arange(B, device=dev)[:, None] * (A * R)
    bin_idx = (abin * R + rbin).long() + offs  # (B, HW) into the B grids
    votes = vote_grid(bin_idx, edge, B * A * R).reshape(B, 1, A, R).to(torch.float32)

    # 3x3 box sum of split votes (zero outside), then 5x5 non-maximum
    # suppression; integer counts, so exact in any order
    v = F.avg_pool2d(votes, 3, stride=1, padding=1, divisor_override=1)
    v_nms = torch.where(v >= F.max_pool2d(v, 5, stride=1, padding=2), v, torch.zeros_like(v))
    top_v, top_i = top_peaks(v_nms.reshape(B, -1), L)
    top_a, top_r = top_i // R, top_i % R

    # bin ownership: each peak claims its +-ANG_W x +-RHO_W neighbourhood,
    # the stronger peak (lower rank) wins: a scatter-max of L - rank
    a_i = torch.remainder(top_a[:, :, None, None] + tab["das"][:, None], A)
    r_i = torch.clamp(top_r[:, :, None, None] + tab["drs"], 0, R - 1)
    bins = (a_i * R + r_i).reshape(B, -1) + offs
    prio = (L - torch.arange(L, dtype=torch.int32, device=dev))[:, None, None].expand(
        L, 2 * ANG_W + 1, 2 * RHO_W + 1)
    prio_grid = torch.zeros(B * A * R, dtype=torch.int32, device=dev).scatter_reduce_(
        0, bins.reshape(-1), prio.reshape(1, -1).expand(B, -1).reshape(-1), "amax")
    owner = torch.where(prio_grid > 0, L - prio_grid, -1)
    pix_line = torch.where(edge, owner[bin_idx], -1)  # (B, HW)

    # per-line weighted moments of the owned pixels: a one-hot product per
    # stream, as the reference's (lines.py:192-201).  A float scatter-add
    # on the card sums in the order of its atomics, which changes from run
    # to run (tools/probe_determinism.py found it the first op to differ);
    # one product of the same shape per stream also keeps a stream's sums
    # independent of how many streams share the call
    member = pix_line >= 0
    seg = torch.where(member, pix_line, L).long()
    wpix = torch.where(member, mag, torch.zeros_like(mag))
    cols = torch.stack(
        [wpix, wpix * xs, wpix * ys, wpix * xs * xs, wpix * xs * ys, wpix * ys * ys], -1)
    line_ids = torch.arange(L, device=dev)[:, None]
    sums = torch.stack([(seg[b] == line_ids).to(torch.float32) @ cols[b] for b in range(B)])
    wsum = torch.clamp(sums[..., 0], min=1e-6)
    mx = sums[..., 1] / wsum
    my = sums[..., 2] / wsum
    cxx = sums[..., 3] / wsum - mx * mx
    cxy = sums[..., 4] / wsum - mx * my
    cyy = sums[..., 5] / wsum - my * my
    # principal eigenvector of [[cxx, cxy], [cxy, cyy]]; axis-aligned
    # when the cross term vanishes
    tr = cxx + cyy
    det = cxx * cyy - cxy * cxy
    lam = 0.5 * tr + torch.sqrt(torch.clamp(0.25 * tr * tr - det, min=0.0))
    skew = torch.abs(cxy) > 1e-9
    ex = torch.where(skew, lam - cyy, 1.0)
    ey = torch.where(skew, cxy, 0.0)
    vert = ~skew & (cyy > cxx)
    ex = torch.where(vert, 0.0, ex)
    ey = torch.where(vert, 1.0, ey)
    en = torch.clamp(torch.sqrt(ex * ex + ey * ey), min=1e-9)
    dirx, diry = ex / en, ey / en
    line_ca, line_sa = -diry, dirx
    line_rho = mx * line_ca + my * line_sa

    # extent along the refit direction over the owned pixels within 2.5 px
    # of the refit line
    params = torch.stack([line_ca, line_sa, line_rho, dirx, diry], -1)  # (B, L, 5)
    pp = torch.gather(params, 1, torch.clamp(seg, max=L - 1)[..., None].expand(B, h * w, 5))
    dist_pix = torch.abs(xs * pp[..., 0] + ys * pp[..., 1] - pp[..., 2])
    assigned = member & (dist_pix < 2.5)
    t_pix = xs * pp[..., 3] + ys * pp[..., 4]
    seg2 = torch.where(assigned, pix_line, L).long()
    big = 1e9
    tmin = torch.full((B, L + 1), big, device=dev).scatter_reduce_(1, seg2, t_pix, "amin")[:, :L]
    tmax = torch.full((B, L + 1), -big, device=dev).scatter_reduce_(1, seg2, t_pix, "amax")[:, :L]
    n_support = torch.zeros(B, L + 1, device=dev).scatter_add_(
        1, seg2, torch.ones_like(t_pix))[:, :L]

    length = tmax - tmin
    density = n_support / torch.clamp(length, min=1.0)
    valid = (
        (top_v > 0)
        & (n_support >= min_support)
        & (length >= min_length)
        & (length < diag)
        & (density > min_density)
    )
    # endpoints: the foot of the line at tmin / tmax along the direction
    px, py = line_ca * line_rho, line_sa * line_rho
    sp = torch.stack([px + tmin * dirx, py + tmin * diry], -1)
    ep = torch.stack([px + tmax * dirx, py + tmax * diry], -1)
    out = {
        "sp": sp, "ep": ep, "eq": line_equations(sp, ep),
        "response": n_support, "valid": valid,
        "angle": torch.atan2(ep[..., 1] - sp[..., 1], ep[..., 0] - sp[..., 0]),
    }
    return {k: v.reshape(lead + v.shape[1:]) for k, v in out.items()}


def _gather_pixels(img: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """img (B, H, W) at integer pixels (B, ...) -> (B, ...)."""
    B, _, w = img.shape
    idx = (yi * w + xi).reshape(B, -1)
    return torch.gather(img.reshape(B, -1), 1, idx).reshape(xi.shape)


def line_descriptors(gray: torch.Tensor, sp: torch.Tensor, ep: torch.Tensor) -> torch.Tensor:
    """LBD-like band descriptor (..., L, 28), L2-normalized: the mean and
    population std of the gradient along and across the segment, in 7
    bands 2 px apart, at 24 samples along it."""
    lead = gray.shape[:-2]
    h, w = gray.shape[-2:]
    g = gray.reshape((-1, h, w))
    B = g.shape[0]
    sp, ep = sp.reshape(B, -1, 2), ep.reshape(B, -1, 2)
    tab = _tables(g.device)
    gx, gy = sobel(g)
    d = ep - sp
    length = torch.clamp(torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]), min=1e-6)
    u = d / length[..., None]  # along
    n = torch.stack([-u[..., 1], u[..., 0]], -1)  # across
    # sample positions (B, L, S, bands, 2)
    base = sp[:, :, None, :] + tab["desc_ts"][:, None] * d[:, :, None, :]
    pos = base[:, :, :, None, :] + tab["bands"][:, None] * 2.0 * n[:, :, None, None, :]
    xi = torch.clamp(torch.round(pos[..., 0]), 0, w - 1).long()
    yi = torch.clamp(torch.round(pos[..., 1]), 0, h - 1).long()
    sgx = _gather_pixels(gx, xi, yi)
    sgy = _gather_pixels(gy, xi, yi)
    ua, na = u[:, :, None, None, :], n[:, :, None, None, :]
    g_par = sgx * ua[..., 0] + sgy * ua[..., 1]
    g_per = sgx * na[..., 0] + sgy * na[..., 1]
    s_par, m_par = torch.std_mean(g_par, dim=2, correction=0)
    s_per, m_per = torch.std_mean(g_per, dim=2, correction=0)
    feats = torch.cat([m_par, s_par, m_per, s_per], -1)  # (B, L, 28)
    nrm = torch.sqrt(torch.sum(feats * feats, -1, keepdim=True))
    out = feats / torch.clamp(nrm, min=1e-6)
    return out.reshape(lead + out.shape[1:])


def _whiten_factors(pts: torch.Tensor, f: torch.Tensor):
    """The closed-form whitening factor of the backprojection covariance
    (3DLineExtractor.cpp:74-90), rows (f/z, 0, -x f/z^2), (0, f/z, -y f/z^2),
    (0, 0, 1/sigma_d), with sigma_d(z) = 0.00273 z^2 + 0.00074 z - 0.00058
    (at least 1e-4).  Returns (f/z, x f/z^2, y f/z^2, 1/sigma_d)."""
    x, y, z = pts.unbind(-1)
    zc = torch.clamp(z, min=1e-6)
    sig = torch.clamp(0.00273 * z * z + 0.00074 * z - 0.00058, min=1e-4)
    f_z = f / zc
    return f_z, x * f_z / zc, y * f_z / zc, 1.0 / sig


def _mah_dist_sq(pts, fw, q1, q2):
    """Squared Mahalanobis distance of each point to the 3D line (q1, q2)
    under its own covariance (3DLineExtractor.cpp:264-296): both endpoint
    offsets whitened by the point's factor, then |u x v|^2 / |u - v|^2."""
    f_z, cx, cy, inv_sig = fw

    def whiten(d):
        return torch.stack(
            [f_z * d[..., 0] - cx * d[..., 2], f_z * d[..., 1] - cy * d[..., 2],
             inv_sig * d[..., 2]], -1)

    u = whiten(pts - q1)
    v = whiten(pts - q2)
    return _sq3(_cross(u, v)) / torch.clamp(_sq3(u - v), min=1e-12)


def lift_lines_3d(
    depth: torch.Tensor,
    K: torch.Tensor,
    sp: torch.Tensor,
    ep: torch.Tensor,
    valid: torch.Tensor,
) -> dict:
    """Camera-frame 3D segments of the 2D segments (..., L, 2) from the
    depth image (..., H, W): sp3, ep3 (..., L, 3), ok, n_inliers and
    occ_ratio (..., L).  RANSAC over 10 two-point hypotheses (threshold 1.5
    under the Mahalanobis distance), two refit/re-select rounds that keep
    the larger inlier set, endpoints from the inliers' projections on the
    fitted line; ok needs >= 21 inliers, 5 cm of extent and 7 of 10 cells
    occupied."""
    lead = depth.shape[:-2]
    h, w = depth.shape[-2:]
    dep = depth.reshape((-1, h, w))
    B = dep.shape[0]
    sp, ep, valid = sp.reshape(B, -1, 2), ep.reshape(B, -1, 2), valid.reshape(B, -1)
    tab = _tables(dep.device)
    pos = sp[:, :, None, :] + tab["lift_ts"][:, None] * (ep - sp)[:, :, None, :]  # (B, L, S, 2)
    xi = torch.clamp(torch.round(pos[..., 0]), 0, w - 1).long()
    yi = torch.clamp(torch.round(pos[..., 1]), 0, h - 1).long()
    z = _gather_pixels(dep, xi, yi)  # (B, L, S)
    good = z > 0
    # back-project the rounded pixel whose depth was read
    x3 = (xi.to(z.dtype) - K[0, 2]) / K[0, 0] * z
    y3 = (yi.to(z.dtype) - K[1, 2]) / K[1, 1] * z
    pts = torch.stack([x3, y3, z], -1)  # (B, L, S, 3)
    fw = _whiten_factors(pts, K[0, 0])

    # hypotheses: pairs spread along the segment
    i0, i1 = tab["hyp0"], tab["hyp1"]
    a, b = pts[:, :, i0], pts[:, :, i1]  # (B, L, H, 3)
    hyp_ok = good[:, :, i0] & good[:, :, i1] & (_sq3(b - a) > 1e-12)
    d2 = _mah_dist_sq(pts[:, :, None], tuple(t[:, :, None] for t in fw),
                      a[:, :, :, None], b[:, :, :, None])  # (B, L, H, S)
    inl = (d2 < 1.5**2) & good[:, :, None] & hyp_ok[..., None]
    best = torch.argmax(inl.sum(-1), -1)  # the first of the most inliers
    S = pts.shape[2]
    best_inl = torch.gather(inl, 2, best[:, :, None, None].expand(B, -1, 1, S))[:, :, 0]

    def refit(inliers):
        wgt = inliers.to(torch.float32)
        nw = torch.clamp(wgt.sum(-1, keepdim=True), min=1.0)
        mean = (pts * wgt[..., None]).sum(-2) / nw
        cen = (pts - mean[:, :, None]) * wgt[..., None]
        cov = cen.transpose(-1, -2) @ cen / nw[..., None]
        return mean, eig33.eig33_largest(cov)[1]

    # two refit / re-select rounds; a re-selection is adopted only where
    # it does not shrink the set (the reference keeps the larger, :180-185)
    for _ in range(2):
        mean, direction = refit(best_inl)
        d2_fit = _mah_dist_sq(pts, fw, mean[:, :, None], (mean + direction)[:, :, None])
        re_inl = (d2_fit < 1.5**2) & good
        take = re_inl.sum(-1) >= best_inl.sum(-1)
        best_inl = torch.where(take[..., None], re_inl, best_inl)

    best_n = best_inl.sum(-1)
    mean, direction = refit(best_inl)
    t_proj = _dot3(pts - mean[:, :, None], direction[:, :, None])
    t_proj = torch.where(best_inl, t_proj, torch.zeros_like(t_proj))
    t0 = torch.where(best_inl, t_proj, torch.full_like(t_proj, 1e9)).amin(-1)
    t1 = torch.where(best_inl, t_proj, torch.full_like(t_proj, -1e9)).amax(-1)
    sp3 = mean + t0[..., None] * direction
    ep3 = mean + t1[..., None] * direction

    # occupancy of 10 cells of the fitted extent (3DLineExtractor.cpp:
    # 208-261): support clustered at the ends is no line
    n_cells = 10
    span = torch.clamp(t1 - t0, min=1e-6)
    cell = torch.clamp((t_proj - t0[..., None]) / span[..., None] * n_cells, 0.0,
                       n_cells - 1e-3).to(torch.int32)
    occupied = ((cell[..., None] == tab["cells"]) & best_inl[..., None]).any(-2)
    occ_ratio = occupied.to(torch.float32).mean(-1)
    ok = valid & (best_n >= S // 3) & ((t1 - t0) > 0.05) & (occ_ratio >= 0.7)
    out = {"sp3": sp3, "ep3": ep3, "ok": ok, "n_inliers": best_n, "occ_ratio": occ_ratio}
    return {k: v.reshape(lead + v.shape[1:]) for k, v in out.items()}
