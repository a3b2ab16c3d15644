"""Plain plane extraction: a frozen copy of the port's device plane path
(``ops/planes.py``: ``extract_planes_device`` and the stages it runs, with
``ops/eig33.py``'s closed-form eigenpairs) in plain PyTorch.

depth -> organized half-resolution cloud -> 10x10 block moments and their
smallest eigenpair -> block merging by min-label propagation -> the
largest segments as plane slots -> membership by erosion and masked
dilation, refit, re-gate.  ``extract_planes`` returns per slot the
``coeffs`` (n, d with d >= 0), ``n_support`` and ``valid`` that the
program's plane branch returns.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-20

BLOCK = 10  # AHCPlaneFitter windowWidth/Height

# PEAC dynamic threshold model (AHCParamSet.hpp:68-146) in meters:
# point-plane std at depth z is sigma(z) = DEPTH_SIGMA * z^2 + stdTol
DEPTH_SIGMA = 1.6e-3
STD_TOL_INIT = 0.005
STD_TOL_MERGE = 0.008
Z_NEAR, Z_FAR = 0.5, 4.0
ANG_NEAR = float(np.radians(15.0))
ANG_FAR = float(np.radians(90.0))
DEPTH_ALPHA, DEPTH_CHANGE_TOL = 0.04, 0.02  # T_dz = alpha*z + tol
HASH_MUL = -1640531535  # Knuth's 2654435761 as a wrapped int32



def _det3(a: torch.Tensor) -> torch.Tensor:
    """3x3 determinant in the reference's term order (jnp.linalg.det's
    closed form for 3x3)."""
    return (
        a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
        + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
        + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
        - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
        - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
        - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2]
    )


def _eigenvalues(A: torch.Tensor) -> torch.Tensor:
    """All three eigenvalues, ascending: (..., 3)."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    Bn = B / p[..., None, None]
    r = torch.clamp(_det3(Bn) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam2 = q + 2.0 * p * torch.cos(phi)  # largest
    lam1 = 3.0 * q - lam0 - lam2
    return torch.stack([lam0, lam1, lam2], -1)


def _eigenvector(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector for eigenvalue lam: the largest cross product of two
    rows of A - lam I (degenerate input falls back to +z)."""
    C = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = C[..., 0, :], C[..., 1, :], C[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = torch.sum(c01 * c01, -1)
    n02 = torch.sum(c02 * c02, -1)
    n12 = torch.sum(c12 * c12, -1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    nrm = torch.sqrt(torch.clamp(torch.sum(best * best, -1, keepdim=True), min=_EPS))
    v = best / nrm
    degenerate = torch.maximum(torch.maximum(n01, n02), n12) < 1e-18
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    return torch.where(degenerate[..., None], fallback, v)


def eig33_smallest(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(smallest eigenvalue (...,), unit eigenvector (..., 3))."""
    lam = _eigenvalues(A)
    return lam[..., 0], _eigenvector(A, lam[..., 0])


def eig33_largest(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(largest eigenvalue (...,), unit eigenvector (..., 3))."""
    lam = _eigenvalues(A)
    return lam[..., 2], _eigenvector(A, lam[..., 2])


def t_mse(z, merge: bool = True):
    """Dynamic MSE threshold T_mse(z) (AHCParamSet.hpp:86-99), m^2."""
    tol = STD_TOL_MERGE if merge else STD_TOL_INIT
    s = DEPTH_SIGMA * z * z + tol
    return s * s


def t_ang_cos(z: torch.Tensor) -> torch.Tensor:
    """cos of the dynamic normal-deviation threshold T_ang(INIT, z): 15 deg
    at 0.5 m -> 90 deg at 4 m (AHCParamSet.hpp:100-128)."""
    zc = torch.clamp(z, Z_NEAR, Z_FAR)
    ang = ANG_NEAR + (ANG_FAR - ANG_NEAR) * (zc - Z_NEAR) / (Z_FAR - Z_NEAR)
    return torch.cos(ang)


def depth_to_points(depth: torch.Tensor, K: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Organized camera-frame cloud (..., ceil(H/stride), ceil(W/stride), 3)
    of every stride-th row and column; 0 depth -> nan.  The strided slice
    gives the values of the reference's two 0/1 selection products
    exactly."""
    d = depth[..., ::stride, ::stride]
    h, w = d.shape[-2:]
    ys = (torch.arange(h, dtype=torch.float32, device=d.device) * stride - K[1, 2]) / K[1, 1]
    xs = (torch.arange(w, dtype=torch.float32, device=d.device) * stride - K[0, 2]) / K[0, 0]
    z = torch.where(d > 0, d, torch.full_like(d, float("nan")))
    return torch.stack([xs * z, ys[:, None] * z, z], -1)


def _tile(a: torch.Tensor, bh: int, bw: int, block: int, tail: int) -> torch.Tensor:
    """(..., H, W[, 3]) cut to (..., bh*bw, block*block[, 3]); tail is the
    number of trailing axes after W (0 or 1)."""
    n_lead = a.dim() - 2 - tail
    lead = a.shape[:n_lead]
    t = a.shape[a.dim() - tail:]
    a = a[(Ellipsis, slice(0, bh * block), slice(0, bw * block)) + (slice(None),) * tail]
    a = a.reshape(lead + (bh, block, bw, block) + t).transpose(n_lead + 1, n_lead + 2)
    return a.reshape(lead + (bh * bw, block * block) + t)


def block_stats(points: torch.Tensor, block: int = BLOCK) -> dict:
    """Per-block plane statistics of a (..., H, W, 3) cloud (nan invalid):
    (..., bh*bw)-shaped n, s1, s2, mean, normal, mse, valid."""
    H, W = points.shape[-3:-1]
    bh, bw = H // block, W // block
    blocks = _tile(points, bh, bw, block, 1)
    finite = torch.isfinite(blocks[..., 2])
    n_valid = finite.sum(-1)
    all_valid = n_valid == block * block

    pz = torch.where(finite[..., None], blocks, torch.zeros_like(blocks))
    s1 = pz.sum(-2)
    s2 = pz.transpose(-1, -2) @ pz
    n = torch.clamp(n_valid, min=1).to(torch.float32)
    mean = s1 / n[..., None]
    cov = s2 / n[..., None, None] - mean[..., None, :] * mean[..., :, None]

    ev_small, normal = eig33_smallest(cov)
    mse = torch.clamp(ev_small, min=0.0)
    # orient towards the camera
    flip = torch.sum(normal * mean, -1) > 0
    normal = torch.where(flip[..., None], -normal, normal)

    # depth continuity: a block with an adjacent-pixel depth step is no
    # planar seed; T_dz(z) = 0.04 z + 0.02 (AHCParamSet.hpp:131-146)
    z_img = points[..., : bh * block, : bw * block, 2]
    jump_x = torch.abs(torch.diff(z_img, dim=-1, prepend=z_img[..., :1]))
    jump_y = torch.abs(torch.diff(z_img, dim=-2, prepend=z_img[..., :1, :]))
    jump = _tile(torch.maximum(jump_x, jump_y), bh, bw, block, 0)
    # nanmax: nan only where the whole block is nan
    gone = torch.isnan(jump)
    max_jump = torch.where(gone, torch.full_like(jump, -float("inf")), jump).amax(-1)
    max_jump = torch.where(gone.all(-1), torch.full_like(max_jump, float("nan")), max_jump)
    z_mean = mean[..., 2]
    depth_ok = max_jump < DEPTH_ALPHA * z_mean + DEPTH_CHANGE_TOL
    # planarity seed gate under the dynamic INIT threshold
    planar_ok = mse < t_mse(z_mean, merge=False)
    return {
        "n": n_valid,
        "s1": s1,
        "s2": s2,
        "mean": mean,
        "normal": normal,
        "mse": mse,
        "valid": all_valid & depth_ok & planar_ok & torch.isfinite(mse),
    }


def merge_rounds(n_blocks: int) -> int:
    """Rounds of (local step + pointer jump): ceil(log2 B) + 1, at least 6
    (the reference's fixed count, not a guaranteed fixpoint)."""
    return max(int(np.ceil(np.log2(max(n_blocks, 2)))) + 1, 6)


def merge_blocks_device(stats: dict, grid_shape: tuple[int, int], min_support) -> torch.Tensor:
    """Block merging by min-label propagation: each block repeatedly takes
    the minimum label over the 4-neighbours it may merge with (normals
    within the dynamic angle, each centroid within 2 sigma of the other's
    plane), with pointer jumping between rounds.  Returns (..., B) int32:
    each block's root block, -1 for invalid blocks and for segments with
    less than min_support points."""
    bh, bw = grid_shape
    nb = bh * bw
    lead = stats["valid"].shape[:-1]
    dev = stats["valid"].device
    normal = stats["normal"].reshape(lead + (bh, bw, 3))
    mean = stats["mean"].reshape(lead + (bh, bw, 3))
    valid = stats["valid"].reshape(lead + (bh, bw))
    ys = torch.arange(bh, device=dev)[:, None].expand(bh, bw)
    xs = torch.arange(bw, device=dev)[None, :].expand(bh, bw)

    def shift(a, dy, dx, vec=False):
        dims = (-3, -2) if vec else (-2, -1)
        return torch.roll(a, (dy, dx), dims)

    def edge_ok(dy, dx):
        n2 = shift(normal, dy, dx, True)
        m2 = shift(mean, dy, dx, True)
        v2 = shift(valid, dy, dx)
        dot = torch.sum(normal * n2, -1)
        # mutual plane consistency: each centroid close to the other's plane
        d12 = torch.abs(torch.sum((m2 - mean) * normal, -1))
        d21 = torch.abs(torch.sum((mean - m2) * n2, -1))
        zbar = 0.5 * (mean[..., 2] + m2[..., 2])
        tol = 2.0 * (DEPTH_SIGMA * zbar * zbar + STD_TOL_MERGE)
        ok = (dot > t_ang_cos(zbar)) & (d12 < tol) & (d21 < tol) & valid & v2
        # no wrap-around edges
        if dy == 1:
            ok = ok & (ys > 0)
        if dy == -1:
            ok = ok & (ys < bh - 1)
        if dx == 1:
            ok = ok & (xs > 0)
        if dx == -1:
            ok = ok & (xs < bw - 1)
        return ok

    oks = {d: edge_ok(*d) for d in ((1, 0), (-1, 0), (0, 1), (0, -1))}
    ids = torch.arange(nb, dtype=torch.int32, device=dev).reshape(bh, bw)
    lab = torch.where(valid, ids, torch.full_like(ids, nb))
    sentinel = torch.full(lead + (1,), nb, dtype=torch.int32, device=dev)
    for _ in range(merge_rounds(nb)):
        for (dy, dx), ok in oks.items():
            lab = torch.where(ok, torch.minimum(lab, shift(lab, dy, dx)), lab)
        # pointer jumping: lab[i] <- lab[lab[i]]
        flat = lab.reshape(lead + (nb,))
        lab = torch.cat([flat, sentinel], -1).gather(-1, flat.long()).reshape(lead + (bh, bw))
    lab = torch.where(valid, lab, torch.full_like(lab, -1)).reshape(lead + (nb,))

    # support per root; small segments dropped
    seg = torch.where(lab >= 0, lab, nb).long()
    support = torch.zeros(lead + (nb + 1,), device=dev).scatter_add(
        -1, seg, stats["n"].to(torch.float32))
    keep = support.gather(-1, torch.clamp(lab, 0, nb).long()) >= min_support
    return torch.where((lab >= 0) & keep, lab, torch.full_like(lab, -1))


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, equal values lower index first
    (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_segments(labels: torch.Tensor, n_blocks: torch.Tensor, max_planes: int) -> torch.Tensor:
    """Root-block labels (..., B) -> dense plane slots 0..P-1 by support
    (ties: lower root first), -1 elsewhere."""
    nb = labels.shape[-1]
    seg = torch.where(labels >= 0, labels, nb).long()
    support = torch.zeros(labels.shape[:-1] + (nb + 1,), device=labels.device).scatter_add(
        -1, seg, n_blocks.to(torch.float32))[..., :nb]
    top_v, top_i = topk_stable(support, max_planes)
    rank = torch.arange(max_planes, dtype=torch.int32, device=labels.device).expand(top_v.shape)
    slot = torch.full(labels.shape, -1, dtype=torch.int32, device=labels.device).scatter(
        -1, top_i, torch.where(top_v > 0, rank, torch.full_like(rank, -1)))
    return torch.where(labels >= 0, slot.gather(-1, torch.clamp(labels, 0, nb - 1).long()), -1)


def hash_priorities(n: int, device: torch.device) -> torch.Tensor:
    """(n,) int32 pixel priorities: |(i * 2654435761 wrapped to int32) >> 8|
    | 1, made on `device` with int32 arithmetic as the reference does."""
    idx = torch.arange(n, dtype=torch.int32, device=device)
    prio = (idx * torch.tensor(HASH_MUL, dtype=torch.int32, device=device)) >> 8
    return torch.abs(prio) | 1


def _repeat_blocks(a: torch.Tensor, block: int, h: int, w: int, fill) -> torch.Tensor:
    """(..., bh, bw) block values -> (..., h, w) pixels; pixels past the
    block grid get `fill`."""
    img = a.repeat_interleave(block, -2).repeat_interleave(block, -1)
    return F.pad(img, (0, w - img.shape[-1], 0, h - img.shape[-2]), value=fill)


def plane_stage2(
    pts: torch.Tensor,
    block_plane: torch.Tensor,
    dist_th: float,
    max_planes: int,
    max_points: int,
    block: int = BLOCK,
    refine_iters: int = 20,
) -> dict:
    """Pixel membership with PEAC-style refinement, refit, cloud selection
    for B streams: pts (B, h, w, 3), block_plane (B, bh, bw) in [-1, P).

    Boundary blocks of each segment release their pixels; an iterated
    masked dilation from the interior cores re-claims them (a pixel joins
    the reached plane of least point-plane distance, inside that plane's
    3-sigma band); a refit and a 1.5 * dist_th re-gate give the exported
    membership.  Returns membership (B, h, w), coeffs (B, P, 4),
    n_support, valid, inlier_frac, n_pts (B, P) and clouds (B, P, M, 3)."""
    B, h, w, _ = pts.shape
    bh, bw = block_plane.shape[-2:]
    P = max_planes
    HW = h * w
    dev = pts.device
    planes = torch.arange(P, dtype=torch.int32, device=dev)
    finite = torch.isfinite(pts[..., 2])
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    lab_full = torch.where(finite, _repeat_blocks(block_plane, block, h, w, -1), neg)

    pz = torch.where(finite[..., None], pts, torch.zeros_like(pts)).reshape(B, HW, 3)
    # first and second moments per pixel; a plane's are their masked sums
    # (a reduction, not a product: a stream's sums then do not depend on
    # how many streams share the call)
    moments = torch.cat([pz, (pz[..., :, None] * pz[..., None, :]).reshape(B, HW, 9)], -1)

    def fit(labels):
        onehot = (labels.reshape(B, 1, HW) == planes[:, None]).to(torch.float32)
        n = onehot.sum(-1)
        sums = (onehot[..., None] * moments[:, None]).sum(-2)
        s1, s2 = sums[..., :3], sums[..., 3:].reshape(B, P, 3, 3)
        nn = torch.clamp(n, min=1.0)
        mean = s1 / nn[..., None]
        cov = s2 / nn[..., None, None] - mean[..., None, :] * mean[..., :, None]
        mse, nrm = eig33_smallest(cov)
        flip = torch.sum(nrm * mean, -1) > 0
        nrm = torch.where(flip[..., None], -nrm, nrm)
        d = -torch.sum(nrm * mean, -1)
        return nrm, d, n, torch.clamp(mse, min=0.0)

    def counts(labels):  # (B, P) pixels per plane
        seg = torch.where(labels >= 0, labels, P).reshape(B, HW).long()
        return torch.zeros(B, P + 1, device=dev).scatter_add(
            -1, seg, torch.ones(B, HW, device=dev))[:, :P]

    # block-level erosion: interior blocks keep their pixels; pixels of
    # blocks with a differently labelled 4-neighbour are released (an
    # out-of-grid neighbour counts as the same label)
    padded = F.pad(block_plane, (1, 1, 1, 1), value=-2)
    interior_b = block_plane >= 0
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        nb = padded[:, 1 + dy: 1 + dy + bh, 1 + dx: 1 + dx + bw]
        interior_b = interior_b & ((nb == block_plane) | (nb == -2))
    interior_img = _repeat_blocks(interior_b, block, h, w, False)
    seed_lab = torch.where(interior_img & finite, lab_full, neg)
    # a segment with no interior block (one block wide) seeds from its
    # full membership instead of vanishing
    has_interior = counts(seed_lab) > 0
    thin = ~has_interior.gather(-1, torch.clamp(lab_full, 0, P - 1).reshape(B, HW).long())
    thin = thin.reshape(B, h, w) & (lab_full >= 0)
    seed_lab = torch.where(thin & finite, lab_full, seed_lab)

    # plane hypotheses from the cores, each with its 3-sigma band
    nrm, d, _, mse = fit(seed_lab)
    dist_all = torch.abs(
        (pts.reshape(B, HW, 3) @ nrm.transpose(-1, -2)).transpose(-1, -2) + d[..., None]
    ).reshape(B, P, h, w)
    gate = (dist_all * dist_all) < (9.0 * mse + 1e-5)[..., None, None]
    allowed = (gate & (finite & ~interior_img)[:, None]).to(torch.float32)

    # iterated masked dilation through the released pixels
    reach = (seed_lab[:, None] == planes[:, None, None]).to(torch.float32)
    for _ in range(refine_iters):
        nb = torch.maximum(
            F.max_pool2d(reach, (3, 1), 1, (1, 0)), F.max_pool2d(reach, (1, 3), 1, (0, 1))
        )
        reach = torch.maximum(reach, nb * allowed)
    # least distance among the reached planes
    dist_sel = torch.where(reach > 0, dist_all, torch.full_like(dist_all, float("inf")))
    best = torch.argmin(dist_sel, 1).to(torch.int32)
    has = torch.isfinite(torch.amin(dist_sel, 1))
    lab_ref = torch.where(has, best, neg)
    lab_ref = torch.where(interior_img, seed_lab, lab_ref)

    # refit and distance re-gate of the exported membership
    nrm, d, n_ref, _ = fit(lab_ref)
    safe = torch.clamp(lab_ref, min=0).reshape(B, HW).long()
    n_px = nrm.gather(1, safe[..., None].expand(B, HW, 3))
    pix_dist = torch.abs(torch.sum(pts.reshape(B, HW, 3) * n_px, -1) + d.gather(1, safe))
    regate = float(np.float32(dist_th) * np.float32(1.5))
    lab_ref = torch.where((lab_ref >= 0) & (pix_dist.reshape(B, h, w) < regate), lab_ref, neg)

    inlier_frac = n_ref / torch.clamp(counts(lab_full), min=1.0)
    valid = (n_ref > 0) & (inlier_frac > 0.6)
    coeffs = torch.cat([nrm, d[..., None]], -1)
    coeffs = torch.where(coeffs[..., 3:4] < 0, -coeffs, coeffs)  # Plane3D: w >= 0

    # cloud: in each of M buckets of pixels the member of highest hash
    # priority, winners compacted to the front
    n_bkt = max_points
    bkt = -(-HW // n_bkt)
    prio = hash_priorities(HW, dev)
    member = lab_ref.reshape(B, 1, HW) == planes[:, None]
    pr_all = torch.where(member, prio, torch.zeros((), dtype=torch.int32, device=dev))
    pr_all = F.pad(pr_all, (0, n_bkt * bkt - HW)).reshape(B, P, n_bkt, bkt)
    arg = torch.argmax(pr_all, -1)
    val = torch.amax(pr_all, -1)
    sel = torch.clamp(arg + torch.arange(n_bkt, device=dev) * bkt, max=HW - 1)
    ordv, ord_bkt = topk_stable(val, n_bkt)
    sel = sel.gather(-1, ord_bkt).reshape(B, P * n_bkt)
    cloud = pts.reshape(B, HW, 3).gather(1, sel[..., None].expand(B, P * n_bkt, 3))
    cloud = torch.where((ordv > 0).reshape(B, P * n_bkt, 1), cloud, torch.zeros_like(cloud))
    return {
        "membership": lab_ref,
        "coeffs": coeffs,
        "n_support": n_ref,
        "valid": valid,
        "inlier_frac": inlier_frac,
        "n_pts": (val > 0).sum(-1).to(torch.int32),
        "cloud": cloud.reshape(B, P, n_bkt, 3),
    }


def extract_planes_device(
    depth: torch.Tensor,
    K: torch.Tensor,
    max_planes: int,
    max_points: int,
    grid_shape: tuple[int, int],
    min_support: float,
    dist_th: float,
    stride: int = 2,
) -> dict:
    """Frame-plane extraction of one depth image (H, W) or B streams
    (B, H, W), in meters.  Returns membership (.., h, w) int32, coeffs
    (.., P, 4), n_support (.., P) int32, valid (.., P), n_pts (.., P) int32
    and cloud (.., P, M, 3)."""
    single = depth.dim() == 2
    if single:
        depth = depth[None]
    pts = depth_to_points(depth, K, stride)
    st = block_stats(pts)
    labels = merge_blocks_device(st, grid_shape, min_support)
    block_plane = top_segments(labels, st["n"], max_planes).reshape(
        (depth.shape[0],) + tuple(grid_shape))
    out = plane_stage2(pts, block_plane, dist_th, max_planes, max_points)
    n_support = out["n_support"].to(torch.int32)
    res = {
        "membership": out["membership"],
        "coeffs": out["coeffs"],
        "n_support": n_support,
        "valid": out["valid"] & (n_support >= float(np.float32(min_support))),
        "n_pts": out["n_pts"],
        "cloud": out["cloud"],
    }
    return {k: v[0] for k, v in res.items()} if single else res
