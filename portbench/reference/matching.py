"""Descriptor matching as masked dense products: a frozen copy of the
port's ``ops/matching.py`` for the plain reference of the tracking step.

The Hamming distance matrix is one float32 product of the +-1 unpacked
descriptors, ``dist = (256 - a.b) / 2`` (exact: integer sums below 2^24);
the reference's gates are masks: search radius by predicted scale,
TH_HIGH / TH_LOW, best/second-best ratio, rotation-histogram consistency
(HISTO_LENGTH=30, top-3 bins) and one-to-one conflict resolution.

Every function takes one frame's arrays or B streams' arrays with a
leading stream axis (the reference's vmapped replay).  Reductions,
histograms and scatters run along the last axis, so one stream never
reads or writes another's segment.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.orb import unpack_descriptor_bits

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
BIG = 1e9


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, *tail) at row indices idx (..., M) -> (..., M, *tail);
    x and idx have the same leading axes (none, or the stream axis)."""
    axis = idx.dim() - 1
    tail = x.shape[axis + 1 :]
    full = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    return torch.gather(x, axis, full)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) x (..., M, 8) int32 words -> (..., N, M) float32
    Hamming distances."""
    sa = 2.0 * unpack_descriptor_bits(desc_a) - 1.0
    sb = 2.0 * unpack_descriptor_bits(desc_b) - 1.0
    return (256.0 - sa @ sb.transpose(-1, -2)) * 0.5


def rotation_consistency_mask(
    angle_a: torch.Tensor, angle_b: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Keep matches whose angle difference falls in the 3 most populated of
    30 bins (ORBmatcher::ComputeThreeMaxima; bins 2/3 dropped when weaker
    than 0.1 x the first); one histogram per stream."""
    angle_a, angle_b, valid = torch.broadcast_tensors(angle_a, angle_b, valid)
    diff = torch.remainder(angle_a - angle_b, 2.0 * math.pi)
    bins = torch.clamp(
        (diff * (HISTO_LENGTH / (2.0 * math.pi))).to(torch.int64), 0, HISTO_LENGTH - 1
    )
    hist = torch.zeros(valid.shape[:-1] + (HISTO_LENGTH,), dtype=torch.int32, device=valid.device)
    hist = hist.scatter_add(-1, bins, valid.to(torch.int32))
    top3 = torch.topk(hist, 3).values
    thresh = torch.maximum(top3[..., 2], torch.ceil(0.1 * top3[..., 0]).to(torch.int32))
    keep_bin = hist >= torch.clamp(thresh, min=1)[..., None]
    return valid & keep_bin.gather(-1, bins)


def _segment_reduce(values, seg_ids, n_segments: int, fill, reduce: str) -> torch.Tensor:
    """Per-segment `reduce` along the last axis over ids in [0, n_segments)
    (other ids land in a dropped slot); each stream has its own segments."""
    values, seg_ids = torch.broadcast_tensors(values, seg_ids)
    shape = seg_ids.shape[:-1] + (n_segments + 1,)
    out = torch.full(shape, fill, dtype=values.dtype, device=values.device)
    ids = torch.where((seg_ids >= 0) & (seg_ids < n_segments), seg_ids, n_segments)
    out = out.scatter_reduce(-1, ids.long(), values, reduce, include_self=True)
    return out[..., :n_segments]


def segment_min(values, seg_ids, n_segments: int, fill) -> torch.Tensor:
    """Per-segment minimum over ids in [0, n_segments); other ids ignored."""
    return _segment_reduce(values, seg_ids, n_segments, fill, "amin")


def segment_max(values, seg_ids, n_segments: int, fill) -> torch.Tensor:
    """Per-segment maximum over ids in [0, n_segments); other ids ignored."""
    return _segment_reduce(values, seg_ids, n_segments, fill, "amax")


def resolve_one_to_one(
    kp_idx: torch.Tensor, dist: torch.Tensor, valid: torch.Tensor, n_kp: int
) -> torch.Tensor:
    """Keep, per claimed keypoint, only the claimant with minimum distance
    (lowest source index among equals)."""
    d = torch.where(valid, dist, torch.full_like(dist, BIG))
    best_per_kp = segment_min(d, kp_idx, n_kp, BIG)
    src = torch.arange(kp_idx.shape[-1], dtype=torch.int32, device=kp_idx.device)
    kp = kp_idx.long()
    is_best = d <= best_per_kp.gather(-1, kp) + 1e-6
    first_src = segment_min(
        torch.where(valid & is_best, src, 1 << 30), kp_idx, n_kp, 1 << 30
    )
    return valid & is_best & (first_src.gather(-1, kp) == src)


def match_descriptors(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    max_dist: float = TH_LOW,
    ratio: float = 0.0,
    extra_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest-neighbour matching A -> B; returns (idx_b, dist, valid)."""
    d = hamming_matrix(desc_a, desc_b)
    allow = valid_a[..., :, None] & valid_b[..., None, :]
    if extra_mask is not None:
        allow = allow & extra_mask
    d = torch.where(allow, d, torch.full_like(d, BIG))
    best, idx = torch.min(d, dim=-1)
    cols = torch.arange(d.shape[-1], device=d.device)
    second = torch.where(cols == idx[..., None], torch.full_like(d, BIG), d).amin(dim=-1)
    ok = best <= max_dist
    if ratio > 0:
        ok = ok & (best < ratio * second)
    return idx.to(torch.int32), best, ok & valid_a


def project_points(
    T_cw: torch.Tensor, pts_w: torch.Tensor, K: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """World points (..., N, 3) -> (uv (..., N, 2), z (..., N)) in the
    camera of T_cw (..., 4, 4)."""
    pc = pts_w @ T_cw[..., :3, :3].transpose(-1, -2) + T_cw[..., None, :3, 3]
    z = pc[..., 2]
    zi = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = pc[..., 0] / zi * K[0, 0] + K[0, 2]
    v = pc[..., 1] / zi * K[1, 1] + K[1, 2]
    return torch.stack([u, v], -1), z


def search_by_projection(
    pts_w: torch.Tensor,
    descs: torch.Tensor,
    valid_pts: torch.Tensor,
    T_cw: torch.Tensor,
    feats: dict,
    K: torch.Tensor,
    image_hw: tuple[int, int],
    radius: float,
    max_dist: float = TH_HIGH,
    scale_factor: float = 1.2,
    point_levels: torch.Tensor | None = None,
    level_tolerance: int = 1,
    max_depth_ratio: tuple[torch.Tensor, torch.Tensor] | None = None,
    view_dirs: torch.Tensor | None = None,
    cand_cap: int = 4096,
) -> dict:
    """Project one frame's landmark bank (N, ...) and match within a pixel
    radius (ORBmatcher::SearchByProjection, ORBmatcher.cc:40-117 and
    :548-678).  Gates: positive depth, in-image, the per-level radius
    radius * scale^level, a level difference of at most level_tolerance,
    optionally the scale-distance band and the viewing cosine.  The gated
    landmarks, in bank order, are compacted to cand_cap candidates first.

    Returns kp_idx, dist, valid (N,), proj_uv, z at bank level and the
    candidate-space results c_bank, c_kp, c_dist, c_ok (cand_cap,)."""
    h, w = image_hw
    uv, z = project_points(T_cw, pts_w, K)
    in_img = (z > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    gate = valid_pts & in_img
    cam_center = -T_cw[:3, :3].T @ T_cw[:3, 3]
    if max_depth_ratio is not None:
        min_d, max_d = max_depth_ratio
        dist_w = torch.linalg.norm(pts_w - cam_center[None], dim=-1)
        gate = gate & (dist_w >= min_d) & (dist_w <= max_d)
    if view_dirs is not None:
        po = pts_w - cam_center[None]
        pn = po / torch.linalg.norm(po, dim=-1, keepdim=True).clamp(min=1e-9)
        gate = gate & (torch.sum(pn * view_dirs, -1) > 0.5)
    N = pts_w.shape[0]
    dev = pts_w.device
    if point_levels is None:
        point_levels = torch.zeros(N, dtype=torch.int32, device=dev)
    rad = radius * torch.pow(scale_factor, point_levels.to(torch.float32))

    # frustum compaction: the first cand_cap gated landmarks, in bank order
    CAND = min(cand_cap, N)
    if CAND < N:
        rank = torch.cumsum(gate.to(torch.int64), 0) - 1
        slot = torch.where(gate & (rank < CAND), rank, CAND)
        cand_idx = torch.zeros(CAND + 1, dtype=torch.int64, device=dev).scatter(
            0, slot, torch.arange(N, device=dev))[:CAND]
        cand_valid = torch.zeros(CAND + 1, dtype=torch.bool, device=dev).scatter(
            0, slot, gate)[:CAND]
    else:
        cand_idx = torch.arange(N, device=dev)
        cand_valid = gate
    c_uv, c_rad, c_lvl = uv[cand_idx], rad[cand_idx], point_levels[cand_idx]
    duv = feats["xy_und"][None, :, :] - c_uv[:, None, :]
    pix_ok = (duv[..., 0].abs() <= c_rad[:, None]) & (duv[..., 1].abs() <= c_rad[:, None])
    pix_ok = pix_ok & ((feats["level"][None, :] - c_lvl[:, None]).abs() <= level_tolerance)
    idx, dist, ok = match_descriptors(descs[cand_idx], feats["desc"], cand_valid, feats["valid"],
                                      max_dist=max_dist, extra_mask=pix_ok)
    ok = resolve_one_to_one(idx, dist, ok, feats["desc"].shape[0])
    # candidate results back at bank level (unfilled slots point at N,
    # dropped)
    tgt = torch.where(cand_valid, cand_idx, N)
    kp_idx = torch.zeros(N + 1, dtype=torch.int32, device=dev).scatter(0, tgt, idx)[:N]
    dist_b = torch.full((N + 1,), BIG, dtype=dist.dtype, device=dev).scatter(0, tgt, dist)[:N]
    ok_b = torch.zeros(N + 1, dtype=torch.bool, device=dev).scatter(0, tgt, ok)[:N]
    return {
        "kp_idx": kp_idx, "dist": dist_b, "valid": ok_b, "proj_uv": uv, "z": z,
        "c_bank": tgt.to(torch.int32), "c_kp": idx, "c_dist": dist, "c_ok": ok,
    }


def predict_scale_level(
    dist_w: torch.Tensor, max_dist: torch.Tensor, scale_factor: float, n_levels: int
) -> torch.Tensor:
    """MapPoint::PredictScale: level = ceil(log(maxDist/dist)/log(scale))."""
    ratio = torch.clamp(max_dist / dist_w.clamp(min=1e-6), min=1.0)
    log_s = math.log(float(np.float32(scale_factor)))  # ln of the float32 factor
    lvl = torch.ceil(torch.log(ratio) / log_s).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)


def frustum_candidates(
    pts: dict,
    T_seed: torch.Tensor,
    K: torch.Tensor,
    image_hw: tuple[int, int],
    cand_cap: int,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    use_scale_gate: bool = False,
    margin: float = 64.0,
) -> dict:
    """Pose-seeded frustum compaction of a landmark bank, shared by every
    solve of a frame: the gated rows in bank order, padded to cand_cap,
    plus `visible_bank`, the bank-level frustum mask.  pts: (..., N, ...)
    rows, T_seed (..., 4, 4): one compaction per stream."""
    N = pts["pos"].shape[-2]
    h, w = image_hw
    uv, z = project_points(T_seed, pts["pos"], K)
    gate = (
        pts["valid"]
        & (z > 0.05)
        & (uv[..., 0] >= -margin) & (uv[..., 0] < w + margin)
        & (uv[..., 1] >= -margin) & (uv[..., 1] < h + margin)
    )
    R_t = T_seed[..., :3, :3].transpose(-1, -2)
    cam_center = -(R_t @ T_seed[..., :3, 3:4])[..., 0]
    if use_scale_gate and "max_dist" in pts:
        po = pts["pos"] - cam_center[..., None, :]
        dist_w = torch.linalg.norm(po, dim=-1)
        levels = predict_scale_level(dist_w, pts["max_dist"], scale_factor, n_levels)
        gate = gate & (dist_w >= pts["min_dist"] * 0.8) & (dist_w <= pts["max_dist"] * 1.2)
        if "normal" in pts:
            pn = po / torch.linalg.norm(po, dim=-1, keepdim=True).clamp(min=1e-9)
            gate = gate & (torch.sum(pn * pts["normal"], -1) > 0.5)
    else:
        levels = pts.get("level", torch.zeros_like(gate, dtype=torch.int32))

    CAND = min(cand_cap, N)
    if CAND < N:
        # gated rows first, in bank order (rank scores are distinct)
        score = torch.where(
            gate, N - torch.arange(N, dtype=torch.int32, device=gate.device), 0
        )
        cand_idx = torch.topk(score, CAND).indices
    else:
        cand_idx = torch.arange(N, device=gate.device).expand(gate.shape)
    out = {
        "bank_idx": cand_idx.to(torch.int32),
        "valid": gate.gather(-1, cand_idx),
        "pos": take_rows(pts["pos"], cand_idx),
        "desc": take_rows(pts["desc"], cand_idx),
        "level": levels.gather(-1, cand_idx),
        "visible_bank": gate,
    }
    if "rot_gate" in pts:
        out["rot_gate"] = pts["rot_gate"].gather(-1, cand_idx)
        out["angle"] = pts["angle"].gather(-1, cand_idx)
    return out
