"""The fused per-frame device step (counterpart of
manhattanslam_tpu/frontend/device_tracker.py).

One call per frame runs on the device with no host round trip inside:

  extract ORB -> one frustum compaction of the landmark bank
    -> three candidate solves as ONE batched LM problem: projection
       (r=7) and its widened retry (r=14) from the motion-model seed, and
       descriptor matching against the reference keyframe from the last
       pose -> device-side selection of the initial pose
    -> planes (enable_planes): extraction, association with the map
       planes at the seed pose, Manhattan-frame detection against the
       registries, and the translation-only re-solve under the Manhattan
       rotation with its reference-keyframe descriptor fallback, both as
       one batched solve
    -> lines (enable_lines): Hough detection, band descriptors, lifting
       to 3D, and association with the map lines at the initial pose
    -> final 4-round solve (r=4) with the line and plane residuals ->
       polar re-orthonormalization -> the success gate over point, line
       and plane inliers -> keyframe-policy counts and the next carry

The reference chooses between branches with ``lax.cond``; here every
branch is computed for every stream and selected with ``torch.where``, so
nothing in the step waits on the host.  The map view (landmarks, map
planes and lines, keyframe plane observations and poses, the Manhattan
registries and the reference keyframe's banks) lives on the device and is
updated in place only at keyframe events, from a row diff of two host
snapshots.

The body is written once, for B streams that share one map view
(``build_batched_body``, the batched replay of parallel/mesh.py);
the single-stream body is its B = 1 case.  The frame step also packs what
the host reads into flat float32 buffers (``add_flats``), so a frame
costs one device-to-host copy (``pull_summary``), and
``build_chunk_step`` runs C frames through it against one view, counting
the landmark statistics on the device, for one copy per chunk
(``pull_chunk_summary``); a keyframe's extras and payload are pulled
lazily (``pull_kfx``, ``pull_payload``).  On the card the frame step runs
from a CUDA graph (frontend/graphed_step.py), so nothing here may replace
a tensor the graph reads: the view and the carry are written in place.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend import tracking_ops
from manhattanslam_tpu_torch.frontend.frame import build_extractor
from manhattanslam_tpu_torch.frontend.graphed_step import copy_tree_
from manhattanslam_tpu_torch.geometry import se3
from manhattanslam_tpu_torch.ops import lines as line_ops
from manhattanslam_tpu_torch.ops import lm, matching
from manhattanslam_tpu_torch.ops import planes as plane_ops

DEPTH_QUANT = 5000.0  # 0.2 mm steps, 13.1 m range (TUM DepthMapFactor)
CAND_CAP = 2048  # frustum candidates shared by the frame's solves


def to_native(gray: np.ndarray, depth: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host side: a frame as sensor-native u8 gray and u16 depth in
    DEPTH_QUANT units (a no-op for TUM's PNG dtypes); the device converts.
    The same quantization as the reference's frame upload."""
    if gray.dtype != np.uint8:
        gray = np.clip(np.round(gray), 0, 255).astype(np.uint8)
    if depth.dtype != np.uint16:
        depth = np.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)
        depth = np.clip(np.round(depth * DEPTH_QUANT), 0, 65535).astype(np.uint16)
    return gray, depth


def depth_in_metres(depth: np.ndarray) -> np.ndarray:
    """A host depth frame as float32 metres: uint16 frames are in
    1/DEPTH_QUANT m and scaled as the step scales them (frame_to_float);
    float frames pass through."""
    if depth.dtype == np.uint16:
        return depth.astype(np.float32) * np.float32(1.0 / DEPTH_QUANT)
    return np.asarray(depth, np.float32)


# ---------------------------------------------------------------- map view
# groups of view keys that share one leading row index
_VIEW_GROUPS = {
    "mp": ("mp_pos", "mp_desc", "mp_valid", "mp_normal", "mp_min", "mp_max", "mp_level"),
    "pl": ("pl_coeffs", "pl_pts", "pl_npts", "pl_valid"),
    "ml": ("ml_sp", "ml_ep", "ml_desc", "ml_valid"),
    "kf": ("kf_pl_idx", "kf_plane_coeffs", "kf_plane_npts", "kf_pose"),
}
_VIEW_FULL_KEYS = ("ref_desc", "ref_angle", "ref_mp", "reg2")


def empty_registries(cfg: SlamConfig) -> tuple[np.ndarray, np.ndarray]:
    """The Manhattan registries as dense id matrices, all -1: reg2
    (M, M) and reg3 (M, M, M) hold, for each pair or triple of map planes,
    the keyframe that saw them mutually perpendicular."""
    M = cfg.caps.max_map_planes
    return np.full((M, M), -1, np.int32), np.full((M, M, M), -1, np.int32)


def build_host_view(cfg: SlamConfig, slam_map, ref_kf: int = 0, reg2=None, reg3=None) -> dict:
    """The tracking-relevant map state as one host dict of array copies
    (a frozen snapshot that doubles as the shadow for incremental diffs)."""
    m = slam_map
    e2, e3 = empty_registries(cfg) if reg2 is None or reg3 is None else (None, None)
    return {
        # landmarks (identity mapping: view index == map point id)
        "mp_pos": m.mp_pos.copy(),
        "mp_desc": m.mp_desc.copy(),
        "mp_valid": m.mp_valid.copy(),
        "mp_normal": m.mp_normal.copy(),
        "mp_min": m.mp_min_dist.copy(),
        "mp_max": np.maximum(m.mp_max_dist, 1e-6),
        "mp_level": m.mp_level.copy(),
        # planes
        "pl_coeffs": m.pl_coeffs.copy(),
        "pl_pts": m.pl_pts.copy(),
        "pl_npts": m.pl_n_pts.copy(),
        "pl_valid": m.pl_valid.copy(),
        # lines (the descriptor's first DESC_DIM columns)
        "ml_sp": m.ml_sp.copy(),
        "ml_ep": m.ml_ep.copy(),
        "ml_desc": m.ml_desc[:, : line_ops.DESC_DIM].copy(),
        "ml_valid": m.ml_valid.copy(),
        # keyframe plane observations and poses (Manhattan MFm)
        "kf_pl_idx": m.kf_pl_idx.copy(),
        "kf_plane_coeffs": m.kf_plane_coeffs.copy(),
        "kf_plane_npts": m.kf_plane_npts.copy(),
        "kf_pose": m.kf_pose.copy(),
        # ref-KF landmark view (descriptor candidate)
        "ref_desc": m.kf_desc[ref_kf].copy(),
        "ref_angle": m.kf_angle[ref_kf].copy(),
        "ref_mp": m.kf_mp_idx[ref_kf].copy(),
        # Manhattan registries
        "reg2": e2 if reg2 is None else reg2.copy(),
        "reg3": e3 if reg3 is None else reg3.copy(),
    }


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device` (a copy: never aliases the
    host array).  To CUDA it goes through pinned memory without blocking
    the host: the copy is ordered on the current stream, after the work
    enqueued before it."""
    if a.dtype == np.uint32:  # descriptor words: same bits as int32
        a = a.view(np.int32)
    t = torch.from_numpy(np.array(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def upload_view(host: dict, device) -> dict:
    return {k: to_device(v, device) for k, v in host.items()}


def build_map_view(cfg: SlamConfig, slam_map, device) -> dict:
    """Upload the tracking-relevant map state with an empty ref-KF bank."""
    host = build_host_view(cfg, slam_map, ref_kf=0)
    host["ref_desc"] = host["ref_desc"] * 0
    host["ref_angle"] = host["ref_angle"] * 0.0
    host["ref_mp"] = np.full_like(host["ref_mp"], -1)
    return upload_view(host, device)


def set_ref_kf(view: dict, slam_map, ref_kf: int) -> dict:
    """Copy keyframe `ref_kf`'s banks into the view's ref-KF banks, in
    place (a graph that reads the view keeps reading the same tensors);
    returns the view."""
    m = slam_map
    dev = view["mp_pos"].device
    view["ref_desc"].copy_(to_device(m.kf_desc[ref_kf], dev))
    view["ref_angle"].copy_(to_device(m.kf_angle[ref_kf], dev))
    view["ref_mp"].copy_(to_device(m.kf_mp_idx[ref_kf], dev))
    return view


def _changed_rows(shadow: np.ndarray, host: np.ndarray) -> np.ndarray:
    n = host.shape[0]
    return np.nonzero((shadow.reshape(n, -1) != host.reshape(n, -1)).any(axis=1))[0]


def diff_host_views(shadow: dict, host: dict) -> list[dict]:
    """Row-level diff of two host views -> [] or one update dict: the
    changed rows of each group ("<group>_idx" + those rows of each of its
    keys), the changed reg3 entries ("reg3_idx" into the flat registry,
    "reg3_val") and the full keys whole.  A keyframe event touches a
    handful of rows and registry entries, so reg3 (1 MiB at 64 map
    planes) never crosses whole after the first upload."""
    rows = {
        g: np.unique(np.concatenate([_changed_rows(shadow[k], host[k]) for k in keys]))
        for g, keys in _VIEW_GROUPS.items()
    }
    r3 = np.nonzero(shadow["reg3"].ravel() != host["reg3"].ravel())[0]
    full = any(not np.array_equal(shadow[k], host[k]) for k in _VIEW_FULL_KEYS)
    if not full and len(r3) == 0 and not any(len(r) for r in rows.values()):
        return []
    upd = {}
    for g, keys in _VIEW_GROUPS.items():
        upd[g + "_idx"] = rows[g].astype(np.int64)
        for k in keys:
            upd[k] = host[k][rows[g]]
    upd["reg3_idx"] = r3.astype(np.int64)
    upd["reg3_val"] = host["reg3"].ravel()[r3]
    for k in _VIEW_FULL_KEYS:
        upd[k] = host[k]
    return [upd]


def noop_view_update(host: dict) -> dict:
    """An update that changes nothing: no rows, no registry entries, the
    full keys as `host` holds them (``apply_view_update([...])`` of it
    leaves a view of `host` as it was)."""
    upd = {}
    for g, keys in _VIEW_GROUPS.items():
        upd[g + "_idx"] = np.zeros(0, np.int64)
        for k in keys:
            upd[k] = host[k][:0]
    upd["reg3_idx"] = np.zeros(0, np.int64)
    upd["reg3_val"] = host["reg3"].ravel()[:0]
    for k in _VIEW_FULL_KEYS:
        upd[k] = host[k]
    return upd


def apply_view_update(view: dict, updates: list[dict]) -> dict:
    """Scatter the changed rows and registry entries into the device view
    and copy the full keys over, all IN PLACE (the view's storage is
    reused, as the reference donates it, and a graph that reads the view
    keeps reading the same tensors)."""
    for upd in updates:
        dev = view["mp_pos"].device
        for g, keys in _VIEW_GROUPS.items():
            if len(upd[g + "_idx"]) == 0:
                continue
            idx = to_device(upd[g + "_idx"], dev)
            for k in keys:
                view[k].index_copy_(0, idx, to_device(upd[k], dev))
        if len(upd["reg3_idx"]):
            view["reg3"].view(-1).index_copy_(
                0, to_device(upd["reg3_idx"], dev), to_device(upd["reg3_val"], dev))
        for k in _VIEW_FULL_KEYS:
            view[k].copy_(to_device(upd[k], dev))
    return view


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


# ------------------------------------------------------------------ carry
def init_carry(
    cfg: SlamConfig, device, T0: np.ndarray | None = None, vo_points: bool = False
) -> dict:
    """The per-frame device carry: last pose, velocity and the previous
    frame's keypoints (the temporal VO bank, UpdateLastFrame)."""
    n_kp = cfg.caps.max_keypoints
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "T_last": (
            torch.as_tensor(T0, **f32) if T0 is not None else torch.eye(4, **f32)
        ),
        "velocity": torch.eye(4, **f32),
        "have_velocity": torch.tensor(False, device=device),
        # the VO bank engages only while map coverage is starved
        # (map_inl_last < 30 in the step)
        "vo_points": torch.tensor(bool(vo_points), device=device),
        "map_inl_last": torch.tensor(0, dtype=torch.int32, device=device),
        "prev_xy_und": torch.zeros((n_kp, 2), **f32),
        "prev_depth": torch.zeros(n_kp, **f32),
        "prev_desc": torch.zeros((n_kp, 8), dtype=torch.int32, device=device),
        "prev_level": torch.zeros(n_kp, dtype=torch.int32, device=device),
        "prev_angle": torch.zeros(n_kp, **f32),
        "prev_valid": torch.zeros(n_kp, dtype=torch.bool, device=device),
    }


def reset_carry_(carry: dict, cfg: SlamConfig, T0: np.ndarray | None = None,
                 vo_points: bool = False) -> dict:
    """Set `carry` to ``init_carry``'s values IN PLACE (a graph that reads
    the carry keeps reading the same tensors); returns it."""
    copy_tree_(carry, init_carry(cfg, carry["T_last"].device, T0, vo_points))
    return carry


# --------------------------------------------------------------- the step
def _f32(x) -> float:
    """A threshold as the float32 value the reference compares with."""
    return float(np.float32(x))


def build_batched_body(
    cfg: SlamConfig, device, enable_planes: bool = False, enable_lines: bool = False
):
    """Returns body(gray (B,H,W) f32, depth (B,H,W) f32 m, carry, view) ->
    (result, new_carry) for B independent streams that share one map view
    (the reference's ``jax.vmap(body, in_axes=(0, 0, None))``): every
    carry and result tensor has a leading stream axis B, the view none.
    The streams run as one batch per op (no loop over streams), so a step
    launches the same kernels whatever B is.  enable_planes adds the plane
    and Manhattan branch, enable_lines the line branch; with both, the
    body is the reference's ``build_frame_body`` at its defaults."""
    device = torch.device(device)
    extract = build_extractor(cfg, device)
    params = lm.default_params(cfg)
    K = torch.from_numpy(cfg.camera.K).to(device)
    bf = float(cfg.camera.bf)
    hw = (cfg.camera.height, cfg.camera.width)
    sf = cfg.orb.scale_factor
    nl = cfg.orb.n_levels
    sf_t = torch.tensor(sf, dtype=torch.float32, device=device)
    close_th = _f32(cfg.th_depth_m)
    P = cfg.caps.max_planes_frame
    h2, w2 = cfg.camera.height // 2, cfg.camera.width // 2
    grid_shape = (h2 // plane_ops.BLOCK, w2 // plane_ops.BLOCK)
    min_support = _f32(0.04 * h2 * w2)
    pc = cfg.plane
    lc = cfg.line

    def body(gray, depth, carry, view):
        B = gray.shape[0]

        def shared(x):  # the one view, broadcast to the B streams (no copy)
            return x.expand((B,) + x.shape)

        feats = extract(gray, depth)
        T_last = carry["T_last"]
        have_vel = carry["have_velocity"]
        T_seed = torch.where(have_vel[:, None, None], carry["velocity"] @ T_last, T_last)

        # temporal landmarks: the previous frame's keypoints with depth,
        # back-projected with the previous pose (TrackWithMotionModel /
        # UpdateLastFrame), appended to each stream's landmark bank
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
            # rotation-histogram gate on the temporal block only
            "angle": torch.cat([torch.zeros((B, n_map), device=device), carry["prev_angle"]], 1),
            "rot_gate": torch.cat(
                [torch.zeros((B, n_map), dtype=torch.bool, device=device), vo_valid], 1
            ),
        }
        # ONE frustum compaction per stream, shared by every solve of the frame
        cand = matching.frustum_candidates(
            mp_view, T_seed, K, hw, CAND_CAP, scale_factor=sf, n_levels=nl,
            use_scale_gate=True,
        )

        # candidate solves as one batch of 3B keypoint-indexed problems:
        # motion-model projection (r=7), reference-KF descriptors, and the
        # widened projection retry (r=14) that the reference runs when the
        # motion model matched fewer than 20 points
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

        no = torch.zeros(B, dtype=torch.bool, device=device)
        man_found = use_manh = no
        plane_obs, T_mid, plane_out = None, T_init, {}
        if enable_planes:
            # planes, associated at the motion-model seed pose: the
            # reference runs SearchMapByCoefficients before any point
            # solve (Tracking.cc:253)
            planes = plane_ops.extract_planes_device(
                depth, K, P, cfg.caps.max_plane_points, grid_shape, min_support,
                _f32(pc.distance_threshold),
            )
            assoc, par, ver = associate_planes_device(
                planes["coeffs"], planes["valid"], T_seed, view,
                _f32(pc.association_ang_ref), _f32(pc.association_dis_ref),
                _f32(pc.vertical_threshold), _f32(pc.parallel_threshold),
            )
            man_R, man_found = detect_manhattan_device(
                planes["coeffs"], planes["n_support"], planes["valid"], assoc, view,
                _f32(pc.mf_vertical_threshold),
            )
            plane_obs = build_plane_obs_device(planes["coeffs"], assoc, par, ver, view)

            # the Manhattan decoupled translation-only re-solve from the
            # Manhattan rotation (Tracking.cc:846-944): by projection
            # (r=7) and, for the reference's fallback when that finds
            # fewer than 7 inliers, by descriptors against the reference
            # keyframe; both solved for every stream as one batch of 2B
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
            # nmatchesMap >= 7 (TranslationEstimation, Tracking.cc:941)
            ok_t = n_t >= 7
            fallback = man_found & ~ok_t
            use_manh = man_found & (ok_t | (fallback & (n_t2 >= 7)))
            T_man = torch.where(ok_t[:, None, None], T_t, T_t2)
            T_mid = torch.where(use_manh[:, None, None], T_man, T_init)
            plane_out = {
                "new_plane": (planes["valid"] & (assoc < 0)).any(-1),
                "plane_coeffs": planes["coeffs"],
                "plane_valid": planes["valid"],
                "plane_support": planes["n_support"],
                "plane_assoc": assoc,
                "plane_membership": planes["membership"],
                "plane_cloud": planes["cloud"],
                "plane_npts": planes["n_pts"],
            }

        line_obs, line_out = None, {}
        if enable_lines:
            # lines, associated at the initial pose (the candidate solves'
            # pick), enter the final solve only
            det = line_ops.detect_lines(
                gray, cfg.caps.max_lines, lc.mag_threshold, float(lc.min_support),
                lc.min_density, lc.min_length,
            )
            ldesc = line_ops.line_descriptors(gray, det["sp"], det["ep"])
            lifted = line_ops.lift_lines_3d(depth, K, det["sp"], det["ep"], det["valid"])
            l_assoc, ml_visible = associate_lines_device(
                det, ldesc, T_init, view, K, hw, mid_px=lc.assoc_mid_px, ang_deg=lc.assoc_ang_deg,
            )
            line_obs = build_line_obs_device(det, l_assoc, view)
            line_out = {
                "line_sp": det["sp"],
                "line_ep": det["ep"],
                "line_valid": det["valid"],
                "line_desc": ldesc,
                "line_sp3": lifted["sp3"],
                "line_ep3": lifted["ep3"],
                "line_has3d": lifted["ok"],
                "line_assoc": l_assoc,
                "ml_visible": ml_visible,
            }

        # final solve with the line and plane residuals: 4 chi2-gated
        # rounds of 5 LM iterations
        out_f = tracking_ops.track_projection(
            mp_view, T_mid, feats, K, bf, 4.0, hw, cand, scale_factor=sf,
            n_rounds=4, n_iters=5, bank_stats=True, plane_obs=plane_obs, params=params,
            use_planes=enable_planes, line_obs=line_obs, use_lines=enable_lines,
        )
        # one polar projection per frame pins the rotation block's f32
        # non-orthonormal drift (velocity @ T_last compounds it)
        T_final = out_f["T"].clone()
        T_final[:, :3, :3] = se3.polar_rotation(T_final[:, :3, :3], iters=2)
        # success gate: points, lines (with an inlier endpoint) and planes
        # together pass at >= 7 (Tracking.cc:1423-1429), with the
        # reference's extra n_pt_f >= 7 (device_tracker.py:887) kept for
        # parity
        n_pt_f = out_f["n_pt_inliers"].to(torch.int32)
        n_ln_f = (out_f["inlier_ln"].unflatten(-1, (-1, 2)).any(-1).sum(-1).to(torch.int32)
                  if enable_lines else None)
        n_pl_f = out_f["inlier_pl"].sum(-1).to(torch.int32) if enable_planes else None
        structural = [n for n in (n_ln_f, n_pl_f) if n is not None]
        n_inl = sum(structural, n_pt_f)
        # a pose comes from a candidate solve or from the Manhattan path
        reachable = init_ok | use_manh if enable_planes else init_ok
        tracked_ok = reachable & (n_pt_f >= 7) & (n_inl >= 7)
        ok3 = tracked_ok[:, None, None]

        # matches to the temporal block (bank index >= n_map) count as
        # inliers but are not map associations
        kp_mp_ext = out_f["kp_mp"]
        kp_mp = torch.where(kp_mp_ext >= n_map, -1, kp_mp_ext)
        n_map_inliers = sum(structural, (kp_mp >= 0).sum(-1).to(torch.int32))
        close = feats["valid"] & (feats["depth"] > 0) & (feats["depth"] < close_th)
        kp_matched = kp_mp >= 0

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
        result = {
            "T": T_final,
            "tracked_ok": tracked_ok,
            "n_inliers": n_inl,
            "n_map_inliers": n_map_inliers,
            "n_matches": out_f["n_matches"],
            "tracked_close": (close & kp_matched).sum(-1),
            "nontracked_close": (close & ~kp_matched).sum(-1),
            "manhattan_found": man_found,
            "use_manhattan": use_manh,
            "kp_mp": kp_mp,
            "matched": out_f["matched"][:, :n_map],
            "visible": out_f["visible"][:, :n_map],
            "feats": feats,
            **plane_out,
            **line_out,
        }
        return result, new_carry

    return body


def _first_stream(tree: dict) -> dict:
    return {k: _first_stream(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def build_frame_body(
    cfg: SlamConfig, device, enable_planes: bool = False, enable_lines: bool = False
):
    """Returns body(gray (H,W) f32, depth (H,W) f32 m, carry, view) ->
    (result, new_carry), every tensor on `device`: the batched body at
    B = 1, with the stream axis added to the inputs and taken off the
    outputs, and the host's flat buffers (``add_flats``) in the result."""
    batched = build_batched_body(cfg, device, enable_planes, enable_lines)

    def body(gray, depth, carry, view):
        result, new_carry = batched(
            gray[None], depth[None], {k: v[None] for k, v in carry.items()}, view
        )
        add_flats(result, lead=1)
        return _first_stream(result), _first_stream(new_carry)

    return body


def frame_to_float(gray8: torch.Tensor, d16: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sensor-native frames (u8 gray, depth in DEPTH_QUANT units, any
    leading axes) -> float32 gray and depth in meters, on their device."""
    inv_q = float(np.float32(1.0 / DEPTH_QUANT))
    return gray8.to(torch.float32), d16.to(torch.float32) * inv_q


def build_frame_step(
    cfg: SlamConfig, device, enable_planes: bool = False, enable_lines: bool = False
):
    """Returns step(gray8 (H,W) uint8, d16 (H,W) int32 in DEPTH_QUANT
    units, carry, view) -> (result, new_carry): the frame's device program."""
    body = build_frame_body(cfg, device, enable_planes, enable_lines)

    def step(gray8, d16, carry, view):
        return body(*frame_to_float(gray8, d16), carry, view)

    return step




# ------------------------------------------------------------ frame packing
def pack_frame(gray: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """Host side: gray (H,W) float or uint8 + depth (H,W) float32 meters
    (or uint16 already in DEPTH_QUANT units) -> one (H, 3W) uint8 buffer
    [gray | depth low byte | depth high byte], the reference's planar
    upload layout."""
    gray, d16 = to_native(gray, depth)
    return np.concatenate(
        [gray, (d16 & 0xFF).astype(np.uint8), (d16 >> 8).astype(np.uint8)], axis=1)


def unpack_frame(packed: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Device side inverse of ``pack_frame`` -> (gray f32, depth f32 m)."""
    gray = packed[..., :w].to(torch.float32)
    lo = packed[..., w: 2 * w].to(torch.float32)
    hi = packed[..., 2 * w:].to(torch.float32)
    return gray, (lo + 256.0 * hi) * float(np.float32(1.0 / DEPTH_QUANT))


# ------------------------------------------------------------- flat buffers
# What the host reads crosses to it as flat float32 buffers, one transfer
# each (the reference's summary_flat, core_flat, kfx_flat, payload_flat).
# CORE: every frame's scalars (chunk mode pulls these for every frame);
# KFX: the keyframe extras, read only for a frame that becomes a keyframe;
# the wide landmark masks ride bit-packed in the per-frame summary, or
# are accumulated on the device over a chunk (STAT_KEYS).  Keys of a
# branch that is off are left out.
CORE_KEYS = (
    "T", "tracked_ok", "n_inliers", "n_map_inliers", "n_matches",
    "tracked_close", "nontracked_close", "manhattan_found", "use_manhattan", "new_plane",
)
KFX_KEYS = ("kp_mp", "plane_assoc", "plane_valid", "line_assoc")
STAT_KEYS = ("mp_visible", "mp_found", "ml_visible", "ml_found")
PACKED_KEYS = ("matched", "visible", "ml_visible")
# keyframe payloads of the branches (after the features, which go in
# sorted-key order without the descriptors)
PAYLOAD_KEYS = (
    "plane_coeffs", "plane_valid", "plane_support", "plane_cloud", "plane_npts",
    "line_sp3", "line_ep3", "line_has3d", "line_valid", "line_desc", "line_assoc",
)
# what a frame's output slot keeps (frame step / chunk step): the flat
# buffers and the features (the relocalizer's input, the payload's
# descriptors); a chunk also keeps each frame's plane membership image,
# as the reference's does for its surfel mapper (a frame's slot keeps it
# only for the surfel arm, FastTracker.keep_membership)
FRAME_KEEP = ("summary_flat", "payload_flat", "feats")
CHUNK_KEEP = ("core_flat", "kfx_flat", "payload_flat", "plane_membership", "feats")


def pack_bool_bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., N) bool -> (..., N // 8) uint8, little-endian bit order."""
    n = mask.shape[-1]
    m = mask.reshape(mask.shape[:-1] + (n // 8, 8)).to(torch.int32)
    shift = torch.arange(8, dtype=torch.int32, device=mask.device)
    return (m << shift).sum(-1).to(torch.uint8)


def _kind(t: torch.Tensor) -> str:
    if t.dtype == torch.bool:
        return "b"
    return "f" if t.dtype.is_floating_point else "i"


def flat_layouts(result: dict, lead: int = 0) -> dict[str, tuple]:
    """The layout of each flat buffer of a step result whose tensors carry
    `lead` leading axes: {name: ((key, shape, kind), ...)}, kind "f"
    float, "i" integer, "b" bool, "bits" a bit-packed bool mask (shape in
    bytes)."""
    def lay(keys, src=None):
        src = src if src is not None else result
        return tuple((k, tuple(src[k].shape[lead:]), _kind(src[k])) for k in keys if k in src)

    core = lay(CORE_KEYS)
    kfx = lay(KFX_KEYS)
    bits = tuple((k, (result[k].shape[-1] // 8,), "bits") for k in PACKED_KEYS if k in result)
    feats = result["feats"]
    return {
        "core": core, "kfx": kfx, "summary": core + kfx + bits,
        "payload": lay(sorted(k for k in feats if k != "desc"), feats) + lay(PAYLOAD_KEYS),
    }


def _flat(result: dict, layout: tuple, lead: int) -> torch.Tensor:
    src = {**result["feats"], **result}  # the feature keys are not result keys
    parts = []
    for k, _, kind in layout:
        t = pack_bool_bits(src[k]) if kind == "bits" else src[k]
        parts.append(t.reshape(t.shape[:lead] + (-1,)).to(torch.float32))
    return torch.cat(parts, -1)


def add_flats(result: dict, lead: int = 0) -> dict:
    """Add the host's flat float32 buffers to a step result (in place):
    ``summary_flat`` (everything the host state machine reads every frame,
    landmark masks bit-packed), ``core_flat`` and ``kfx_flat`` (the chunk
    path's two tiers) and ``payload_flat`` (a keyframe's features without
    descriptors, planes and lines).  Integers up to 2**24 are exact in
    float32; map ids stay below that."""
    for name, layout in flat_layouts(result, lead).items():
        result[name + "_flat"] = _flat(result, layout, lead)
    return result


def unpack_flat(flat: np.ndarray, layout: tuple) -> dict:
    """A host flat buffer (..., N) -> {key: array (..., *shape)} with the
    layout's kinds (int32, bool, float32)."""
    lead = flat.shape[:-1]
    out, off = {}, 0
    for k, shp, kind in layout:
        n = math.prod(shp)
        v = flat[..., off: off + n]
        off += n
        if kind == "bits":
            out[k] = np.unpackbits(np.rint(v).astype(np.uint8), axis=-1, bitorder="little") > 0
            continue
        v = v.reshape(lead + shp)
        out[k] = v > 0.5 if kind == "b" else (
            np.rint(v).astype(np.int32) if kind == "i" else v.astype(np.float32))
    return out


def layout_size(layout: tuple) -> int:
    return sum(math.prod(shp) for _, shp, _ in layout)


# ------------------------------------------------------------- host copies
class HostPull:
    """Device -> host copies of tensors into pinned memory without
    blocking, behind one CUDA event (on `stream`, the current one by
    default); ``wait()`` returns them as numpy.  Tensors on the CPU are
    copied at once."""

    def __init__(self, tensors: list[torch.Tensor], stream=None):
        self.event = None
        if tensors[0].device.type != "cuda":
            self.host = [t.detach().numpy().copy() for t in tensors]
            return
        stream = stream or torch.cuda.current_stream(tensors[0].device)
        with torch.cuda.stream(stream):
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(stream)

    def wait(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
            self.host = [h.numpy() for h in self.host]
        return self.host


def pull_summary(result: dict, layout: tuple | None = None, pulled: HostPull | None = None) -> dict:
    """What the host state machine reads every frame, as numpy, in ONE
    device -> host transfer of ``summary_flat`` (or from `pulled`, that
    transfer started earlier)."""
    layout = layout if layout is not None else flat_layouts(result)["summary"]
    pulled = pulled if pulled is not None else HostPull([result["summary_flat"]])
    return unpack_flat(pulled.wait()[0], layout)


def pull_payload(result: dict, idx: int | None = None, layout: tuple | None = None,
                 stream=None) -> dict:
    """A keyframe's payload: one flat buffer and the descriptors, copied
    behind one event (chunk mode: frame `idx` of the chunk).  Returns
    {"feats": the features with uint32 descriptors, plane and line keys}."""
    layout = layout if layout is not None else flat_layouts(result)["payload"]
    flat, desc = result["payload_flat"], result["feats"]["desc"]
    if idx is not None:
        flat, desc = flat[idx], desc[idx]
    flat, desc = HostPull([flat, desc], stream).wait()
    out = unpack_flat(flat, layout)
    feats = {k: out.pop(k) for k, _, _ in layout if k not in PAYLOAD_KEYS}
    feats["desc"] = np.ascontiguousarray(desc).view(np.uint32)
    return {"feats": feats, **out}


def pull_kfx(kfx: np.ndarray, idx: int, layout: tuple) -> dict:
    """Frame idx's keyframe extras from the chunk's pulled ``kfx_flat``
    (C, N)."""
    return unpack_flat(kfx[idx], layout)


def parse_chunk_summary(flat: np.ndarray, n_frames: int, core_layout: tuple, n_map: int,
                        n_ml: int) -> tuple[list[dict], dict]:
    """A chunk's pulled ``chunk_flat`` -> (per-frame core dicts, landmark
    counts {key: (n,) int32})."""
    core_len = layout_size(core_layout)
    cores_flat = flat[: n_frames * core_len].reshape(n_frames, core_len)
    cores = [unpack_flat(row, core_layout) for row in cores_flat]
    cnt = np.ascontiguousarray(flat[n_frames * core_len:]).view(np.uint8)
    stats, off = {}, 0
    for k, n in zip(STAT_KEYS, (n_map, n_map, n_ml, n_ml)):
        stats[k] = cnt[off: off + n].astype(np.int32)
        off += n
    return cores, stats


def pull_chunk_summary(results: dict, core_layout: tuple, n_map: int, n_ml: int):
    """ONE device -> host transfer for a whole chunk (``chunk_flat``)."""
    flat = HostPull([results["chunk_flat"]]).wait()[0]
    return parse_chunk_summary(flat, results["core_flat"].shape[0], core_layout, n_map, n_ml)


# --------------------------------------------------------------- the chunk
def keep(result: dict, keys: tuple) -> dict:
    return {k: result[k] for k in keys if k in result}


def empty_slot(like: dict, lead: tuple = ()) -> dict:
    """Uninitialized tensors shaped like `like`'s (nested dicts too), with
    `lead` leading axes: a slot of an output ring."""
    return {k: empty_slot(v, lead) if isinstance(v, dict)
            else torch.empty(lead + tuple(v.shape), dtype=v.dtype, device=v.device)
            for k, v in like.items()}


def slot_row(slot: dict, i: int) -> dict:
    return {k: slot_row(v, i) if isinstance(v, dict) else v[i] for k, v in slot.items()}


def init_stats(cfg: SlamConfig, device, lead: tuple = ()) -> dict:
    n_map, n_ml = cfg.caps.max_map_points, cfg.caps.max_map_lines
    return {k: torch.zeros(lead + (n,), dtype=torch.int32, device=device)
            for k, n in zip(STAT_KEYS, (n_map, n_map, n_ml, n_ml))}


def accumulate_stats_(stats: dict, result: dict) -> dict:
    """Add one frame's landmark statistics to the counts, gated on
    ``tracked_ok`` (a lost frame updates nothing, Tracking.cc:420-423):
    visible and found map points, visible map lines and, with duplicates
    counted as np.add.at counts them, found map lines.  Any leading
    stream axes; integer sums, so exact in any order."""
    ok = result["tracked_ok"].to(torch.int32)[..., None]
    stats["mp_visible"] += result["visible"].to(torch.int32) * ok
    stats["mp_found"] += (result["matched"] & result["visible"]).to(torch.int32) * ok
    if "ml_visible" in result:
        stats["ml_visible"] += result["ml_visible"].to(torch.int32) * ok
        la = result["line_assoc"]
        n_ml = stats["ml_found"].shape[-1]
        hit = la >= 0
        found = torch.zeros(la.shape[:-1] + (n_ml + 1,), dtype=torch.int32, device=la.device)
        found.scatter_add_(-1, torch.where(hit, la, n_ml).long(), hit.to(torch.int32) * ok)
        stats["ml_found"] += found[..., :n_ml]
    return stats


def chunk_flat(core_flat: torch.Tensor, stats: dict) -> torch.Tensor:
    """The chunk's ONE pull: every frame's core, then the landmark counts
    clipped to uint8 and viewed as float32 (bits, not values)."""
    cnt = torch.cat([torch.clamp(stats[k], 0, 255).to(torch.uint8) for k in STAT_KEYS], -1)
    pad = (-cnt.shape[-1]) % 4
    if pad:
        cnt = torch.cat([cnt, cnt.new_zeros(cnt.shape[:-1] + (pad,))], -1)
    return torch.cat([core_flat.reshape(-1), cnt.view(torch.float32)])


def build_chunk_step(cfg: SlamConfig, device, enable_planes: bool = False,
                     enable_lines: bool = False, frame_step=None):
    """Returns chunk(gray8 (C,H,W) uint8, d16 (C,H,W) int32, carry, view,
    out=None) -> (results, carry): the C frames through the frame step in
    order (the reference's ``lax.scan``), against one view.  The landmark
    statistics accumulate on the device; each frame's CHUNK_KEEP outputs
    go into row i of `out` (an output slot with a leading chunk axis,
    allocated on first use when None); ``results["chunk_flat"]`` is the
    chunk's one pull.  `frame_step` is the frame step to run (a
    ``GraphedStep`` on the card), ``build_frame_step``'s by default.
    ``chunk.layouts`` holds the frame result's ``flat_layouts`` after the
    first call."""
    step = frame_step or build_frame_step(cfg, device, enable_planes, enable_lines)

    def chunk(gray8, d16, carry, view, out=None):
        stats = init_stats(cfg, device)
        for i in range(gray8.shape[0]):
            result, carry = step(gray8[i], d16[i], carry, view)
            accumulate_stats_(stats, result)
            lite = keep(result, CHUNK_KEEP)
            if out is None:
                out = empty_slot(lite, (gray8.shape[0],))
            copy_tree_(slot_row(out, i), lite)
        if chunk.layouts is None:
            chunk.layouts = flat_layouts(result)
        out["chunk_flat"] = chunk_flat(out["core_flat"], stats)
        return out, carry

    chunk.layouts = None
    return chunk
