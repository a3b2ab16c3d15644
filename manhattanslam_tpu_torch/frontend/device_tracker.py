"""The fused per-frame device step, points only (counterpart of
manhattanslam_tpu/frontend/device_tracker.py).

One call per frame runs on the device with no host round trip inside:

  extract ORB -> one frustum compaction of the landmark bank
    -> three candidate solves as ONE batched LM problem: projection
       (r=7) and its widened retry (r=14) from the motion-model seed, and
       descriptor matching against the reference keyframe from the last
       pose -> device-side selection of the initial pose
    -> final 4-round solve (r=4) -> polar re-orthonormalization
    -> keyframe-policy counts and the next carry

The map view (landmarks + the reference keyframe's banks) lives on the
device and is updated in place only at keyframe events, from a row diff
of two host snapshots.  The plane, line and Manhattan branches of the
reference step come with the slices that add them.

The body is written once, for B streams that share one map view
(``build_batched_body``, the batched replay of parallel/mesh.py);
the single-stream body is its B = 1 case.
"""

from __future__ import annotations

import numpy as np
import torch

from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend import tracking_ops
from manhattanslam_tpu_torch.frontend.frame import build_extractor
from manhattanslam_tpu_torch.geometry import se3
from manhattanslam_tpu_torch.ops import lm, matching

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


# ---------------------------------------------------------------- map view
_VIEW_ROW_KEYS = (
    "mp_pos", "mp_desc", "mp_valid", "mp_normal", "mp_min", "mp_max", "mp_level",
)
_VIEW_FULL_KEYS = ("ref_desc", "ref_angle", "ref_mp")


def build_host_view(cfg: SlamConfig, slam_map, ref_kf: int = 0) -> dict:
    """The tracking-relevant map state as one host dict of array copies
    (a frozen snapshot that doubles as the shadow for incremental diffs)."""
    m = slam_map
    return {
        # landmarks (identity mapping: view index == map point id)
        "mp_pos": m.mp_pos.copy(),
        "mp_desc": m.mp_desc.copy(),
        "mp_valid": m.mp_valid.copy(),
        "mp_normal": m.mp_normal.copy(),
        "mp_min": m.mp_min_dist.copy(),
        "mp_max": np.maximum(m.mp_max_dist, 1e-6),
        "mp_level": m.mp_level.copy(),
        # ref-KF landmark view (descriptor candidate)
        "ref_desc": m.kf_desc[ref_kf].copy(),
        "ref_angle": m.kf_angle[ref_kf].copy(),
        "ref_mp": m.kf_mp_idx[ref_kf].copy(),
    }


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.uint32:  # descriptor words: same bits as int32
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: never aliases the host view


def upload_view(host: dict, device) -> dict:
    return {k: _to_device(v, device) for k, v in host.items()}


def build_map_view(cfg: SlamConfig, slam_map, device) -> dict:
    """Upload the tracking-relevant map state with an empty ref-KF bank."""
    host = build_host_view(cfg, slam_map, ref_kf=0)
    host["ref_desc"] = host["ref_desc"] * 0
    host["ref_angle"] = host["ref_angle"] * 0.0
    host["ref_mp"] = np.full_like(host["ref_mp"], -1)
    return upload_view(host, device)


def set_ref_kf(view: dict, slam_map, ref_kf: int) -> dict:
    """A view whose ref-KF banks come from keyframe `ref_kf`."""
    m = slam_map
    dev = view["mp_pos"].device
    view = dict(view)
    view["ref_desc"] = _to_device(m.kf_desc[ref_kf], dev)
    view["ref_angle"] = _to_device(m.kf_angle[ref_kf], dev)
    view["ref_mp"] = _to_device(m.kf_mp_idx[ref_kf], dev)
    return view


def diff_host_views(shadow: dict, host: dict) -> list[dict]:
    """Row-level diff of two host views -> [] or one update dict: the
    changed landmark rows ("mp_idx" + those rows of each row key) and the
    ref-KF banks whole."""
    n = host["mp_pos"].shape[0]
    changed = np.zeros(n, bool)
    for k in _VIEW_ROW_KEYS:
        changed |= (shadow[k].reshape(n, -1) != host[k].reshape(n, -1)).any(axis=1)
    rows = np.nonzero(changed)[0]
    full = any(not np.array_equal(shadow[k], host[k]) for k in _VIEW_FULL_KEYS)
    if len(rows) == 0 and not full:
        return []
    upd = {"mp_idx": rows.astype(np.int64)}
    for k in _VIEW_ROW_KEYS:
        upd[k] = host[k][rows]
    for k in _VIEW_FULL_KEYS:
        upd[k] = host[k]
    return [upd]


def apply_view_update(view: dict, updates: list[dict]) -> dict:
    """Scatter the changed rows into the device view IN PLACE (the view's
    storage is reused, as the reference donates it) and replace the ref-KF
    banks."""
    for upd in updates:
        dev = view["mp_pos"].device
        idx = torch.from_numpy(upd["mp_idx"]).to(dev)
        for k in _VIEW_ROW_KEYS:
            view[k].index_copy_(0, idx, _to_device(upd[k], dev))
        for k in _VIEW_FULL_KEYS:
            view[k] = _to_device(upd[k], dev)
    return view


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


# --------------------------------------------------------------- the step
def build_batched_body(cfg: SlamConfig, device):
    """Returns body(gray (B,H,W) f32, depth (B,H,W) f32 m, carry, view) ->
    (result, new_carry) for B independent streams that share one map view
    (the reference's ``jax.vmap(body, in_axes=(0, 0, None))``): every
    carry and result tensor has a leading stream axis B, the view none.
    The streams run as one batch per op (no loop over streams), so a step
    launches the same kernels whatever B is."""
    device = torch.device(device)
    extract = build_extractor(cfg, device)
    K = torch.from_numpy(cfg.camera.K).to(device)
    bf = float(cfg.camera.bf)
    hw = (cfg.camera.height, cfg.camera.width)
    sf = cfg.orb.scale_factor
    nl = cfg.orb.n_levels
    sf_t = torch.tensor(sf, dtype=torch.float32, device=device)
    close_th = float(np.float32(cfg.th_depth_m))

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
            torch.cat([T_seed, T_last, T_seed]), K, bf,
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

        # final solve: 4 chi2-gated rounds of 5 LM iterations
        out_f = tracking_ops.track_projection(
            mp_view, T_init, feats, K, bf, 4.0, hw, cand, scale_factor=sf,
            n_rounds=4, n_iters=5, bank_stats=True,
        )
        # one polar projection per frame pins the rotation block's f32
        # non-orthonormal drift (velocity @ T_last compounds it)
        T_final = out_f["T"].clone()
        T_final[:, :3, :3] = se3.polar_rotation(T_final[:, :3, :3], iters=2)
        n_pt_f = out_f["n_pt_inliers"].to(torch.int32)
        n_inl = n_pt_f
        tracked_ok = init_ok & (n_pt_f >= 7) & (n_inl >= 7)
        ok3 = tracked_ok[:, None, None]

        # matches to the temporal block (bank index >= n_map) count as
        # inliers but are not map associations
        kp_mp_ext = out_f["kp_mp"]
        kp_mp = torch.where(kp_mp_ext >= n_map, -1, kp_mp_ext)
        n_map_inliers = (kp_mp >= 0).sum(-1).to(torch.int32)
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
            "kp_mp": kp_mp,
            "matched": out_f["matched"][:, :n_map],
            "visible": out_f["visible"][:, :n_map],
            "feats": feats,
        }
        return result, new_carry

    return body


def _first_stream(tree: dict) -> dict:
    return {k: _first_stream(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def build_frame_body(cfg: SlamConfig, device):
    """Returns body(gray (H,W) f32, depth (H,W) f32 m, carry, view) ->
    (result, new_carry), every tensor on `device`: the batched body at
    B = 1, with the stream axis added to the inputs and taken off the
    outputs."""
    batched = build_batched_body(cfg, device)

    def body(gray, depth, carry, view):
        result, new_carry = batched(
            gray[None], depth[None], {k: v[None] for k, v in carry.items()}, view
        )
        return _first_stream(result), _first_stream(new_carry)

    return body


def frame_to_float(gray8: torch.Tensor, d16: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sensor-native frames (u8 gray, depth in DEPTH_QUANT units, any
    leading axes) -> float32 gray and depth in meters, on their device."""
    inv_q = float(np.float32(1.0 / DEPTH_QUANT))
    return gray8.to(torch.float32), d16.to(torch.float32) * inv_q


def build_frame_step(cfg: SlamConfig, device):
    """Returns step(gray8 (H,W) uint8, d16 (H,W) int32 in DEPTH_QUANT
    units, carry, view) -> (result, new_carry): the frame's device program."""
    body = build_frame_body(cfg, device)

    def step(gray8, d16, carry, view):
        return body(*frame_to_float(gray8, d16), carry, view)

    return step


# ------------------------------------------------------------ host pulls
SUMMARY_KEYS = (
    "T", "tracked_ok", "n_inliers", "n_map_inliers", "n_matches",
    "tracked_close", "nontracked_close", "kp_mp", "matched", "visible",
)


def pull_summary(result: dict) -> dict:
    """What the host state machine reads every frame, as numpy."""
    return {k: result[k].cpu().numpy() for k in SUMMARY_KEYS}


def pull_feats(result: dict) -> dict:
    """The frame's features as numpy (keyframe payload); descriptors come
    back as the reference's uint32 words."""
    feats = {k: v.cpu().numpy() for k, v in result["feats"].items()}
    feats["desc"] = feats["desc"].view(np.uint32)
    return feats
