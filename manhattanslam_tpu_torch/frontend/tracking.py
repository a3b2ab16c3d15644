"""The modular tracker, the tracking states and the per-frame trajectory
record (counterpart of manhattanslam_tpu/frontend/tracking.py;
reference Tracking.cc:214-546).

The branchy per-frame control flow (the state machine, the tracker
fallbacks, the keyframe policy) runs on the host; each heavy step
(extraction, matching and the pose solve, plane and line extraction) is
one stage on the device, and every inlier count the host reads is a
sync.  This is the reference's slow, modular path, and the System's
default; the fused tracker (frontend/fast_tracking.py) runs a frame as
one graphed step.  States mirror Tracking.h:85-91: NOT_INITIALIZED -> OK
<-> LOST.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend import tracking_ops
from manhattanslam_tpu_torch.frontend.device_tracker import depth_in_metres, to_device
from manhattanslam_tpu_torch.frontend.frame import backproject_keypoints, build_extractor
from manhattanslam_tpu_torch.geometry import se3
from manhattanslam_tpu_torch.ops import lm
from manhattanslam_tpu_torch.slam_map import SlamMap

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
LOST = "LOST"


class KeyframeFrame(NamedTuple):
    """What a tracker hands the System's keyframe hook besides the
    keyframe id, for the surfel arm: the keyframe's own gray and depth as
    the caller gave them, its half-resolution plane membership (a device
    tensor; None without planes, or from the fused tracker without the
    surfel arm) and the tracker's reference keyframe before it (the surfel
    pose-graph link, SurfelMapping.cpp:162-168)."""

    gray: np.ndarray
    depth: np.ndarray
    membership: object
    ref_kf: int


@dataclass
class FrameRecord:
    """Per-frame trajectory bookkeeping (Tracking.cc:531-544)."""

    timestamp: float
    ref_kf: int
    T_cr: np.ndarray  # Tcw * inv(T_ref)
    lost: bool


class Tracker:
    """The modular tracker (the reference's Tracker): one jitted stage at a
    time on the device, the state machine, fallbacks and keyframe policy
    on the host, with a host sync for each inlier count it reads."""

    def __init__(self, cfg: SlamConfig, slam_map: SlamMap, device):
        self.cfg = cfg
        self.map = slam_map
        self.device = torch.device(device)
        self.extract = build_extractor(cfg, self.device)
        self.params = lm.default_params(cfg)
        self.K = torch.tensor(np.asarray(cfg.camera.K, np.float32), device=self.device)
        self.bf = float(np.float32(cfg.camera.bf))
        self.image_hw = (cfg.camera.height, cfg.camera.width)

        self.state = NOT_INITIALIZED
        self.only_tracking = False
        self.request_reset = False
        self.T_cw = np.eye(4, dtype=np.float32)
        self.velocity: np.ndarray | None = None
        self.frame_id = -1
        self.last_kf_frame_id = 0
        self.last_reloc_frame_id = -(10**9)
        self.ref_kf = 0
        self.prev_ref_kf = 0  # the reference keyframe before the last keyframe
        self.n_inliers = 0

        self.last_feats = None  # the previous frame's features (device)
        self.last_mp_idx = np.full(cfg.caps.max_keypoints, -1, np.int32)
        self.last_pose = np.eye(4, dtype=np.float32)
        self._frame = (None, None)  # the caller's gray and depth of this frame

        self.records: list[FrameRecord] = []
        self.counts = Counter()  # keyframes made, frames relocalized
        slam_map.kf_retire_callbacks.append(self._on_kf_retired)
        self.min_frames = 0
        self.max_frames = int(cfg.camera.fps)

        # hooks the System fills (planes, lines, relocalization, keyframes)
        self.plane_module = None
        self.line_module = None
        self.reloc_module = None
        self.on_keyframe = None

        self._empty_planes = tracking_ops.empty_plane_obs(cfg.caps.max_planes_frame,
                                                          device=self.device)
        self._empty_lines = tracking_ops.empty_line_obs(cfg.caps.max_lines, device=self.device)

    # ------------------------------------------------------------------ API
    def track(self, timestamp: float, gray: np.ndarray, depth: np.ndarray):
        """Process one RGB-D frame (gray float32; depth float32 metres or
        uint16 in 1/DEPTH_QUANT m); returns Tcw (4,4) or None."""
        self.frame_id += 1
        self._frame = (gray, depth)
        gray_t = to_device(np.asarray(gray, np.float32), self.device)
        depth_t = to_device(depth_in_metres(depth), self.device)
        feats = self.extract(gray_t, depth_t)

        if self.state == NOT_INITIALIZED:
            self._stereo_initialization(timestamp, feats, gray_t, depth_t)
            self._record(timestamp, lost=False)
            self._set_last(feats)
            return self.T_cw.copy()

        lost_this_frame = not self._track_frame(timestamp, feats, gray_t, depth_t)
        self._record(timestamp, lost=lost_this_frame)
        self._set_last(feats)
        return None if lost_this_frame else self.T_cw.copy()

    # ------------------------------------------------------------- tracking
    def _track_frame(self, timestamp: float, feats: dict, gray, depth) -> bool:
        if self.state == LOST:
            if not self._relocalize(feats):
                return False
            self.state = OK
            self.velocity = None
            self.last_reloc_frame_id = self.frame_id

        T_seed = (self.velocity @ self.last_pose if self.velocity is not None
                  else self.last_pose).astype(np.float32)

        # the initial pose: the 6-dof point solve (motion model, else the
        # reference keyframe); planes are associated at the solved pose, not
        # at the velocity seed as the reference system does (Tracking.cc:253)
        ok = False
        out = None
        if self.velocity is not None:
            out = self._track_last_frame(feats, T_seed, radius=7.0)
            ok = int(out["n_pt_inliers"]) >= 10
            if not ok:  # widened search (Tracking.cc:1321-1327, 2 * th)
                out = self._track_last_frame(feats, T_seed, radius=14.0)
                ok = int(out["n_pt_inliers"]) >= 10
        if not ok:
            out = self._track_ref_kf(feats, self.last_pose)
            ok = int(out["n_pt_inliers"]) >= 10
        if not ok:
            self._set_lost()
            return False

        T = out["T"].cpu().numpy()

        # planes: extract, associate at the solved pose, detect Manhattan
        if self.plane_module is not None:
            self.plane_module.process_frame(depth, T)
            manhattan_R = self.plane_module.manhattan_Rcw
            # the Manhattan decoupled path: the rotation from the Manhattan
            # frame, a translation-only re-solve (Tracking.cc:257-275, :846-944)
            if manhattan_R is not None:
                T_manh = T.copy()
                T_manh[:3, :3] = manhattan_R
                out_t = self._track_last_frame(feats, T_manh, radius=7.0, translation_only=True)
                if int(out_t["n_pt_inliers"]) < 10:
                    # the motion model's translation failed: retry against
                    # the reference keyframe by descriptors before giving up
                    # the Manhattan rotation (TranslationEstimation)
                    out_t = self._track_ref_kf(feats, T_manh, translation_only=True)
                if int(out_t["n_pt_inliers"]) >= 10:
                    out = out_t
                    T = out["T"].cpu().numpy()
                    self.plane_module.match(T)
        if self.line_module is not None:
            self.line_module.process_frame(gray, depth, T)

        # the local map
        out2, local_ids = self._track_local_map(feats, T)
        self.n_inliers = int(out2["n_pt_inliers"])
        # 50 inliers within max_frames of a relocalization, 30 otherwise
        # (TrackLocalMap's reloc-recency rule)
        recently_relocalized = self.frame_id < self.last_reloc_frame_id + self.max_frames
        if self.n_inliers < (50 if recently_relocalized else 30):
            self._set_lost()
            return False

        self.state = OK
        T = out2["T"].cpu().numpy()

        # the final plane association at the optimized pose (the new-plane
        # flag, keyframe observations, Manhattan registration)
        if self.plane_module is not None:
            self.plane_module.match(T)

        # the velocity model (Tracking.cc:440-446)
        self.velocity = (T @ np.linalg.inv(self.last_pose)).astype(np.float32)
        self.T_cw = T

        # per-keypoint landmark associations for the next frame, and the
        # landmark statistics
        kp_mp = np.full(self.cfg.caps.max_keypoints, -1, np.int32)
        kp_idx = out2["kp_idx"].cpu().numpy()
        inl = out2["pt_inlier"].cpu().numpy()
        matched = out2["matched"].cpu().numpy()
        vis = out2["visible"].cpu().numpy()
        ids = local_ids
        kp_mp[kp_idx[inl]] = ids[inl]
        self.last_mp_idx = kp_mp
        valid_ids = ids >= 0
        self.map.mp_visible[ids[valid_ids & vis]] += 1
        self.map.mp_found[ids[valid_ids & matched & inl]] += 1

        if not self.only_tracking and self._need_new_keyframe(feats):
            self._create_keyframe(timestamp, feats)
        return True

    def _pts_view_from_map_ids(self, ids: np.ndarray) -> dict:
        """Fixed-shape landmark rows for the given per-slot map ids (-1 pad)."""
        m = self.map
        safe = np.maximum(ids, 0)
        host = {"pos": m.mp_pos[safe], "desc": m.mp_desc[safe],
                "valid": (ids >= 0) & m.mp_valid[safe], "level": m.mp_level[safe]}
        return {k: to_device(v, self.device) for k, v in host.items()}

    def _temporal_points(self) -> dict | None:
        """Localization mode's throwaway landmarks from the last frame's
        depth (UpdateLastFrame, Tracking.cc:1052-1144): up to 100 of its
        closest unmatched keypoints, for motion-model matching."""
        if self.last_feats is None:
            return None
        f = _feats_np(self.last_feats)
        depth = f["depth"]
        usable = f["valid"] & (depth > 0) & (self.last_mp_idx < 0)
        order = np.argsort(np.where(usable, depth, np.inf))[:100]
        order = order[usable[order]]
        n_kp = self.cfg.caps.max_keypoints
        pos = np.zeros((n_kp, 3), np.float32)
        valid = np.zeros(n_kp, bool)
        cam = self.cfg.camera
        if len(order):
            d = depth[order]
            x = (f["xy_und"][order, 0] - cam.cx) / cam.fx * d
            y = (f["xy_und"][order, 1] - cam.cy) / cam.fy * d
            pc = np.stack([x, y, d], -1)
            T_wc = np.linalg.inv(self.last_pose)
            pos[: len(order)] = pc @ T_wc[:3, :3].T + T_wc[:3, 3]
            valid[: len(order)] = True
        desc = np.zeros((n_kp, 8), np.uint32)
        desc[: len(order)] = f["desc"][order]
        level = np.zeros(n_kp, np.int32)
        level[: len(order)] = f["level"][order]
        host = {"pos": pos, "desc": desc, "valid": valid, "level": level}
        return {k: to_device(v, self.device) for k, v in host.items()}

    def _projection(self, pts: dict, T_seed: np.ndarray, feats: dict, radius: float,
                    translation_only: bool = False, use_scale_gate: bool = False) -> dict:
        """track_projection of one frame (a batch of one), with the plane
        and line observations."""
        plane_obs, line_obs = self._gather_structural()
        out = tracking_ops.track_projection(
            _lead(pts), to_device(np.asarray(T_seed, np.float32), self.device)[None],
            _lead(feats), self.K, self.bf, radius, self.image_hw,
            scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
            plane_obs=tracking_ops.PlaneObs(*(f[None] for f in plane_obs)),
            line_obs=tracking_ops.LineObs(*(f[None] for f in line_obs)),
            params=self.params, translation_only=translation_only, use_planes=True,
            use_lines=True, use_scale_gate=use_scale_gate,
        )
        return {k: v[0] for k, v in out.items()}

    def _track_last_frame(self, feats, T_seed, radius: float,
                          translation_only: bool = False) -> dict:
        pts = self._pts_view_from_map_ids(self.last_mp_idx)
        if self.only_tracking:
            vo = self._temporal_points()
            if vo is not None:
                pts = {k: torch.cat([pts[k], vo[k]]) for k in pts}
        return self._projection(pts, T_seed, feats, radius, translation_only=translation_only)

    def _track_ref_kf(self, feats, T_seed, translation_only: bool = False) -> dict:
        m = self.map
        kf = self.ref_kf
        pts = self._pts_view_from_map_ids(m.kf_mp_idx[kf])
        plane_obs, line_obs = self._gather_structural()
        out = tracking_ops.track_descriptors(
            _lead(pts), to_device(np.asarray(T_seed, np.float32), self.device)[None],
            _lead(feats), to_device(m.kf_angle[kf], self.device)[None], self.K, self.bf,
            self.params, tracking_ops.PlaneObs(*(f[None] for f in plane_obs)),
            tracking_ops.LineObs(*(f[None] for f in line_obs)),
            translation_only=translation_only, use_planes=True, use_lines=True,
        )
        return {k: v[0] for k, v in out.items()}

    def _local_keyframes(self) -> np.ndarray:
        """The keyframes sharing landmarks with the current frame and their
        top covisible neighbours (UpdateLocalKeyFrames,
        Tracking.cc:1754-1850); the reference keyframe becomes the one
        sharing most."""
        m = self.map
        matched = self.last_mp_idx[self.last_mp_idx >= 0]
        if len(matched) == 0:
            base = np.array([self.ref_kf])
        else:
            seen = np.isin(m.kf_mp_idx[: m.n_kf], matched).sum(axis=1)
            seen[~m.kf_valid[: m.n_kf]] = 0
            base = np.nonzero(seen > 0)[0]
            if len(base) == 0:
                base = np.array([self.ref_kf])
            self.ref_kf = int(base[np.argmax(seen[base])])
        neigh = set(base.tolist())
        for k in base[:10]:
            neigh.update(m.covisible_kfs(int(k))[:10].tolist())
        out = np.array(sorted(neigh), np.int64)
        return out[: self.cfg.caps.max_local_keyframes]

    def _track_local_map(self, feats, T_seed) -> tuple[dict, np.ndarray]:
        view = self.map.local_map_view(self._local_keyframes())
        pts = {k: to_device(view[k], self.device)
               for k in ("pos", "desc", "valid", "normal", "min_dist", "max_dist")}
        out = self._projection(pts, T_seed, feats, 4.0, use_scale_gate=True)
        return out, view["ids"]

    def _gather_structural(self):
        """Plane and line observations for the pose solves."""
        planes = (self.plane_module.plane_observations() if self.plane_module is not None
                  else self._empty_planes)
        lines = (self.line_module.line_observations() if self.line_module is not None
                 else self._empty_lines)
        return planes, lines

    # ------------------------------------------------------ initialization
    def _stereo_initialization(self, timestamp: float, feats: dict, gray, depth) -> None:
        """StereoInitialization (Tracking.cc:548-625): the first frame
        becomes a keyframe, every keypoint with depth a map point, the
        frame's planes and lines map planes and lines."""
        self.T_cw = np.eye(4, dtype=np.float32)
        feats_np = _feats_np(feats)
        kf_id = self.map.add_keyframe(self.T_cw, timestamp, self.frame_id, feats_np)
        mp_idx = self._create_points_from_depth(
            feats, feats_np, kf_id, np.full(self.cfg.caps.max_keypoints, -1, np.int32),
            max_new=10**9, only_close=False,
        )
        self.map.set_kf_matches(kf_id, mp_idx)
        if self.plane_module is not None:
            self.plane_module.process_frame(depth, self.T_cw)
            self.plane_module.on_keyframe(kf_id, self.T_cw)
        if self.line_module is not None:
            self.line_module.process_frame(gray, depth, self.T_cw)
            self.line_module.on_keyframe(kf_id, self.T_cw)
        self.last_mp_idx = mp_idx
        self.prev_ref_kf = self.ref_kf
        self.ref_kf = kf_id
        self.last_kf_frame_id = self.frame_id
        self.state = OK
        self._keyframe_hook(kf_id)

    def _create_points_from_depth(self, feats, feats_np: dict, kf_id: int, existing: np.ndarray,
                                  max_new: int, only_close: bool = True) -> np.ndarray:
        """New map points from depth in depth order (CreateNewKeyFrame,
        Tracking.cc:1510-1652): the close ones, then far ones while fewer
        than max_new are made.  This is the modular tracker's loop; the
        fused tracker keeps its own rule."""
        cfg = self.cfg
        pts_cam = backproject_keypoints(feats, cfg).cpu().numpy()
        T_wc = np.linalg.inv(self.T_cw)
        pts_w = pts_cam @ T_wc[:3, :3].T + T_wc[:3, 3]
        depth = feats_np["depth"]
        valid = feats_np["valid"] & (depth > 0) & (existing < 0)
        order = np.argsort(np.where(valid, depth, np.inf))
        close_th = cfg.th_depth_m
        n_new = 0
        chosen = []
        for k in order:
            if not valid[k]:
                break
            if depth[k] > close_th and n_new >= max_new:
                break
            chosen.append(k)
            n_new += 1
            if n_new >= max_new and depth[k] > close_th:
                break
        if not chosen:
            return existing.copy()
        chosen = np.array(chosen)
        cam_center = T_wc[:3, 3]
        p = pts_w[chosen]
        dvec = p - cam_center
        dist = np.linalg.norm(dvec, axis=1)
        normal = dvec / np.maximum(dist[:, None], 1e-9)
        lvl = feats_np["level"][chosen]
        sf = cfg.orb.scale_factor
        max_dist = dist * sf**lvl
        min_dist = max_dist / sf ** (cfg.orb.n_levels - 1)
        ids = self.map.add_points(p, feats_np["desc"][chosen], normal, min_dist, max_dist, lvl,
                                  kf_id)
        out = existing.copy()
        out[chosen] = ids
        return out

    # ------------------------------------------------------ keyframe policy
    def _need_new_keyframe(self, feats) -> bool:
        """NeedNewKeyFrame (Tracking.cc:1433-1508), the RGB-D branch."""
        m = self.map
        if m.n_kf >= self.cfg.caps.max_keyframes - 1:
            return False
        depth = feats["depth"].cpu().numpy()
        valid = feats["valid"].cpu().numpy()
        close = valid & (depth > 0) & (depth < self.cfg.th_depth_m)
        tracked_close = int((close & (self.last_mp_idx >= 0)).sum())
        nontracked_close = int((close & (self.last_mp_idx < 0)).sum())
        need_close = tracked_close < 100 and nontracked_close > 70

        ref_matches = int((m.kf_mp_idx[self.ref_kf] >= 0).sum())
        th_ref = 0.75 if m.n_kf > 2 else 0.4

        frames_since = self.frame_id - self.last_kf_frame_id
        c1a = frames_since >= self.max_frames
        c1b = frames_since >= self.min_frames
        c1c = self.n_inliers < ref_matches * 0.25 or need_close
        c2 = (self.n_inliers < ref_matches * th_ref or need_close) and self.n_inliers > 15
        # a new (unassociated) plane forces a keyframe (Tracking.cc:1494)
        new_plane = self.plane_module is not None and self.plane_module.new_plane
        return ((c1a or c1b or c1c) and c2) or new_plane

    def _create_keyframe(self, timestamp: float, feats) -> None:
        feats_np = _feats_np(feats)
        kf_id = self.map.add_keyframe(self.T_cw, timestamp, self.frame_id, feats_np)
        mp_idx = self._create_points_from_depth(feats, feats_np, kf_id, self.last_mp_idx,
                                                max_new=100)
        self.map.set_kf_matches(kf_id, mp_idx)
        if self.plane_module is not None:
            self.plane_module.on_keyframe(kf_id, self.T_cw)
        if self.line_module is not None:
            self.line_module.on_keyframe(kf_id, self.T_cw)
        self.last_mp_idx = mp_idx
        self.prev_ref_kf = self.ref_kf  # the surfel pose-graph link
        self.ref_kf = kf_id
        self.last_kf_frame_id = self.frame_id
        self._keyframe_hook(kf_id)

    def _keyframe_hook(self, kf_id: int) -> None:
        """Hand the keyframe to the System: its id, the caller's gray and
        depth of this frame, the plane module's half-resolution membership
        (on the device) and the reference keyframe before it."""
        self.counts["keyframes"] += 1
        if self.on_keyframe is None:
            return
        pm = self.plane_module
        memb = (pm.frame_planes["membership"]
                if pm is not None and pm.frame_planes is not None else None)
        self.on_keyframe(kf_id, KeyframeFrame(*self._frame, memb, self.prev_ref_kf))

    # -------------------------------------------------------------- relocal
    def _relocalize(self, feats) -> bool:
        if self.reloc_module is None:
            return False
        T = self.reloc_module.relocalize(feats)
        if T is None:
            return False
        self.T_cw = T.astype(np.float32)
        self.last_pose = self.T_cw.copy()
        self.counts["relocalized"] += 1
        return True

    # ---------------------------------------------------------- bookkeeping
    def _set_lost(self) -> None:
        """Lost; with a barely started map (<= 5 keyframes) ask for a full
        system reset instead of relocalizing (Tracking.cc:517-523)."""
        self.state = LOST
        if not self.only_tracking and self.map.n_kf <= 5:
            self.request_reset = True

    def _record(self, timestamp: float, lost: bool) -> None:
        T_ref = self.map.kf_pose[self.ref_kf]
        if lost:
            # the previous relative pose (Tracking.cc:538-544)
            T_cr = self.records[-1].T_cr if self.records else np.eye(4, dtype=np.float32)
        else:
            T_cr = (self.T_cw @ np.linalg.inv(T_ref)).astype(np.float32)
        self.records.append(FrameRecord(timestamp, self.ref_kf, T_cr, lost))

    def _on_kf_retired(self, kf: int, parent: int) -> None:
        """Re-anchor the records of a retired keyframe on its spanning-tree
        parent (System.cc:221-224, applied eagerly so the slot can be
        reused)."""
        if parent < 0:
            return
        m = self.map
        M = (m.kf_pose[kf] @ np.linalg.inv(m.kf_pose[parent])).astype(np.float32)
        for r in self.records:
            if r.ref_kf == kf:
                r.T_cr = r.T_cr @ M
                r.ref_kf = parent
        if self.ref_kf == kf:
            self.ref_kf = parent

    def _set_last(self, feats) -> None:
        self.last_feats = feats
        self.last_pose = self.T_cw.copy()

    # ------------------------------------------------------------- export
    def trajectory_rows(self):
        """The T_cr * T_ref chain (System::SaveTrajectoryTUM)."""
        rows = []
        Two = np.linalg.inv(self.map.kf_pose[0])
        for rec in self.records:
            if rec.lost:
                continue
            T_cw = rec.T_cr @ (self.map.kf_pose[rec.ref_kf] @ Two)
            R_wc = T_cw[:3, :3].T
            t_wc = -R_wc @ T_cw[:3, 3]
            rows.append((rec.timestamp, t_wc, se3.rotmat_to_quat_np(R_wc)))
        return rows

    def keyframe_rows(self):
        rows = []
        m = self.map
        for i in range(m.n_kf):
            if not m.kf_valid[i]:
                continue
            T = m.kf_pose[i]
            R_wc = T[:3, :3].T
            t_wc = -R_wc @ T[:3, 3]
            rows.append((m.kf_time[i], t_wc, se3.rotmat_to_quat_np(R_wc)))
        return rows


def _lead(tree: dict) -> dict:
    """A leading batch axis of one on every tensor."""
    return {k: v[None] for k, v in tree.items()}


def _feats_np(feats: dict) -> dict:
    """A frame's features as numpy, descriptors as uint32 words."""
    out = {k: v.cpu().numpy() for k, v in feats.items()}
    out["desc"] = np.ascontiguousarray(out["desc"]).view(np.uint32)
    return out
