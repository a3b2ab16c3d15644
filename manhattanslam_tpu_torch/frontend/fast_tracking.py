"""Host state machine around the fused device step (counterpart of
manhattanslam_tpu/frontend/fast_tracking.py, one frame per step).

Per frame: one upload (u8 gray + depth), one step on the device, one pull
of the summary.  The map view on the device is refreshed only at keyframe
events, where the host runs the reference's keyframe policy, creates map
points from depth and, with planes on, merges or adds the frame's planes
and registers perpendicular pairs and triples in the Manhattan
registries; with lines on, it refines associated map lines and adds new
ones.  Then the keyframe goes to ``on_keyframe`` (the System's mapping
back end and relocalization index) and the view is refreshed a second
time, so that the back end's triangulated, fused and culled landmarks
reach the device.  A retired keyframe re-anchors the trajectory records
and the reference keyframe on its spanning-tree parent.  A lost frame
goes to ``reloc_module``; in localization mode (``only_tracking``) no
keyframe is made and a loss never asks for a reset.  No threads: each
call to ``track`` returns after its frame is finished, back end
included.  Chunked dispatch and the pipeline come with a later slice.
"""

from __future__ import annotations

import itertools
from collections import Counter

import numpy as np
import torch

from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend import device_tracker as dt
from manhattanslam_tpu_torch.frontend.tracking import LOST, NOT_INITIALIZED, OK, FrameRecord
from manhattanslam_tpu_torch.geometry import se3
from manhattanslam_tpu_torch.ops.planes import transform_plane_np
from manhattanslam_tpu_torch.slam_map import SlamMap


class FastTracker:
    def __init__(
        self,
        cfg: SlamConfig,
        slam_map: SlamMap,
        device: torch.device,
        enable_planes: bool = False,
        enable_lines: bool = False,
    ):
        self.cfg = cfg
        self.map = slam_map
        self.device = device
        self.enable_planes = enable_planes
        self.enable_lines = enable_lines
        self.step = dt.build_frame_step(cfg, device, enable_planes, enable_lines)
        # Manhattan registries (host source of truth; the view mirrors them)
        self.reg2, self.reg3 = dt.empty_registries(cfg)
        # the temporal VO bank anchors tracking while map coverage starves
        # (it engages only below 30 map inliers, device_tracker.py)
        self.carry = dt.init_carry(cfg, device, vo_points=True)
        self.view = None  # device map view
        self.last_result = None
        self._shadow = None  # host snapshot of what the device view holds
        self.frame_log: list[tuple] = []  # (frame_id, n_inliers, ok, ref_matches, ref_total)

        self.state = NOT_INITIALIZED
        self.request_reset = False
        self.T_cw = np.eye(4, dtype=np.float32)
        self.frame_id = -1
        self.last_kf_frame_id = 0
        self.ref_kf = 0
        self.n_inliers = 0
        self.n_map_inliers = 0
        self.records: list[FrameRecord] = []
        self.max_frames = int(cfg.camera.fps)
        self.min_frames = int(cfg.min_kf_frames)
        self.last_reloc_frame_id = -(10**9)
        self.only_tracking = False  # localization mode
        self._vo_flag = False  # the carry's vo_points as last set by the mode
        self.n_ok_frames = 0
        # keyframes made, of them in reused slots, points made from depth,
        # frames relocalized
        self.counts = Counter()
        self.prev_ref_kf = 0  # the reference keyframe before the last keyframe
        # hooks: System sets these (the back end and relocalization)
        self.on_keyframe = None
        self.reloc_module = None
        slam_map.kf_retire_callbacks.append(self._on_kf_retired)
        self._ref_matches = None  # cache; None = recompute (map/ref-KF changed)
        self._ref_total = 0
        self.n_manhattan_frames = 0  # frames the Manhattan pose carried
        self._new_plane_streak = 0

    # ------------------------------------------------------------------ API
    def track(self, timestamp: float, gray: np.ndarray, depth: np.ndarray):
        """Track one frame; returns Tcw (4,4) or None when lost."""
        self.frame_id += 1
        if self.only_tracking != self._vo_flag:
            # the mode changed: the temporal VO bank follows it
            # (UpdateLastFrame, Tracking.cc:1052)
            self.carry["vo_points"] = torch.tensor(self.only_tracking, device=self.device)
            self._vo_flag = self.only_tracking
        g8, d16 = dt.to_native(gray, depth)
        g8_t = torch.from_numpy(g8).to(self.device)
        d16_t = torch.from_numpy(d16.astype(np.int32)).to(self.device)
        if self.state == NOT_INITIALIZED:
            self._initialize(timestamp, g8_t, d16_t)
            self._record(timestamp, lost=False)
            return self.T_cw.copy()
        result, self.carry = self.step(g8_t, d16_t, self.carry, self.view)
        self.last_result = result  # the device result of the last frame
        return self._finish_frame(timestamp, result)

    def _finish_frame(self, timestamp: float, result: dict) -> np.ndarray | None:
        s = dt.pull_summary(result)
        ok = bool(s["tracked_ok"])
        # within one fps window of a relocalization the reference asks for
        # >= 20 inliers (Tracking.cc:1423-1425)
        if ok and self.frame_id < self.last_reloc_frame_id + self.max_frames:
            ok = int(s["n_inliers"]) >= 20
        self.frame_log.append(
            (self.frame_id, int(s["n_inliers"]), ok,
             self._ref_matches if self._ref_matches is not None else -1,
             self._ref_total)
        )
        if not ok and self._relocalize(result):
            # the failed step's pose and matches are not used: the pose
            # and the carry come from the relocalization
            self.state = OK
            self._record(timestamp, lost=False)
            return self.T_cw.copy()
        if not ok:
            self.state = LOST
            # barely-started map: request a full system reset
            # (Tracking.cc:517-523)
            if not self.only_tracking and self.map.n_kf <= 5:
                self.request_reset = True
            self._record(timestamp, lost=True)
            return None

        self.state = OK
        self.T_cw = s["T"].astype(np.float32)
        self.n_inliers = int(s["n_inliers"])
        self.n_map_inliers = int(s["n_map_inliers"])
        self.n_ok_frames += 1
        if bool(s.get("use_manhattan", False)):
            self.n_manhattan_frames += 1
        # landmark statistics (MapPoint::IncreaseVisible / IncreaseFound)
        m = self.map
        vis = s["visible"] & m.mp_valid
        m.mp_visible[vis] += 1
        m.mp_found[s["matched"] & vis] += 1
        if self.enable_lines:
            # MapLine::IncreaseVisible / IncreaseFound; np.add.at counts
            # two frame lines on one map line twice
            m.ml_visible[s["ml_visible"] & m.ml_valid] += 1
            matched_ml = s["line_assoc"][s["line_assoc"] >= 0]
            np.add.at(m.ml_found, matched_ml[m.ml_valid[matched_ml]], 1)
        if not self.only_tracking and self._need_new_keyframe(s, self.frame_id):
            self._create_keyframe(timestamp, result, s, self.frame_id)
        self._record(timestamp, lost=False)
        return self.T_cw.copy()

    # ------------------------------------------------------------- keyframe
    def _need_new_keyframe(self, s: dict, frame_id: int) -> bool:
        """NeedNewKeyFrame (Tracking.cc:1433-1508) as the reference package
        decides it for points and planes: past the min-frames hysteresis, a
        keyframe when map matches fall below a share of the reference
        keyframe's well-observed points (or close points go untracked), or
        when a new plane persists, while the pose still has more than 15
        inliers."""
        m = self.map
        c = self.cfg.caps
        free_kf = (c.max_keyframes - m.n_kf) + len(m.kf_free)
        if free_kf <= 1:
            return False
        n_kfs = m.n_kf - len(m.kf_free)  # live keyframes
        # no keyframe right after a relocalization once the map is mature
        # (Tracking.cc:1443-1444)
        if frame_id < self.last_reloc_frame_id + self.max_frames and n_kfs > self.max_frames:
            return False
        since_kf = frame_id - self.last_kf_frame_id
        # a frame plane with no map association, seen on >= 2 consecutive
        # frames (Tracking.cc:1494; a one-frame flicker mints nothing)
        new_plane = bool(s.get("new_plane", False))
        self._new_plane_streak = self._new_plane_streak + 1 if new_plane else 0
        if since_kf < self.min_frames:
            return False
        # TrackedMapPoints(nMinObs): ref-KF matches with >= nMinObs
        # observations; changes only at keyframe events, so cached
        if self._ref_matches is None:
            nmin = 3 if n_kfs > 2 else 2
            ref_ids = m.kf_mp_idx[self.ref_kf]
            ref_ids = ref_ids[ref_ids >= 0]
            if len(ref_ids):
                flat = m.kf_mp_idx[: m.n_kf][m.kf_valid[: m.n_kf]]
                flat = flat[flat >= 0]
                obs = np.bincount(flat, minlength=c.max_map_points)
                self._ref_matches = int((obs[ref_ids] >= nmin).sum())
                self._ref_total = len(ref_ids)
            else:
                self._ref_matches = 0
                self._ref_total = 0
        th_ref = 0.75 if n_kfs > 2 else 0.4
        need_close = int(s["tracked_close"]) < 100 and int(s["nontracked_close"]) > 70
        c2 = (
            self.n_map_inliers < self._ref_matches * th_ref or need_close
        ) and self.n_inliers > 15
        decision = c2 or (self._new_plane_streak >= 2 and self.n_inliers > 15)
        if decision:
            self._new_plane_streak = 0
        return decision

    def _create_keyframe(self, timestamp, result, s, frame_id) -> None:
        m = self.map
        feats_np = dt.pull_feats(result)
        self.counts["slots_reused"] += bool(m.kf_free)
        kf_id = m.add_keyframe(self.T_cw, timestamp, frame_id, feats_np)
        self.counts["keyframes"] += 1
        # new map points from depth (close-first, cap 100)
        mp_idx = self._create_points_from_depth(feats_np, kf_id, s["kp_mp"])
        self.counts["depth_points"] += int(((mp_idx >= 0) & (s["kp_mp"] < 0)).sum())
        m.set_kf_matches(kf_id, mp_idx)
        if self.enable_planes:
            self._kf_planes(kf_id, dt.pull_planes(result), s["plane_assoc"])
        if self.enable_lines:
            self._kf_lines(kf_id, dt.pull_lines(result))
        self.prev_ref_kf = self.ref_kf
        self.ref_kf = kf_id
        self.last_kf_frame_id = frame_id
        self._ref_matches = None
        # the new keyframe's points enter the device view now, so the next
        # frame tracks against them
        self.refresh_view()
        if self.on_keyframe is not None:
            self.on_keyframe(kf_id)
            # the back end's triangulated, fused and culled landmarks
            self.refresh_view()

    def _create_points_from_depth(self, feats_np, kf_id, existing, max_new=100):
        """All close points + nearest far points up to max_new total
        (CreateNewKeyFrame depth-sorted rule, Tracking.cc:1554-1580)."""
        cfg = self.cfg
        m = self.map
        depth = feats_np["depth"]
        valid = feats_np["valid"] & (depth > 0) & (existing < 0)
        close_th = cfg.th_depth_m
        idx_close = np.nonzero(valid & (depth <= close_th))[0]
        chosen = idx_close
        if len(idx_close) < max_new:
            far = np.nonzero(valid & (depth > close_th))[0]
            far = far[np.argsort(depth[far])][: max_new - len(idx_close)]
            chosen = np.concatenate([idx_close, far])
        out = existing.copy()
        n_free = int((~m.mp_valid).sum())
        chosen = chosen[:n_free]
        if len(chosen) == 0:
            return out
        cam = cfg.camera
        d = depth[chosen]
        x = (feats_np["xy_und"][chosen, 0] - cam.cx) / cam.fx * d
        y = (feats_np["xy_und"][chosen, 1] - cam.cy) / cam.fy * d
        pts_c = np.stack([x, y, d], -1)
        T_wc = np.linalg.inv(self.T_cw)
        pts_w = pts_c @ T_wc[:3, :3].T + T_wc[:3, 3]
        dvec = pts_w - T_wc[:3, 3]
        dist = np.linalg.norm(dvec, axis=1).clip(1e-9)
        lvl = feats_np["level"][chosen]
        sf = cfg.orb.scale_factor
        max_d = dist * sf**lvl
        min_d = max_d / sf ** (cfg.orb.n_levels - 1)
        ids = m.add_points(
            pts_w, feats_np["desc"][chosen], dvec / dist[:, None], min_d, max_d, lvl, kf_id
        )
        out[chosen] = ids
        return out

    def _kf_planes(self, kf_id: int, planes: dict, assoc: np.ndarray) -> None:
        """The keyframe's planes: an associated one merges its world-frame
        cloud into its map plane, a new one becomes a map plane; then every
        perpendicular pair and triple of them is registered with this
        keyframe (LocalMapping.cc:172-218)."""
        m = self.map
        T_wc = np.linalg.inv(self.T_cw)
        P = self.cfg.caps.max_planes_frame
        assoc = assoc.copy()
        for i in range(P):
            if not planes["plane_valid"][i]:
                continue
            cloud_c = planes["plane_cloud"][i][: planes["plane_npts"][i]]
            cloud_w = cloud_c @ T_wc[:3, :3].T + T_wc[:3, 3]
            j = int(assoc[i])
            if j >= 0 and m.pl_valid[j]:
                m.merge_plane_points(j, cloud_w)
                m.pl_n_obs[j] += 1
            else:
                if (~m.pl_valid).sum() == 0:
                    continue
                pi_w = transform_plane_np(T_wc, planes["plane_coeffs"][i])
                j = m.add_plane(pi_w, cloud_w, kf_id)
                assoc[i] = j
            m.kf_pl_idx[kf_id, i] = j
            m.kf_plane_coeffs[kf_id, i] = planes["plane_coeffs"][i]
            m.kf_plane_npts[kf_id, i] = planes["plane_support"][i]

        # Manhattan registration of the associated planes
        th = self.cfg.plane.mf_vertical_threshold
        ids = [i for i in range(P) if planes["plane_valid"][i] and assoc[i] >= 0]
        normal = planes["plane_coeffs"][:, :3]
        for a, i in enumerate(ids):
            for b in range(a + 1, len(ids)):
                j = ids[b]
                if abs(float(normal[i] @ normal[j])) > th:
                    continue
                pa, pb = int(assoc[i]), int(assoc[j])
                if self.reg2[pa, pb] < 0:
                    self.reg2[pa, pb] = self.reg2[pb, pa] = kf_id
                    m.add_manhattan_pair(pa, pb, kf_id)
                for k in ids[b + 1:]:
                    if abs(float(normal[i] @ normal[k])) > th or abs(float(normal[j] @ normal[k])) > th:
                        continue
                    trip = (pa, pb, int(assoc[k]))
                    if self.reg3[trip] < 0:
                        for perm in itertools.permutations(trip):
                            self.reg3[perm] = kf_id
                        m.add_manhattan_triple(*trip, kf_id)

    def _kf_lines(self, kf_id: int, lines: dict, max_new: int = 30) -> None:
        """The keyframe's lines (the reference's _kf_lines): an associated
        line refines its map line with its world-frame 3D segment, when it
        has one; an unassociated line with a 3D segment becomes a map line
        in the lowest free slot, at most max_new per keyframe."""
        m = self.map
        T_wc = np.linalg.inv(self.T_cw)

        def world(p):
            return p @ T_wc[:3, :3].T + T_wc[:3, 3]

        n_new = 0
        for i in range(self.cfg.caps.max_lines):
            if not lines["line_valid"][i]:
                continue
            j = int(lines["line_assoc"][i])
            if j >= 0 and m.ml_valid[j]:
                if lines["line_has3d"][i]:
                    m.observe_line(j, world(lines["line_sp3"][i]), world(lines["line_ep3"][i]),
                                   lines["line_desc"][i])
                m.ml_n_obs[j] += 1
            elif lines["line_has3d"][i] and n_new < max_new:
                free = np.nonzero(~m.ml_valid)[0]
                if len(free) == 0:
                    break
                j = int(free[0])
                m.ml_sp[j] = world(lines["line_sp3"][i])
                m.ml_ep[j] = world(lines["line_ep3"][i])
                m.ml_desc[j, : lines["line_desc"].shape[1]] = lines["line_desc"][i]
                m.ml_valid[j] = True
                m.ml_n_obs[j] = 1
                m.ml_first_kf[j] = kf_id
                n_new += 1
            else:
                continue
            m.kf_ml_idx[kf_id, i] = j

    # ------------------------------------------------------- initialization
    def _initialize(self, timestamp, g8_t, d16_t) -> None:
        """First frame: its features become keyframe 0 with every depth
        point as a landmark."""
        self.T_cw = np.eye(4, dtype=np.float32)
        self.refresh_view()  # bootstrap view (empty map) so the step can run
        result, _ = self.step(g8_t, d16_t, self.carry, self.view)
        feats_np = dt.pull_feats(result)
        m = self.map
        kf_id = m.add_keyframe(self.T_cw, timestamp, self.frame_id, feats_np)
        mp_idx = self._create_points_from_depth(
            feats_np, kf_id, np.full(self.cfg.caps.max_keypoints, -1, np.int32),
            max_new=10**9,
        )
        self.counts.update(keyframes=1, depth_points=int((mp_idx >= 0).sum()))
        m.set_kf_matches(kf_id, mp_idx)
        if self.enable_planes:
            P = self.cfg.caps.max_planes_frame
            self._kf_planes(kf_id, dt.pull_planes(result), np.full(P, -1, np.int32))
        if self.enable_lines:
            self._kf_lines(kf_id, dt.pull_lines(result))
        self.ref_kf = kf_id
        self.last_kf_frame_id = self.frame_id
        self.state = OK
        if self.on_keyframe is not None:
            self.on_keyframe(kf_id)
        self.refresh_view()

    def refresh_view(self) -> None:
        """Bring the device map view up to the host map (row diff)."""
        host = dt.build_host_view(self.cfg, self.map, self.ref_kf, self.reg2, self.reg3)
        if self.view is None:
            self.view = dt.upload_view(host, self.device)
        else:
            self.view = dt.apply_view_update(self.view, dt.diff_host_views(self._shadow, host))
        self._shadow = host

    # --------------------------------------------------------------- reloc
    def _relocalize(self, result: dict) -> bool:
        """Relocalize the lost frame from its features: on success the pose,
        a fresh carry from it, and the reference keyframe moved to the
        keyframe that matched."""
        if self.reloc_module is None:
            return False
        T = self.reloc_module.relocalize(result["feats"])
        if T is None:
            return False
        self.T_cw = T.astype(np.float32)
        self.carry = dt.init_carry(self.cfg, self.device, self.T_cw, vo_points=True)
        self.n_inliers = 50
        self.last_reloc_frame_id = self.frame_id
        self._ref_matches = None
        self.counts["relocalized"] += 1
        kf = self.reloc_module.last_kf
        if kf >= 0 and self.map.kf_valid[kf]:
            self._set_ref_kf(int(kf))
        return True

    def _set_ref_kf(self, kf: int) -> None:
        """Make kf the reference keyframe, in the view and its shadow."""
        m = self.map
        self.ref_kf = kf
        if self.view is not None:
            self.view = dt.set_ref_kf(self.view, m, kf)
            self._shadow["ref_desc"] = m.kf_desc[kf].copy()
            self._shadow["ref_angle"] = m.kf_angle[kf].copy()
            self._shadow["ref_mp"] = m.kf_mp_idx[kf].copy()

    # ---------------------------------------------------------- export etc.
    def _on_kf_retired(self, kf: int, parent: int) -> None:
        """Re-anchor the records of a retired keyframe on its spanning-tree
        parent, T_cr' = T_cr T_kf inv(T_parent) (the eager form of the
        reference's replay chain, System.cc:221-224), and the reference
        keyframe with them; the slot can then be reused."""
        m = self.map
        self._ref_matches = None
        M = (m.kf_pose[kf] @ np.linalg.inv(m.kf_pose[parent])).astype(np.float32)
        for r in self.records:
            if r.ref_kf == kf:
                r.T_cr = r.T_cr @ M
                r.ref_kf = parent
        if self.ref_kf == kf:
            self._set_ref_kf(parent)

    def _record(self, timestamp: float, lost: bool) -> None:
        T_ref = self.map.kf_pose[self.ref_kf]
        if lost:
            T_cr = self.records[-1].T_cr if self.records else np.eye(4, dtype=np.float32)
        else:
            T_cr = (self.T_cw @ np.linalg.inv(T_ref)).astype(np.float32)
        self.records.append(FrameRecord(timestamp, self.ref_kf, T_cr, lost))

    def trajectory_rows(self):
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
