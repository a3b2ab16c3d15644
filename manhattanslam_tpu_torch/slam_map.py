"""The world model's point and keyframe tables (counterpart of
manhattanslam_tpu/slam_map.py).

Capacity-bounded numpy arrays with validity masks on the host, exactly the
reference package's layout; the tracker uploads a device view of the
tracking-relevant rows (frontend/device_tracker.py).  Descriptors are
kept as uint32 words here and cross to the device as int32 with the same
bits.  Lines, planes, the Manhattan registries and keyframe retirement
come with the slices that use them.
"""

from __future__ import annotations

import numpy as np

from manhattanslam_tpu_torch.config import SlamConfig


class SlamMap:
    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        c = cfg.caps
        n_kp = c.max_keypoints

        # --- map points (MapPoint.h:40-142) ---
        P = c.max_map_points
        self.mp_pos = np.zeros((P, 3), np.float32)
        self.mp_desc = np.zeros((P, 8), np.uint32)
        self.mp_normal = np.zeros((P, 3), np.float32)
        self.mp_min_dist = np.zeros(P, np.float32)
        self.mp_max_dist = np.zeros(P, np.float32)
        self.mp_level = np.zeros(P, np.int32)  # reference octave at creation
        self.mp_valid = np.zeros(P, bool)
        self.mp_n_obs = np.zeros(P, np.int32)
        self.mp_visible = np.ones(P, np.int32)
        self.mp_found = np.ones(P, np.int32)
        self.mp_first_kf = np.full(P, -1, np.int32)

        # --- keyframes (KeyFrame.h) ---
        KF = c.max_keyframes
        self.kf_pose = np.zeros((KF, 4, 4), np.float32)  # Tcw
        self.kf_time = np.zeros(KF, np.float64)
        self.kf_frame_id = np.full(KF, -1, np.int64)
        self.kf_valid = np.zeros(KF, bool)
        self.kf_xy = np.zeros((KF, n_kp, 2), np.float32)  # undistorted
        self.kf_uright = np.zeros((KF, n_kp), np.float32)
        self.kf_depth = np.zeros((KF, n_kp), np.float32)
        self.kf_level = np.zeros((KF, n_kp), np.int32)
        self.kf_angle = np.zeros((KF, n_kp), np.float32)
        self.kf_desc = np.zeros((KF, n_kp, 8), np.uint32)
        self.kf_kp_valid = np.zeros((KF, n_kp), bool)
        self.kf_mp_idx = np.full((KF, n_kp), -1, np.int32)  # kp -> map point
        # covisibility weight matrix (shared map points, KeyFrame.cc:273)
        self.covis = np.zeros((KF, KF), np.int32)
        # spanning tree parent (KeyFrame mTcp chain for trajectory replay)
        self.kf_parent = np.full(KF, -1, np.int32)

        self.n_kf = 0  # high-water mark of allocated keyframe slots
        self.kf_free: list[int] = []  # retired slots available for reuse
        self.last_kf_added = -1  # spanning-tree parent for the next KF

    # ---------------------------------------------------------------- points
    def alloc_points(self, n: int) -> np.ndarray:
        """Allocate n point slots (the lowest free ones); returns indices."""
        free = np.nonzero(~self.mp_valid)[0]
        if len(free) < n:
            raise RuntimeError("map point capacity exhausted")
        return free[:n]

    def add_points(
        self,
        pos: np.ndarray,
        desc: np.ndarray,
        normal: np.ndarray,
        min_dist: np.ndarray,
        max_dist: np.ndarray,
        level: np.ndarray,
        kf_id: int,
    ) -> np.ndarray:
        idx = self.alloc_points(len(pos))
        self.mp_pos[idx] = pos
        self.mp_desc[idx] = desc
        self.mp_normal[idx] = normal
        self.mp_min_dist[idx] = min_dist
        self.mp_max_dist[idx] = max_dist
        self.mp_level[idx] = level
        self.mp_valid[idx] = True
        self.mp_n_obs[idx] = 1
        self.mp_visible[idx] = 1
        self.mp_found[idx] = 1
        self.mp_first_kf[idx] = kf_id
        return idx

    # ------------------------------------------------------------ keyframes
    def add_keyframe(
        self, T_cw: np.ndarray, timestamp: float, frame_id: int, feats_np: dict
    ) -> int:
        """Allocate a keyframe slot (retired slots first) and store the
        frame's pose and features."""
        if self.kf_free:
            i = self.kf_free.pop(0)
        elif self.n_kf < self.cfg.caps.max_keyframes:
            i = self.n_kf
            self.n_kf += 1
        else:
            raise RuntimeError("keyframe capacity exhausted")
        self.kf_valid[i] = True
        self.kf_pose[i] = T_cw
        self.kf_time[i] = timestamp
        self.kf_frame_id[i] = frame_id
        self.kf_xy[i] = feats_np["xy_und"]
        self.kf_uright[i] = feats_np["u_right"]
        self.kf_depth[i] = feats_np["depth"]
        self.kf_level[i] = feats_np["level"]
        self.kf_angle[i] = feats_np["angle"]
        self.kf_desc[i] = feats_np["desc"]
        self.kf_kp_valid[i] = feats_np["valid"]
        self.kf_mp_idx[i] = -1
        self.covis[i, :] = 0
        self.covis[:, i] = 0
        self.kf_parent[i] = self.last_kf_added
        self.last_kf_added = i
        return i

    def set_kf_matches(self, kf_id: int, mp_idx: np.ndarray) -> None:
        """Record kp -> map-point association and refresh covisibility."""
        self.kf_mp_idx[kf_id] = mp_idx
        obs = mp_idx[mp_idx >= 0]
        self.mp_n_obs[obs] = np.maximum(self.mp_n_obs[obs], 1)
        self.update_covisibility(kf_id)

    def update_covisibility(self, kf_id: int) -> None:
        """Shared-point counts vs all other keyframes (KeyFrame.cc:273)."""
        mine = self.kf_mp_idx[kf_id]
        member = np.zeros(len(self.mp_valid), bool)
        member[mine[mine >= 0]] = True
        others = self.kf_mp_idx[: self.n_kf]
        hit = member[np.maximum(others, 0)] & (others >= 0)
        w = hit.sum(axis=1).astype(np.int32)
        w[~self.kf_valid[: self.n_kf]] = 0
        w[kf_id] = 0
        self.covis[kf_id, : self.n_kf] = w
        self.covis[: self.n_kf, kf_id] = w
