"""The world model's point, line, plane and keyframe tables and the
Manhattan registries (counterpart of manhattanslam_tpu/slam_map.py).

Capacity-bounded numpy arrays with validity masks on the host, exactly the
reference package's layout; the tracker uploads a device view of the
tracking-relevant rows (frontend/device_tracker.py).  Descriptors are
kept as uint32 words here and cross to the device as int32 with the same
bits.  The Manhattan registries map unordered plane-id pairs and triples
to the keyframe that first saw them mutually perpendicular (Map.cc:247-285).
A culled keyframe retires its slot for reuse (KeyFrame::SetBadFlag).
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

        # --- map lines (MapLine.h) ---
        L = c.max_map_lines
        self.ml_sp = np.zeros((L, 3), np.float32)
        self.ml_ep = np.zeros((L, 3), np.float32)
        self.ml_desc = np.zeros((L, 32), np.float32)  # float band descriptor
        self.ml_valid = np.zeros(L, bool)
        self.ml_n_obs = np.zeros(L, np.int32)
        self.ml_visible = np.ones(L, np.int32)
        self.ml_found = np.ones(L, np.int32)
        self.ml_first_kf = np.full(L, -1, np.int32)

        # --- map planes (MapPlane.h) ---
        PL = c.max_map_planes
        self.pl_coeffs = np.zeros((PL, 4), np.float32)  # world Hesse, w >= 0
        self.pl_pts = np.zeros((PL, c.max_map_plane_points, 3), np.float32)
        self.pl_n_pts = np.zeros(PL, np.int32)
        self.pl_valid = np.zeros(PL, bool)
        self.pl_n_obs = np.zeros(PL, np.int32)
        self.pl_first_kf = np.full(PL, -1, np.int32)
        self.pl_color = np.zeros((PL, 3), np.float32)

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
        self.kf_ml_idx = np.full((KF, c.max_lines), -1, np.int32)  # frame line -> map line
        self.kf_pl_idx = np.full((KF, c.max_planes_frame), -1, np.int32)
        # per-KF camera-frame plane observations (DetectManhattan's MFm,
        # Tracking.cc:731-738)
        self.kf_plane_coeffs = np.zeros((KF, c.max_planes_frame, 4), np.float32)
        self.kf_plane_npts = np.zeros((KF, c.max_planes_frame), np.int32)
        # covisibility weight matrix (shared map points, KeyFrame.cc:273)
        self.covis = np.zeros((KF, KF), np.int32)
        # spanning tree parent (KeyFrame mTcp chain for trajectory replay)
        self.kf_parent = np.full(KF, -1, np.int32)

        self.n_kf = 0  # high-water mark of allocated keyframe slots
        self.kf_free: list[int] = []  # retired slots available for reuse
        self.last_kf_added = -1  # spanning-tree parent for the next KF
        # observers told (kf, parent) before a keyframe slot is retired:
        # the tracker re-anchors its trajectory records
        self.kf_retire_callbacks: list = []

        # Manhattan registries: sorted plane-id tuple -> kf id
        self.manhattan_pairs: dict[tuple, int] = {}
        self.manhattan_triples: dict[tuple, int] = {}
        # keyframes pinned by the registries (SetNotErase, Map.cc:253,:273)
        self.kf_not_erase: set[int] = set()
        self._rng = np.random.default_rng(0)  # plane colours

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

    def erase_points(self, idx: np.ndarray) -> None:
        """Invalidate map points and drop every keyframe's reference to them."""
        self.mp_valid[idx] = False
        if self.n_kf:
            mask = np.isin(self.kf_mp_idx[: self.n_kf], idx)
            self.kf_mp_idx[: self.n_kf][mask] = -1

    # ---------------------------------------------------------------- lines
    def observe_line(self, j: int, sp_w: np.ndarray, ep_w: np.ndarray, desc: np.ndarray) -> None:
        """Refine map line j with a world-frame observation (the
        MapLine::UpdateAverageDir and descriptor-refresh analog): running
        averages of the direction and centre over the observations, the
        extent grown to cover every endpoint along the averaged direction,
        and the float descriptor tracking the normalized observation mean."""
        n = max(int(self.ml_n_obs[j]), 1)
        d_old = self.ml_ep[j] - self.ml_sp[j]
        len_old = float(np.linalg.norm(d_old))
        if len_old < 1e-9:
            self.ml_sp[j], self.ml_ep[j] = sp_w, ep_w
            return
        d_new = ep_w - sp_w
        if float(d_new @ d_old) < 0:  # orient consistently
            sp_w, ep_w, d_new = ep_w, sp_w, -d_new
        dir_old = d_old / len_old
        nn = float(np.linalg.norm(d_new))
        if nn < 1e-9:
            return
        dir_avg = dir_old * n + d_new / nn
        dir_avg = dir_avg / max(float(np.linalg.norm(dir_avg)), 1e-9)
        center = (0.5 * (self.ml_sp[j] + self.ml_ep[j]) * n + 0.5 * (sp_w + ep_w)) / (n + 1)
        t = (np.stack([self.ml_sp[j], self.ml_ep[j], sp_w, ep_w]) - center) @ dir_avg
        self.ml_sp[j] = (center + t.min() * dir_avg).astype(np.float32)
        self.ml_ep[j] = (center + t.max() * dir_avg).astype(np.float32)
        k = desc.shape[0]
        mean = (self.ml_desc[j, :k] * n + desc) / (n + 1)
        nm = float(np.linalg.norm(mean))
        if nm > 1e-9:
            self.ml_desc[j, :k] = (mean / nm).astype(np.float32)

    # --------------------------------------------------------------- planes
    def add_plane(self, coeffs: np.ndarray, pts: np.ndarray, kf_id: int) -> int:
        """A new map plane in the lowest free slot; returns its id."""
        free = np.nonzero(~self.pl_valid)[0]
        if len(free) == 0:
            raise RuntimeError("map plane capacity exhausted")
        i = int(free[0])
        self.pl_coeffs[i] = coeffs
        k = min(len(pts), self.pl_pts.shape[1])
        self.pl_pts[i, :k] = pts[:k]
        self.pl_n_pts[i] = k
        self.pl_valid[i] = True
        self.pl_n_obs[i] = 1
        self.pl_first_kf[i] = kf_id
        self.pl_color[i] = self._rng.uniform(0.2, 1.0, 3)
        return i

    def merge_plane_points(self, i: int, pts: np.ndarray, voxel: float = 0.2) -> None:
        """MapPlane::UpdateCoefficientsAndPoints (MapPlane.cc:178-218):
        merge, voxel-downsample, cap, and refit the coefficients by least
        squares on the merged cloud, keeping the original orientation."""
        cur = self.pl_pts[i, : self.pl_n_pts[i]]
        allp = np.concatenate([cur, pts], 0)
        key = np.floor(allp / voxel).astype(np.int64)
        _, keep = np.unique(key, axis=0, return_index=True)
        allp = allp[np.sort(keep)]
        cap = self.pl_pts.shape[1]
        if len(allp) > cap:
            allp = allp[np.linspace(0, len(allp) - 1, cap).astype(int)]
        self.pl_pts[i, : len(allp)] = allp
        self.pl_n_pts[i] = len(allp)
        if len(allp) >= 8:
            mean = allp.mean(0)
            cen = allp - mean
            _, v = np.linalg.eigh(cen.T @ cen / len(allp))
            n = v[:, 0]  # smallest-eigenvalue direction
            if float(n @ self.pl_coeffs[i, :3]) < 0:
                n = -n
            self.pl_coeffs[i] = np.concatenate([n, [-float(n @ mean)]]).astype(np.float32)

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
        self.kf_ml_idx[i] = -1
        self.kf_pl_idx[i] = -1
        self.kf_plane_coeffs[i] = 0
        self.kf_plane_npts[i] = 0
        self.covis[i, :] = 0
        self.covis[:, i] = 0
        self.kf_parent[i] = self.last_kf_added
        self.last_kf_added = i
        return i

    def retire_keyframe(self, kf: int) -> None:
        """KeyFrame::SetBadFlag: the observers re-anchor onto the spanning-tree
        parent, the keyframe's observations and covisibility clear, its
        children reattach to the parent and the slot becomes reusable.  The
        root (no parent) is never retired, as the reference never retires
        keyframe 0."""
        parent = int(self.kf_parent[kf])
        if parent < 0:
            return
        for cb in self.kf_retire_callbacks:
            cb(kf, parent)
        self.kf_valid[kf] = False
        self.kf_mp_idx[kf] = -1
        self.kf_ml_idx[kf] = -1
        self.kf_pl_idx[kf] = -1
        self.kf_plane_coeffs[kf] = 0
        self.kf_plane_npts[kf] = 0
        self.covis[kf, :] = 0
        self.covis[:, kf] = 0
        self.kf_parent[self.kf_parent == kf] = parent
        if self.last_kf_added == kf:
            self.last_kf_added = parent
        self.kf_free.append(kf)

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

    def covisible_kfs(self, kf_id: int, min_weight: int = 15) -> np.ndarray:
        """Live keyframes sharing >= min_weight points with kf_id, by
        decreasing weight (numpy's argsort, whose tie order the reference
        shares)."""
        w = self.covis[kf_id, : self.n_kf].copy()
        w[~self.kf_valid[: self.n_kf]] = 0
        order = np.argsort(-w)
        return order[w[order] >= min_weight]

    # --------------------------------------------------- Manhattan registry
    @staticmethod
    def _key(*ids: int) -> tuple:
        return tuple(sorted(int(i) for i in ids))

    def add_manhattan_pair(self, p1: int, p2: int, kf_id: int) -> None:
        key = self._key(p1, p2)
        if key not in self.manhattan_pairs:
            self.manhattan_pairs[key] = kf_id
            self.kf_not_erase.add(kf_id)

    def add_manhattan_triple(self, p1: int, p2: int, p3: int, kf_id: int) -> None:
        key = self._key(p1, p2, p3)
        if key not in self.manhattan_triples:
            self.manhattan_triples[key] = kf_id
            self.kf_not_erase.add(kf_id)
