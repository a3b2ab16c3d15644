"""Frame planes for the modular tracker: extraction, map association,
Manhattan frames (counterpart of manhattanslam_tpu/frontend/planes_module.py).

- Frame::ExtractPlanes (Frame.cc:605-654)        -> process_frame
  (ops/planes.extract_planes, the device path and one pull)
- PlaneMatcher::SearchMapByCoefficients
  (PlaneMatcher.cpp:31-93)                       -> match
- Tracking::DetectManhattan (Tracking.cc:651-844) -> detect_manhattan
- plane landmarks and Manhattan registration on keyframes
  (Tracking.cc:1620-1645, LocalMapping.cc:160-218) -> on_keyframe

Everything but the extraction runs in numpy on the host, as in the
reference; ``plane_observations`` hands the pose solver its rows as
tensors on the tracker's device.
"""

from __future__ import annotations

import numpy as np
import torch

from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend import tracking_ops
from manhattanslam_tpu_torch.frontend.device_tracker import to_device
from manhattanslam_tpu_torch.ops import planes as plane_ops
from manhattanslam_tpu_torch.ops.planes import transform_plane_np
from manhattanslam_tpu_torch.slam_map import SlamMap


class PlaneModule:
    def __init__(self, cfg: SlamConfig, slam_map: SlamMap, device):
        self.cfg = cfg
        self.map = slam_map
        self.device = torch.device(device)
        self.K = np.asarray(cfg.camera.K)
        # per-frame state (refreshed by process_frame)
        self.frame_planes: dict | None = None
        self.assoc: np.ndarray | None = None
        self.par_id: np.ndarray | None = None
        self.ver_id: np.ndarray | None = None
        self.new_plane = False
        self.manhattan_Rcw: np.ndarray | None = None
        self.full_manhattan = False

    # ------------------------------------------------------------- pipeline
    def process_frame(self, depth, T_cw_est: np.ndarray) -> None:
        """Extract planes (depth: (H, W) metres, an array or a tensor on
        the device), associate them with the map, detect Manhattan."""
        c = self.cfg.caps
        self.frame_planes = plane_ops.extract_planes(
            depth, self.K, c.max_planes_frame, c.max_plane_points,
            dist_th=self.cfg.plane.distance_threshold, device=self.device,
        )
        self.match(T_cw_est)
        self.manhattan_Rcw = self.detect_manhattan()

    # ------------------------------------------------------------- matching
    def match(self, T_cw_est: np.ndarray) -> int:
        """SearchMapByCoefficients: fills assoc / par_id / ver_id, sets
        new_plane; returns the associated count."""
        fp = self.frame_planes
        m = self.map
        pc = self.cfg.plane
        P = self.cfg.caps.max_planes_frame
        self.assoc = np.full(P, -1, np.int32)
        self.par_id = np.full(P, -1, np.int32)
        self.ver_id = np.full(P, -1, np.int32)
        self.new_plane = False

        map_ids = np.nonzero(m.pl_valid)[0]
        T_wc = np.linalg.inv(T_cw_est)
        n_matches = 0
        for i in range(P):
            if not fp["valid"][i]:
                continue
            pi_w = transform_plane_np(T_wc, fp["coeffs"][i])
            best_d = pc.association_dis_ref
            best_ver = pc.vertical_threshold
            best_par = pc.parallel_threshold
            for j in map_ids:
                pw = m.pl_coeffs[j]
                angle = float(pi_w[:3] @ pw[:3])
                if angle > pc.association_ang_ref:
                    cloud = m.pl_pts[j, : m.pl_n_pts[j]]
                    if len(cloud):
                        dis = float(np.abs(cloud @ pi_w[:3] + pi_w[3]).min())
                        if dis < best_d:
                            best_d = dis
                            self.assoc[i] = j
                            continue
                if -best_ver < angle < best_ver:
                    best_ver = abs(angle)
                    self.ver_id[i] = j
                    continue
                if abs(angle) > best_par:
                    best_par = abs(angle)
                    self.par_id[i] = j
            if self.assoc[i] >= 0:
                n_matches += 1
            else:
                self.new_plane = True
        return n_matches

    # ------------------------------------------------------ Manhattan frame
    def detect_manhattan(self) -> np.ndarray | None:
        """manhattanRcw (3, 3) from the best-supported perpendicular pair or
        triple of associated planes that a keyframe registered, or None
        (Tracking.cc:651-844)."""
        fp = self.frame_planes
        m = self.map
        th = self.cfg.plane.mf_vertical_threshold
        ids = [i for i in range(len(fp["valid"])) if fp["valid"][i] and self.assoc[i] >= 0]
        best = None  # (score, kf, [camera coeffs], [keyframe coeffs], full)
        self.full_manhattan = False

        def kf_plane_coeff(kf, mp_id):
            slots = np.nonzero(m.kf_pl_idx[kf] == mp_id)[0]
            if len(slots) == 0:
                return None, 0
            s = int(slots[0])
            return m.kf_plane_coeffs[kf, s], int(m.kf_plane_npts[kf, s])

        for a in range(len(ids)):
            i = ids[a]
            ci = fp["coeffs"][i]
            for b in range(a + 1, len(ids)):
                j = ids[b]
                cj = fp["coeffs"][j]
                if abs(float(ci[:3] @ cj[:3])) > th:
                    continue
                for c_ in range(b + 1, len(ids)):  # triples
                    k = ids[c_]
                    ck = fp["coeffs"][k]
                    if abs(float(ci[:3] @ ck[:3])) > th or abs(float(cj[:3] @ ck[:3])) > th:
                        continue
                    kf = m.get_manhattan_triple(self.assoc[i], self.assoc[j], self.assoc[k])
                    if kf is None:
                        continue
                    m1, n1 = kf_plane_coeff(kf, self.assoc[i])
                    m2, n2 = kf_plane_coeff(kf, self.assoc[j])
                    m3, n3 = kf_plane_coeff(kf, self.assoc[k])
                    if m1 is None or m2 is None or m3 is None:
                        continue
                    score = (n1 + n2 + n3 + int(fp["n_support"][i]) + int(fp["n_support"][j])
                             + int(fp["n_support"][k]))
                    if best is None or score > best[0]:
                        best = (score, kf, [ci, cj, ck], [m1, m2, m3], True)
                kf = m.get_manhattan_pair(self.assoc[i], self.assoc[j])  # pairs
                if kf is None:
                    continue
                m1, n1 = kf_plane_coeff(kf, self.assoc[i])
                m2, n2 = kf_plane_coeff(kf, self.assoc[j])
                if m1 is None or m2 is None:
                    continue
                score = n1 + n2 + int(fp["n_support"][i]) + int(fp["n_support"][j])
                if best is None or score > best[0]:
                    best = (score, kf, [ci, cj], [m1, m2], False)

        if best is None:
            return None
        _, kf, cams, kfs, full = best
        self.full_manhattan = full

        def frame_matrix(coeff_list):
            ns = [c[:3].astype(np.float64) for c in coeff_list]
            if len(ns) == 2:
                ns = ns + [np.cross(ns[0], ns[1])]
            M = np.stack(ns, axis=1)  # columns
            if not full and abs(np.linalg.det(M) + 1) < 0.5:
                M[:, 2] = -M[:, 2]
            U, _, Vt = np.linalg.svd(M)
            return U @ Vt

        MFc = frame_matrix(cams)
        MFm = frame_matrix(kfs)
        R_wc_kf = m.kf_pose[kf][:3, :3].T
        R_wc = R_wc_kf @ MFm @ MFc.T
        return R_wc.T.astype(np.float32)  # manhattanRcw

    # ------------------------------------------------------------ LM inputs
    def plane_observations(self) -> tracking_ops.PlaneObs:
        """The pose solver's plane rows (P, 4) on the device: world coeffs
        of the associated, parallel and perpendicular map planes beside the
        observed camera-frame coeffs."""
        P = self.cfg.caps.max_planes_frame
        m = self.map
        z4 = np.zeros((P, 4), np.float32)
        obs = {
            "pl_w": z4.copy(), "pl_obs": z4.copy(), "pl_mask": np.zeros(P, bool),
            "par_w": z4.copy(), "par_obs": z4.copy(), "par_mask": np.zeros(P, bool),
            "ver_w": z4.copy(), "ver_obs": z4.copy(), "ver_mask": np.zeros(P, bool),
        }
        fp = self.frame_planes
        if fp is not None:
            for i in range(P):
                if not fp["valid"][i]:
                    continue
                if self.assoc[i] >= 0:
                    obs["pl_w"][i] = m.pl_coeffs[self.assoc[i]]
                    obs["pl_obs"][i] = fp["coeffs"][i]
                    obs["pl_mask"][i] = True
                # structural edges are independent of the direct association
                # (Optimizer.cc:325-396)
                if self.par_id[i] >= 0:
                    obs["par_w"][i] = m.pl_coeffs[self.par_id[i]]
                    obs["par_obs"][i] = fp["coeffs"][i]
                    obs["par_mask"][i] = True
                if self.ver_id[i] >= 0:
                    obs["ver_w"][i] = m.pl_coeffs[self.ver_id[i]]
                    obs["ver_obs"][i] = fp["coeffs"][i]
                    obs["ver_mask"][i] = True
        return tracking_ops.PlaneObs(**{k: to_device(v, self.device) for k, v in obs.items()})

    # ------------------------------------------------------------ keyframes
    def on_keyframe(self, kf_id: int, T_cw: np.ndarray) -> None:
        """Merge each associated plane's cloud into its map plane, make the
        others map planes, then register the perpendicular pairs and
        triples among this keyframe's planes (LocalMapping.cc:172-218)."""
        fp = self.frame_planes
        if fp is None:
            return
        m = self.map
        T_wc = np.linalg.inv(T_cw)
        P = self.cfg.caps.max_planes_frame
        for i in range(P):
            if not fp["valid"][i]:
                continue
            cloud_w = fp["cloud"][i, : fp["n_pts"][i]] @ T_wc[:3, :3].T + T_wc[:3, 3]
            if self.assoc[i] >= 0:
                j = int(self.assoc[i])
                m.merge_plane_points(j, cloud_w)
                m.pl_n_obs[j] += 1
            else:
                pi_w = transform_plane_np(T_wc, fp["coeffs"][i])
                if (~m.pl_valid).sum() == 0:
                    continue
                j = m.add_plane(pi_w, cloud_w, kf_id)
                self.assoc[i] = j
            m.kf_pl_idx[kf_id, i] = j
            m.kf_plane_coeffs[kf_id, i] = fp["coeffs"][i]
            m.kf_plane_npts[kf_id, i] = fp["n_support"][i]

        th = self.cfg.plane.mf_vertical_threshold
        ids = [i for i in range(P) if fp["valid"][i] and self.assoc[i] >= 0]
        for a in range(len(ids)):
            i = ids[a]
            ni = fp["coeffs"][i][:3]
            for b in range(a + 1, len(ids)):
                j = ids[b]
                nj = fp["coeffs"][j][:3]
                if abs(float(ni @ nj)) > th:
                    continue
                m.add_manhattan_pair(self.assoc[i], self.assoc[j], kf_id)
                for c_ in range(b + 1, len(ids)):
                    k = ids[c_]
                    nk = fp["coeffs"][k][:3]
                    if abs(float(ni @ nk)) > th or abs(float(nj @ nk)) > th:
                        continue
                    m.add_manhattan_triple(self.assoc[i], self.assoc[j], self.assoc[k], kf_id)
