"""Frame lines for the modular tracker: detection, map association,
landmark bookkeeping (counterpart of manhattanslam_tpu/frontend/lines_module.py).

- LSDextractor + LBD (LSDextractor.cpp)      -> ops/lines.detect_lines and
                                                line_descriptors
- Frame::Obtain3DLine (Frame.cc:528-603)     -> ops/lines.lift_lines_3d
- LSDmatcher::SearchByDescriptor/Projection
  (LSDmatcher.cpp:21-199, :201-234)          -> match (cosine NN ratio,
                                                projected angle and midpoint
                                                gates, the MAD threshold)
- MapLine creation and observation (Tracking.cc:1588-1618, <= 30 new
  per keyframe)                              -> on_keyframe

Detection, descriptors and lifting run on the device and are pulled once
per frame; association and bookkeeping run in numpy on the host, as in
the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend import tracking_ops
from manhattanslam_tpu_torch.frontend.device_tracker import to_device
from manhattanslam_tpu_torch.ops import lines as line_ops
from manhattanslam_tpu_torch.slam_map import SlamMap


class LineModule:
    def __init__(self, cfg: SlamConfig, slam_map: SlamMap, device):
        self.cfg = cfg
        self.map = slam_map
        self.device = torch.device(device)
        self.K = np.asarray(cfg.camera.K)
        self.K_t = to_device(self.K.astype(np.float32), self.device)
        self.frame_lines: dict | None = None
        self.assoc: np.ndarray | None = None

    def process_frame(self, gray, depth, T_est: np.ndarray) -> None:
        """Detect, describe and lift the frame's lines (gray, depth: (H, W)
        arrays or tensors on the device), then associate them at T_est."""
        L = self.cfg.caps.max_lines
        lc = self.cfg.line
        gray = torch.as_tensor(gray, dtype=torch.float32, device=self.device)
        depth = torch.as_tensor(depth, dtype=torch.float32, device=self.device)
        det = line_ops.detect_lines(gray, L, lc.mag_threshold, float(lc.min_support),
                                    lc.min_density, lc.min_length)
        desc = line_ops.line_descriptors(gray, det["sp"], det["ep"])
        lifted = line_ops.lift_lines_3d(depth, self.K_t, det["sp"], det["ep"], det["valid"])
        self.frame_lines = {k: v.cpu().numpy() for k, v in {
            "sp": det["sp"], "ep": det["ep"], "eq": det["eq"], "valid": det["valid"],
            "desc": desc, "sp3": lifted["sp3"], "ep3": lifted["ep3"], "has3d": lifted["ok"],
        }.items()}
        self.match(T_est)

    # ------------------------------------------------------------- matching
    def match(self, T_est: np.ndarray) -> int:
        """Associate the frame's lines with the map lines projected at
        T_est (IncreaseVisible / IncreaseFound on the map lines); returns
        the associated count."""
        fl = self.frame_lines
        m = self.map
        L = self.cfg.caps.max_lines
        self.assoc = np.full(L, -1, np.int32)
        ml_ids = np.nonzero(m.ml_valid)[0]
        if len(ml_ids) == 0 or fl is None:
            return 0
        R, t = T_est[:3, :3], T_est[:3, 3]
        K = self.K

        def proj(p):
            pc = p @ R.T + t
            z = np.maximum(pc[:, 2], 1e-6)
            return np.stack([pc[:, 0] / z * K[0, 0] + K[0, 2],
                             pc[:, 1] / z * K[1, 1] + K[1, 2]], -1), pc[:, 2]

        sp2, z1 = proj(m.ml_sp[ml_ids])
        ep2, z2 = proj(m.ml_ep[ml_ids])
        front = (z1 > 0.05) & (z2 > 0.05)
        mid_map = 0.5 * (sp2 + ep2)
        ang_map = np.arctan2(ep2[:, 1] - sp2[:, 1], ep2[:, 0] - sp2[:, 0])

        mid_f = 0.5 * (fl["sp"] + fl["ep"])
        ang_f = np.arctan2(fl["ep"][:, 1] - fl["sp"][:, 1], fl["ep"][:, 0] - fl["sp"][:, 0])

        sim = fl["desc"] @ m.ml_desc[ml_ids, : fl["desc"].shape[1]].T  # (Lf, Lm)
        d_mid = np.linalg.norm(mid_f[:, None, :] - mid_map[None, :, :], axis=-1)
        d_ang = np.abs(((ang_f[:, None] - ang_map[None, :]) + np.pi / 2) % np.pi - np.pi / 2)
        allow = (fl["valid"][:, None] & front[None, :]
                 & (d_mid < self.cfg.line.assoc_mid_px)
                 & (d_ang < np.radians(self.cfg.line.assoc_ang_deg)))
        sim = np.where(allow, sim, -np.inf)

        # MapLine::IncreaseVisible for map lines whose projected midpoint
        # lands inside the image
        h, w = self.cfg.camera.height, self.cfg.camera.width
        vis = (front & (mid_map[:, 0] >= 0) & (mid_map[:, 0] < w)
               & (mid_map[:, 1] >= 0) & (mid_map[:, 1] < h))
        m.ml_visible[ml_ids[vis]] += 1

        # the MAD-adaptive absolute gate over this frame's best similarities
        # (lineDescriptorMAD, LSDmatcher.cpp:384-409), then NN ratio 1/1.5
        best_sim = np.max(sim, axis=1, initial=-np.inf)
        has = np.isfinite(best_sim) & fl["valid"]
        if has.sum() >= 4:
            med = np.median(best_sim[has])
            mad = np.median(np.abs(best_sim[has] - med))
            thr = min(0.7, med - 1.4826 * 1.5 * mad)
        else:
            thr = 0.7
        n = 0
        for i in range(L):
            if not fl["valid"][i] or sim.shape[1] == 0:
                continue
            order = np.argsort(-sim[i])
            j = int(order[0])
            if not (np.isfinite(sim[i, j]) and sim[i, j] > thr):
                continue
            if len(order) > 1 and np.isfinite(sim[i, order[1]]):
                if (1.0 - sim[i, j]) >= (1.0 - sim[i, order[1]]) / 1.5:
                    continue  # ambiguous (NN ratio)
            self.assoc[i] = ml_ids[j]
            m.ml_found[ml_ids[j]] += 1
            n += 1
        return n

    # ------------------------------------------------------------ LM inputs
    def line_observations(self) -> tracking_ops.LineObs:
        """The pose solver's line rows on the device: two endpoint rows per
        associated frame line (the map line's world endpoint, the frame
        line's image equation)."""
        L = self.cfg.caps.max_lines
        m = self.map
        xw = np.zeros((2 * L, 3), np.float32)
        eq = np.zeros((2 * L, 3), np.float32)
        info = np.zeros(2 * L, np.float32)
        mask = np.zeros(2 * L, bool)
        fl = self.frame_lines
        if fl is not None:
            for i in range(L):
                j = self.assoc[i]
                if j < 0:
                    continue
                xw[2 * i] = m.ml_sp[j]
                xw[2 * i + 1] = m.ml_ep[j]
                eq[2 * i] = eq[2 * i + 1] = fl["eq"][i]
                info[2 * i] = info[2 * i + 1] = 1.0
                mask[2 * i] = mask[2 * i + 1] = True
        return tracking_ops.LineObs(*(to_device(a, self.device) for a in (xw, eq, info, mask)))

    # ------------------------------------------------------------ keyframes
    def on_keyframe(self, kf_id: int, T_cw: np.ndarray, max_new: int = 30) -> None:
        """An associated line with a 3D segment refines its map line; an
        unassociated one with a 3D segment becomes a map line in the lowest
        free slot, at most max_new per keyframe."""
        fl = self.frame_lines
        if fl is None:
            return
        m = self.map
        T_wc = np.linalg.inv(T_cw)

        def world(p):
            return p @ T_wc[:3, :3].T + T_wc[:3, 3]

        n_new = 0
        for i in range(self.cfg.caps.max_lines):
            if not fl["valid"][i]:
                continue
            j = int(self.assoc[i])
            if j >= 0:
                if fl["has3d"][i]:
                    m.observe_line(j, world(fl["sp3"][i]), world(fl["ep3"][i]), fl["desc"][i])
                m.ml_n_obs[j] += 1
            elif fl["has3d"][i] and n_new < max_new:
                free = np.nonzero(~m.ml_valid)[0]
                if len(free) == 0:
                    break
                j = int(free[0])
                m.ml_sp[j] = world(fl["sp3"][i])
                m.ml_ep[j] = world(fl["ep3"][i])
                m.ml_desc[j, : fl["desc"].shape[1]] = fl["desc"][i]
                m.ml_valid[j] = True
                m.ml_n_obs[j] = 1
                m.ml_first_kf[j] = kf_id
                self.assoc[i] = j
                n_new += 1
            else:
                continue
            m.kf_ml_idx[kf_id, i] = j
