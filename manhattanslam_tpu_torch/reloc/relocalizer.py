"""Relocalization: place recognition and pose recovery after a tracking
loss (counterpart of manhattanslam_tpu/reloc/relocalizer.py, replacing
the reference's DBoW2 KeyFrameDatabase and Tracking::Relocalization,
Tracking.cc:1909-2055).

- Words: each descriptor's 256 bits (as +-1) project onto 4 banks of 12
  random hyperplanes, one 12-bit word per bank; a keyframe keeps its 4
  L1-normalized word histograms.  A candidate's score is the
  IDF-weighted dot product with the lost frame's histograms, accumulated
  over its covisible neighbours, kept within 0.75 of the best
  (KeyFrameDatabase.cc:120-160).  Host numpy, as in the reference; the
  hyperplanes come from numpy's seed 1234, so both packages draw the
  same ones.
- Pose: the lost frame's descriptors are matched (TH_LOW, NN ratio 0.75)
  against each candidate's map points; 3D-3D RANSAC on the depth-valid
  matches, or EPnP RANSAC when fewer than 10 have depth
  (ops/ransac_pose.py); the full LM refine; below 50 inliers a
  projection search at 10 px, then 3 px (Tracking.cc:1960-2046).  A
  pose is accepted at >= 50 inliers, or >= 20 and at least half the
  matches.

The reference's ``warm`` compiles XLA programs ahead of a timed run; an
eager torch program has nothing to compile, so there is no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend import tracking_ops
from manhattanslam_tpu_torch.frontend.device_tracker import to_device
from manhattanslam_tpu_torch.frontend.frame import backproject_keypoints
from manhattanslam_tpu_torch.ops import lm, matching, ransac_pose
from manhattanslam_tpu_torch.slam_map import SlamMap

N_BITS = 12  # hyperplane bits per bank
N_WORDS = 1 << N_BITS  # words per bank
N_BANKS = 4  # independent LSH banks
RANSAC_SEED = 7
CAND_CAP = 4096  # frustum candidates of the projection search


class Relocalizer:
    def __init__(self, cfg: SlamConfig, slam_map: SlamMap, device: torch.device):
        self.cfg = cfg
        self.map = slam_map
        self.device = device
        rng = np.random.default_rng(1234)
        self.planes_np = rng.normal(size=(256, N_BANKS * N_BITS)).astype(np.float32)
        self.kf_bow = np.zeros((cfg.caps.max_keyframes, N_BANKS * N_WORDS), np.float32)
        self.params = lm.default_params(cfg)
        self.K = torch.as_tensor(cfg.camera.K, dtype=torch.float32, device=device)
        self.bf = float(cfg.camera.bf)
        self.generator = torch.Generator(device=device).manual_seed(RANSAC_SEED)
        self.last_kf = -1  # the keyframe the last relocalization matched
        self.last_path = None  # "3d3d" or "pnp", the last accepted pose's RANSAC

    def reset(self, slam_map: SlamMap) -> None:
        self.map = slam_map
        self.kf_bow[:] = 0

    # ----------------------------------------------------------------- BoW
    def compute_bow(self, desc, valid) -> np.ndarray:
        """The 4 banks' L1-normalized word histograms, concatenated, of
        descriptors desc (N, 8) 32-bit words and their mask valid (N,)."""
        desc = np.ascontiguousarray(desc)
        # (N, 8) words -> (N, 256) bits, little-endian within each word
        bits = np.unpackbits(desc.view(np.uint8), axis=-1, bitorder="little").astype(np.float32)
        proj = ((2.0 * bits - 1.0) @ self.planes_np).reshape(-1, N_BANKS, N_BITS)
        words = ((proj > 0) << np.arange(N_BITS)[None, None]).sum(-1)
        flat = (words + N_WORDS * np.arange(N_BANKS)[None]).ravel()
        hist = np.zeros(N_BANKS * N_WORDS, np.float32)
        np.add.at(hist, flat, np.repeat(np.asarray(valid).astype(np.float32), N_BANKS))
        return hist / max(hist.sum(), 1e-9)

    def add_keyframe(self, kf_id: int) -> None:
        self.kf_bow[kf_id] = self.compute_bow(self.map.kf_desc[kf_id], self.map.kf_kp_valid[kf_id])

    def detect_candidates(self, desc: np.ndarray, valid: np.ndarray, max_cand: int = 5) -> list[int]:
        """DetectRelocalizationCandidates: keyframes by IDF-weighted word
        score accumulated over their covisible neighbours (weight >= 15),
        those within 0.75 of the best, best first."""
        m = self.map
        if m.n_kf == 0:
            return []
        q = self.compute_bow(desc, valid)
        kfb = self.kf_bow[: m.n_kf]
        live = m.kf_valid[: m.n_kf]
        n_valid = max(int(live.sum()), 1)
        df = (kfb > 0).astype(np.float32).T @ live.astype(np.float32)
        # smoothed: a word in every keyframe still scores > 0
        idf = np.log1p(n_valid / (1.0 + df)).astype(np.float32)
        scores = kfb @ (q * idf * idf) * live
        if scores.max() <= 0:
            return []
        W = m.covis[: m.n_kf, : m.n_kf] * live[None, :]
        k10 = min(10, max(m.n_kf - 1, 1))
        top = np.argpartition(-W, k10 - 1, axis=1)[:, :k10]
        w_top = np.take_along_axis(W, top, axis=1)
        acc = scores + (scores[top] * (w_top >= 15)).sum(axis=1)
        acc = np.where(scores > 0, acc, 0.0)
        cands = np.nonzero(acc >= 0.75 * acc.max())[0]
        return cands[np.argsort(-acc[cands])][:max_cand].tolist()

    # ---------------------------------------------------------------- pose
    def relocalize(self, feats: dict) -> np.ndarray | None:
        """T_cw (4, 4) of the lost frame whose features (the step's
        ``feats``, on the device) match a candidate keyframe's map points,
        or None."""
        m = self.map
        dev = self.device
        desc = feats["desc"].cpu().numpy().view(np.uint32)
        pts_c_all = backproject_keypoints(feats, self.cfg)
        for kf in self.detect_candidates(desc, feats["valid"].cpu().numpy()):
            ids = m.kf_mp_idx[kf]
            safe = np.maximum(ids, 0)
            pts_valid = (ids >= 0) & m.mp_valid[safe]
            if pts_valid.sum() < 15:
                continue
            pos = to_device(m.mp_pos[safe], dev)
            valid_t = to_device(pts_valid, dev)
            idx, dist, ok = matching.match_descriptors(
                to_device(m.mp_desc[safe], dev), feats["desc"], valid_t, feats["valid"],
                max_dist=matching.TH_LOW, ratio=0.75,
            )
            ok = matching.resolve_one_to_one(idx, dist, ok, feats["desc"].shape[0])
            n_ok = int(ok.sum())
            if n_ok < 15:
                continue
            kp = idx.long()
            uv = feats["xy_und"][kp]
            # 3D-3D on the depth-valid matches; the depthless EPnP path when
            # fewer than 10 have depth
            use = ok & (feats["depth"][kp] > 0)
            if int(use.sum()) >= 10:
                res = ransac_pose.pose_ransac_3d3d(pos, pts_c_all[kp], uv, use, self.K,
                                                   self.generator)
                path = "3d3d"
            else:
                res = ransac_pose.pose_ransac_pnp(pos, uv, ok, self.K, self.generator)
                path = "pnp"
            if not bool(res["ok"]):
                continue
            T0 = torch.eye(4, dtype=torch.float32, device=dev)
            T0[:3, :3] = res["R"]
            T0[:3, 3] = res["t"]
            prob = tracking_ops.build_point_problem(pos, idx, ok, feats)
            out = lm.solve_pose(prob, T0[None], self.K, self.bf, self.params)
            n_in = int(out["n_inliers"][0])
            T_best = out["T"]
            if 10 <= n_in < 50:
                # the widen-then-narrow projection search from the pose in
                # hand (Tracking.cc:1960-2046)
                f1 = {k: v[None] for k, v in feats.items()}
                bank = {"pos": pos[None], "desc": to_device(m.mp_desc[safe], dev)[None],
                        "valid": valid_t[None], "level": to_device(m.mp_level[safe], dev)[None]}
                hw = (self.cfg.camera.height, self.cfg.camera.width)
                for radius in (10.0, 3.0):
                    cand = matching.frustum_candidates(
                        bank, T_best, self.K, hw, CAND_CAP,
                        scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
                    )
                    out2 = tracking_ops.track_projection(
                        bank, T_best, f1, self.K, self.bf, radius, hw, cand,
                        scale_factor=self.cfg.orb.scale_factor, bank_stats=False,
                        params=self.params,
                    )
                    n2 = int(out2["n_pt_inliers"][0])
                    if n2 > n_in:
                        n_in, T_best = n2, out2["T"]
                    if n_in >= 50:
                        break
            if n_in >= 50 or (n_in >= 20 and n_in >= 0.5 * n_ok):
                # the caller re-anchors its reference keyframe here
                self.last_kf = kf
                self.last_path = path
                return T_best[0].cpu().numpy()
        return None
