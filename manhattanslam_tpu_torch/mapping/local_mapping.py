"""The mapping back end (counterpart of
manhattanslam_tpu/mapping/local_mapping.py, reference LocalMapping.cc),
run synchronously on each keyframe event (System._on_keyframe):

1. landmark culling (MapPointCulling :227-263: found/visible < 0.25, or
   <= 2 observations 2 keyframes after creation);
2. new points triangulated against the top covisible keyframes
   (CreateNewMapPoints :303-522) and duplicate fusion over two-hop
   covisibility in both directions (SearchInNeighbors :524-622): both
   device programs are issued, then their results come back in one
   transfer;
3. line fusion, the distinctive-descriptor and normal/depth refresh of
   the keyframe's landmarks, redundant-keyframe culling (KeyFrameCulling
   :704-758), plane and line culling.

The host stages are numpy, as in the reference, with the same numpy
calls where their tie order matters (argsort, unique, isin).  The
device programs (mapping/triangulation.py) take a stack of neighbours
and of fusion targets; the reference's caps stay (10 neighbours, 24
targets, ``max_local_points`` landmarks a bank), but the stacks are not
padded to them: an eager torch program compiles nothing per shape, and
a padding row matches nothing.  Each stage is a host span of ``trace``
(a ``tracing.Recorder``, the System's when a System made the mapper),
named after its method.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from manhattanslam_tpu_torch import tracing
from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend.device_tracker import to_device
from manhattanslam_tpu_torch.mapping import triangulation as tri
from manhattanslam_tpu_torch.slam_map import SlamMap

MAXO = 32  # observations per landmark read by the descriptor refresh


def pull(parts: dict) -> dict:
    """Tensors on the device -> numpy arrays of the same shapes and dtypes
    (bool, int32, float32) in ONE device-to-host transfer: each is packed
    into one int32 buffer (floats by their bits)."""
    flat = []
    for v in parts.values():
        if v.dtype == torch.float32:
            v = v.view(torch.int32)
        flat.append(v.to(torch.int32).reshape(-1))
    host = torch.cat(flat).cpu().numpy() if flat else np.zeros(0, np.int32)
    out, at = {}, 0
    for k, v in parts.items():
        a = host[at: at + v.numel()].reshape(tuple(v.shape))
        at += v.numel()
        if v.dtype == torch.bool:
            a = a > 0
        elif v.dtype == torch.float32:
            a = a.view(np.float32)
        out[k] = a
    return out


def kf_feats(m, kfs, device) -> dict:
    """Keyframes kfs' keypoint features (xy, desc, valid, level) stacked,
    on `device` (fuse_candidates' feature view)."""
    sl = np.asarray(kfs, np.int64)
    host = {"xy": m.kf_xy[sl], "desc": m.kf_desc[sl], "valid": m.kf_kp_valid[sl],
            "level": m.kf_level[sl]}
    return {k: to_device(v, device) for k, v in host.items()}


def kf_feats_one(m, kf: int, device=torch.device("cpu")) -> dict:
    """One keyframe's keypoint feature view for fuse_candidates."""
    return {k: v[0] for k, v in kf_feats(m, [kf], device).items()}


class LocalMapper:
    N_TRI_NEIGHBORS = 10  # triangulation neighbours a keyframe event
    N_TG = 24  # fusion targets a keyframe event

    def __init__(self, cfg: SlamConfig, slam_map: SlamMap, device: torch.device,
                 trace: tracing.Recorder | None = None):
        self.cfg = cfg
        self.map = slam_map
        self.device = device
        self.K = torch.as_tensor(cfg.camera.K, dtype=torch.float32, device=device)
        # recently added points on probation: (map point id, birth keyframe)
        self.recent_points: list[tuple[int, int]] = []
        self.trace = trace if trace is not None else tracing.Recorder()
        # events, and points erased, triangulated, fused (new observations)
        # and merged (duplicates dropped), keyframes, planes and lines culled
        self.counts = Counter()

    def process_keyframe(self, kf_id: int) -> None:
        m = self.map
        self.counts["events"] += 1
        born = m.kf_mp_idx[kf_id]
        for mp in born[born >= 0]:
            if m.mp_first_kf[mp] == kf_id:
                self.recent_points.append((int(mp), kf_id))
        for stage in (
            self.cull_map_points,
            self.create_and_fuse,
            self.fuse_lines,
            self.refresh_point_landmarks,
            self.cull_keyframes,
            self.cull_map_planes,
            self.cull_map_lines,
        ):
            with self.trace.span(stage.__name__):
                stage(kf_id)

    def create_and_fuse(self, kf_id: int) -> None:
        """CreateNewMapPoints and SearchInNeighbors with one transfer: both
        halves issue their device programs, then one pull, then each
        applies its part.  The fusion banks come from the tables before
        triangulation, so this keyframe's new points first fuse at the
        next keyframe event, as in the reference package."""
        tri_parts, tri_apply = self.create_new_points(kf_id, defer=True)
        fuse_parts, fuse_apply = self.fuse_neighbors(kf_id, defer=True)
        host = pull({**{"tri_" + k: v for k, v in tri_parts.items()},
                     **{"fuse_" + k: v for k, v in fuse_parts.items()}})

        def group(prefix):
            return {k[len(prefix):]: v for k, v in host.items() if k.startswith(prefix)}

        tri_apply(group("tri_"))
        fuse_apply(group("fuse_"))

    def create_new_points(self, kf_id: int, n_neighbors: int = N_TRI_NEIGHBORS,
                          defer: bool = False):
        """CreateNewMapPoints (LocalMapping.cc:303-521): this keyframe's
        free keypoints triangulated against its covisible keyframes, one
        device program over the neighbour stack, one pull.  defer=True
        returns (the device outputs to pull, apply(pulled)) instead."""
        job = self._tri_dispatch(kf_id, n_neighbors)
        parts = {} if job is None else {k: job[0][k] for k in ("ok", "idx2", "pos_w")}

        def apply(host: dict) -> None:
            if job is not None:
                self._tri_apply(kf_id, host, job[1])

        return (parts, apply) if defer else apply(pull(parts))

    def fuse_neighbors(self, kf_id: int, n_neighbors: int = 10, n_second: int = 5,
                       defer: bool = False):
        """SearchInNeighbors (LocalMapping.cc:524-622): two-hop covisibility
        targets, fused both ways (this keyframe's points into every target
        and the targets' points into this keyframe), one pull.
        defer=True returns (the device outputs to pull, apply(pulled))
        instead."""
        job = self._fuse_dispatch(kf_id, n_neighbors, n_second)
        parts = {}
        if job is not None:
            parts.update({"f1_" + k: job[0][k] for k in ("ok", "kp_idx")})
            if job[1] is not None:
                parts.update({"f2_" + k: job[1][k] for k in ("ok", "kp_idx")})

        def apply(host: dict) -> None:
            if job is not None:
                f2 = {k[3:]: v for k, v in host.items() if k.startswith("f2_")}
                self._fuse_apply(kf_id, {k[3:]: v for k, v in host.items() if k.startswith("f1_")},
                                 f2 or None, job[2])

        return (parts, apply) if defer else apply(pull(parts))

    # -------------------------------------------------------------- culling
    def _obs_counts(self) -> np.ndarray:
        """Observations per map point (one bincount over kf_mp_idx)."""
        m = self.map
        flat = m.kf_mp_idx[: m.n_kf]
        return np.bincount(flat[flat >= 0], minlength=len(m.mp_valid))

    def cull_map_points(self, cur_kf: int) -> None:
        """MapPointCulling (LocalMapping.cc:227-263) over the points on
        probation: found/visible < 0.25, or <= 2 observations two keyframes
        after birth, are erased; three keyframes after birth a point
        graduates."""
        m = self.map
        if not self.recent_points:
            return
        mps = np.array([p for p, _ in self.recent_points])
        born = np.array([b for _, b in self.recent_points])
        alive = m.mp_valid[mps]
        obs = self._obs_counts()[mps]
        ratio = m.mp_found[mps] / np.maximum(m.mp_visible[mps], 1)
        erase = alive & ((ratio < 0.25) | ((cur_kf - born >= 2) & (obs <= 2)))
        keep = alive & ~erase & ~(cur_kf - born >= 3)
        self.recent_points = [(int(p), int(b)) for p, b in zip(mps[keep], born[keep])]
        if erase.any():
            m.erase_points(mps[erase])
            self.counts["erased"] += int(erase.sum())

    def cull_map_planes(self, cur_kf: int) -> None:
        """MapPlaneCulling: a plane with < 3 observations two keyframes
        after birth, seen by fewer than two keyframes, is dropped."""
        m = self.map
        for pl in np.nonzero(m.pl_valid)[0]:
            if cur_kf - m.pl_first_kf[pl] >= 2 and m.pl_n_obs[pl] < 3:
                if int((m.kf_pl_idx[: m.n_kf] == pl).sum()) < 2:
                    m.pl_valid[pl] = False
                    m.kf_pl_idx[m.kf_pl_idx == pl] = -1
                    self.counts["planes_culled"] += 1

    def cull_map_lines(self, cur_kf: int) -> None:
        """MapLineCulling: lines with < 2 observations after their
        probation window, or found/visible < 0.1, are dropped."""
        m = self.map
        ids = np.nonzero(m.ml_valid)[0]
        if len(ids) == 0:
            return
        ratio = m.ml_found[ids] / np.maximum(m.ml_visible[ids], 1)
        erase = (((cur_kf - m.ml_first_kf[ids]) >= 2) & (m.ml_n_obs[ids] < 2)) | (ratio < 0.1)
        if erase.any():
            bad = ids[erase]
            m.ml_valid[bad] = False
            m.kf_ml_idx[np.isin(m.kf_ml_idx, bad)] = -1
            self.counts["lines_culled"] += len(bad)

    # -------------------------------------------------------- triangulation
    def _kf_kp_stack(self, kfs, only_free: bool) -> dict:
        """Keypoint views of the keyframes `kfs` on the device, each with a
        leading axis of len(kfs); only_free keeps keypoints with no map
        point."""
        m = self.map
        sl = np.asarray(kfs, np.int64)
        valid = m.kf_kp_valid[sl].copy()
        if only_free:
            valid &= m.kf_mp_idx[sl] < 0
        lvl = m.kf_level[sl]
        inv_sigma2 = (1.0 / self.cfg.orb.scale_factor ** (2.0 * lvl)).astype(np.float32)
        host = {"xy": m.kf_xy[sl], "desc": m.kf_desc[sl], "valid": valid, "level": lvl,
                "inv_sigma2": inv_sigma2}
        return {k: to_device(v, self.device) for k, v in host.items()}

    def _kf_kp_view(self, kf: int, only_free: bool) -> dict:
        return {k: v[0] for k, v in self._kf_kp_stack([kf], only_free).items()}

    def _tri_dispatch(self, kf_id: int, n_neighbors: int = N_TRI_NEIGHBORS):
        m = self.map
        # the baseline check (LocalMapping.cc:354-372), on the poses'
        # translations as in the reference package
        neighbors = [
            int(nb) for nb in m.covisible_kfs(kf_id)[:n_neighbors]
            if np.linalg.norm(m.kf_pose[kf_id][:3, 3] - m.kf_pose[nb][:3, 3])
            >= self.cfg.camera.baseline
        ][: self.N_TRI_NEIGHBORS]
        if not neighbors:
            return None
        outs = tri.triangulate_pairs(
            self._kf_kp_view(kf_id, only_free=True),
            self._kf_kp_stack(neighbors, only_free=True),
            to_device(m.kf_pose[kf_id], self.device),
            to_device(m.kf_pose[neighbors], self.device),
            self.K, self.cfg.orb.scale_factor,
        )
        return outs, neighbors

    def _tri_apply(self, kf_id: int, outs: dict, neighbors) -> None:
        m = self.map
        claimed = np.zeros(len(m.kf_mp_idx[kf_id]), bool)
        for j, nb in enumerate(neighbors):
            ok = outs["ok"][j] & ~claimed
            if not ok.any():
                continue
            idx1 = np.nonzero(ok)[0]
            n_new = min(len(idx1), int((~m.mp_valid).sum()))
            if n_new == 0:
                break
            idx1 = idx1[:n_new]
            idx2 = outs["idx2"][j][ok][:n_new]
            pos = outs["pos_w"][j][ok][:n_new]
            cam_center = -m.kf_pose[kf_id][:3, :3].T @ m.kf_pose[kf_id][:3, 3]
            dvec = pos - cam_center
            dist = np.linalg.norm(dvec, axis=1).clip(1e-6)
            lvl = m.kf_level[kf_id][idx1]
            sf = self.cfg.orb.scale_factor
            max_d = dist * sf**lvl
            min_d = max_d / sf ** (self.cfg.orb.n_levels - 1)
            ids = m.add_points(pos, m.kf_desc[kf_id][idx1], dvec / dist[:, None], min_d, max_d,
                               lvl, kf_id)
            m.kf_mp_idx[kf_id, idx1] = ids
            m.kf_mp_idx[nb, idx2] = ids
            self.recent_points.extend((int(mp), kf_id) for mp in ids)
            self.counts["triangulated"] += len(ids)
            claimed[idx1] = True
        m.update_covisibility(kf_id)

    # ------------------------------------------------------------- fusion
    def _bank(self, ids: np.ndarray):
        """The landmarks `ids` (at most max_local_points) as a device bank
        (pos, desc, valid) and the ids it holds."""
        m = self.map
        ids = ids[: self.cfg.caps.max_local_points]
        dev = self.device
        return (to_device(m.mp_pos[ids], dev), to_device(m.mp_desc[ids], dev),
                to_device(m.mp_valid[ids], dev), ids.astype(np.int64))

    def _fuse_dispatch(self, kf_id: int, n_neighbors: int = 10, n_second: int = 5):
        """SearchInNeighbors' targets: the first-order covisible keyframes
        and n_second of each one's own (:536-542); this keyframe's points
        into every target and the targets' points into this keyframe."""
        m = self.map
        first = [int(k) for k in m.covisible_kfs(kf_id)[:n_neighbors]]
        targets = list(first)
        seen = {kf_id, *targets}
        for nb in first:
            for nb2 in m.covisible_kfs(nb)[:n_second]:
                nb2 = int(nb2)
                if nb2 not in seen:
                    targets.append(nb2)
                    seen.add(nb2)
        my_ids = m.kf_mp_idx[kf_id]
        my_ids = np.unique(my_ids[my_ids >= 0])
        my_ids = my_ids[m.mp_valid[my_ids]]
        if len(my_ids) == 0 or len(targets) == 0:
            return None
        targets = targets[: self.N_TG]
        h, w = float(self.cfg.camera.height), float(self.cfg.camera.width)
        pos, desc, valid, my_bank = self._bank(my_ids)
        outs1 = tri.fuse_candidates_batch(
            pos, desc, valid, to_device(m.kf_pose[targets], self.device),
            kf_feats(m, targets, self.device), self.K, h, w,
        )
        jobs = [(nb, my_bank, j) for j, nb in enumerate(targets)]
        out2 = None
        tgt_ids = m.kf_mp_idx[targets]
        tgt_ids = np.unique(tgt_ids[tgt_ids >= 0])
        tgt_ids = tgt_ids[m.mp_valid[tgt_ids]]
        tgt_ids = np.setdiff1d(tgt_ids, my_ids, assume_unique=True)
        if len(tgt_ids):
            pos2, desc2, valid2, tgt_bank = self._bank(tgt_ids)
            feats = kf_feats_one(m, kf_id, self.device)
            out2 = tri.fuse_candidates(pos2, desc2, valid2, to_device(m.kf_pose[kf_id], self.device),
                                       feats, self.K, h, w)
            jobs.append((kf_id, tgt_bank, None))
        return outs1, out2, jobs

    def _fuse_apply(self, kf_id: int, outs1: dict, out2, jobs) -> None:
        """A landmark that lands on a free keypoint becomes its observation;
        on a keypoint of another live landmark, the one with fewer
        observations is replaced by the other everywhere."""
        m = self.map
        obs_counts = self._obs_counts()
        for nb, bank_ids, j in jobs:
            out = out2 if j is None else {k: v[j] for k, v in outs1.items()}
            ok = out["ok"]
            if not ok.any():
                continue
            for i in np.nonzero(ok)[0]:
                mp = int(bank_ids[i])
                kp = int(out["kp_idx"][i])
                if not m.mp_valid[mp]:
                    continue
                existing = int(m.kf_mp_idx[nb, kp])
                if existing < 0:
                    m.kf_mp_idx[nb, kp] = mp
                    obs_counts[mp] += 1
                    self.counts["fused"] += 1
                elif existing != mp and m.mp_valid[existing]:
                    lose, win = ((mp, existing) if obs_counts[existing] >= obs_counts[mp]
                                 else (existing, mp))
                    tbl = m.kf_mp_idx[: m.n_kf]
                    tbl[tbl == lose] = win
                    obs_counts[win] += obs_counts[lose]
                    obs_counts[lose] = 0
                    m.mp_valid[lose] = False
                    self.counts["merged"] += 1
        m.update_covisibility(kf_id)

    def fuse_lines(self, kf_id: int, n_neighbors: int = 10) -> None:
        """The line half of SearchInNeighbors (LSDmatcher::Fuse): map lines
        of this keyframe and its neighbours close in space, direction and
        descriptor merge into the better-observed one."""
        m = self.map
        kfs = [kf_id] + [int(k) for k in m.covisible_kfs(kf_id)[:n_neighbors]]
        ids = np.unique(m.kf_ml_idx[kfs])
        ids = ids[ids >= 0]
        ids = ids[m.ml_valid[ids]]
        if len(ids) < 2:
            return
        sp, ep = m.ml_sp[ids], m.ml_ep[ids]
        d = ep - sp
        u = d / np.linalg.norm(d, axis=-1).clip(1e-6)[:, None]
        mid = 0.5 * (sp + ep)
        desc = m.ml_desc[ids]
        dn = desc / np.linalg.norm(desc, axis=-1).clip(1e-9)[:, None]
        lc = self.cfg.line
        dup = (
            (dn @ dn.T > lc.fuse_desc_sim)
            & (np.abs(u @ u.T) > np.cos(np.radians(lc.fuse_ang_deg)))
            & (np.linalg.norm(mid[:, None] - mid[None], axis=-1) < lc.fuse_mid_m)
        )
        np.fill_diagonal(dup, False)
        obs = m.ml_n_obs[ids]
        for a, b in zip(*np.nonzero(np.triu(dup))):
            la, lb = int(ids[a]), int(ids[b])
            if not (m.ml_valid[la] and m.ml_valid[lb]):
                continue
            lose, win = (la, lb) if obs[b] >= obs[a] else (lb, la)
            tbl = m.kf_ml_idx[: m.n_kf]
            tbl[tbl == lose] = win
            m.ml_n_obs[win] += m.ml_n_obs[lose]
            m.ml_found[win] += m.ml_found[lose]
            m.ml_visible[win] += m.ml_visible[lose]
            m.ml_valid[lose] = False

    # ---------------------------------------------------- landmark refresh
    def refresh_point_landmarks(self, kf_id: int) -> None:
        """For this keyframe's landmarks seen by >= 2 keyframes: the
        distinctive descriptor (least median Hamming distance to the other
        observations, MapPoint::ComputeDistinctiveDescriptors), the mean
        viewing direction and the scale band from the first observing
        keyframe (UpdateNormalAndDepth), over at most MAXO observations."""
        m = self.map
        mine = m.kf_mp_idx[kf_id]
        mps = np.unique(mine[mine >= 0])
        mps = mps[m.mp_valid[mps]]
        if len(mps) == 0:
            return
        obs_kf, obs_kp = np.nonzero((m.kf_mp_idx[: m.n_kf] >= 0) & m.kf_valid[: m.n_kf, None])
        obs_mp = m.kf_mp_idx[obs_kf, obs_kp]
        keep = np.isin(obs_mp, mps)
        obs_kf, obs_kp, obs_mp = obs_kf[keep], obs_kp[keep], obs_mp[keep]
        order = np.argsort(obs_mp, kind="stable")
        obs_kf, obs_kp, obs_mp = obs_kf[order], obs_kp[order], obs_mp[order]
        uniq, starts, counts = np.unique(obs_mp, return_index=True, return_counts=True)
        sel = counts >= 2
        uniq, starts, counts = uniq[sel], starts[sel], counts[sel]
        if len(uniq) == 0:
            return
        cnt = np.minimum(counts, MAXO)
        tab = np.minimum(starts[:, None] + np.arange(MAXO)[None], len(obs_mp) - 1)
        valid_o = np.arange(MAXO)[None] < cnt[:, None]
        kfs, kps = obs_kf[tab], obs_kp[tab]
        d64 = np.ascontiguousarray(m.kf_desc[kfs, kps]).view(np.uint64).reshape(len(uniq), MAXO, 4)
        ham = np.bitwise_count(d64[:, :, None, :] ^ d64[:, None, :, :]).sum(-1, dtype=np.int32)
        ham = np.where(valid_o[:, None, :], ham, np.int32(10**6))
        ham.sort(axis=-1)
        # the median of the cnt valid distances, sorted[(cnt - 1) // 2]
        med_idx = (cnt[:, None, None] - 1) // 2
        med = np.take_along_axis(ham, np.broadcast_to(med_idx, ham.shape[:2] + (1,)), axis=-1)[..., 0]
        med = np.where(valid_o, med, np.int32(10**6))
        best = np.argmin(med, axis=1)
        rows = np.arange(len(uniq))
        m.mp_desc[uniq] = m.kf_desc[kfs[rows, best], kps[rows, best]]

        Rt = m.kf_pose[: m.n_kf, :3, :3]
        tt = m.kf_pose[: m.n_kf, :3, 3]
        centers = -np.einsum("kij,kj->ki", Rt.transpose(0, 2, 1), tt)
        rays = m.mp_pos[uniq][:, None, :] - centers[kfs]
        rays /= np.linalg.norm(rays, axis=-1, keepdims=True).clip(1e-9)
        normal = (rays * valid_o[..., None]).sum(1) / cnt[:, None]
        nn = np.linalg.norm(normal, axis=-1)
        ok_n = nn > 1e-6
        m.mp_normal[uniq[ok_n]] = (normal[ok_n] / nn[ok_n, None]).astype(np.float32)

        sf = self.cfg.orb.scale_factor
        ref = m.mp_first_kf[uniq]
        ref_ok = (ref >= 0) & (ref < m.n_kf) & m.kf_valid[np.maximum(ref, 0)]
        in_ref = (kfs == ref[:, None]) & valid_o
        has_ref = in_ref.any(axis=1) & ref_ok
        if has_ref.any():
            first_kp = kps[rows, np.argmax(in_ref, axis=1)]
            dist_ref = np.linalg.norm(m.mp_pos[uniq] - centers[np.maximum(ref, 0)], axis=-1)
            lvl = m.kf_level[np.maximum(ref, 0), first_kp]
            max_d = (dist_ref * sf**lvl).astype(np.float32)
            m.mp_max_dist[uniq[has_ref]] = max_d[has_ref]
            m.mp_min_dist[uniq[has_ref]] = max_d[has_ref] / sf ** (self.cfg.orb.n_levels - 1)

    # --------------------------------------------------------- KF culling
    def cull_keyframes(self, kf_id: int) -> None:
        """KeyFrameCulling (LocalMapping.cc:704-758): a covisible keyframe
        (not the root, not pinned by the Manhattan registries) whose close
        points are > 90% seen by >= 3 other keyframes at the same or a
        finer scale is retired."""
        m = self.map
        n_levels = self.cfg.orb.n_levels
        obs_kf, obs_kp = np.nonzero((m.kf_mp_idx[: m.n_kf] >= 0) & m.kf_valid[: m.n_kf, None])
        if len(obs_kf) == 0:
            return
        # observations per (map point, level), cumulative over the level
        obs_mp = m.kf_mp_idx[obs_kf, obs_kp]
        obs_lvl = np.minimum(m.kf_level[obs_kf, obs_kp], n_levels - 1)
        hist = np.zeros((len(m.mp_valid), n_levels), np.int32)
        np.add.at(hist, (obs_mp, obs_lvl), 1)
        cum = hist.cumsum(axis=1)
        for kf in m.covisible_kfs(kf_id)[:20]:
            kf = int(kf)
            if kf == 0 or kf in m.kf_not_erase or not m.kf_valid[kf]:
                continue
            ids = m.kf_mp_idx[kf]
            depth = m.kf_depth[kf]
            kps = np.nonzero((ids >= 0) & m.mp_valid[np.maximum(ids, 0)] & (depth > 0)
                             & (depth < self.cfg.th_depth_m))[0]
            if len(kps) < 30:
                continue
            lvl_cap = np.minimum(m.kf_level[kf, kps] + 1, n_levels - 1)
            # the keyframe's own observation is at a level <= lvl_cap
            redundant = int((cum[ids[kps], lvl_cap] - 1 >= 3).sum())
            if redundant > 0.9 * len(kps):
                e_kp = np.nonzero(m.kf_mp_idx[kf] >= 0)[0]
                e_lvl = np.minimum(m.kf_level[kf, e_kp], n_levels - 1)
                np.add.at(hist, (m.kf_mp_idx[kf, e_kp], e_lvl), -1)
                cum = hist.cumsum(axis=1)
                m.retire_keyframe(kf)
                self.counts["kf_culled"] += 1
