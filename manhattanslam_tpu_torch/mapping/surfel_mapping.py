"""Dense surfel mapping (counterpart of
manhattanslam_tpu/mapping/surfel_mapping.py; reference SurfelMapping and
SurfelFusion).

Run per keyframe on the calling thread (the reference's dedicated thread
consumes a keyframe queue, SurfelMapping.cpp:137-146):

- keeps the pose-graph links and the BFS drift-free window of 10 poses
  (:29, :326-351); surfels attached to poses outside the window become
  inactive (no longer fused into, :194-304).  The window's membership
  test runs on the device through a keyframe-id lookup table.
- builds the full-resolution plane mask from the keyframe's
  half-resolution plane membership on the device, then superpixels,
  fusion and new surfels (ops/surfels.py) into the state, written in
  place.
- the export merges stable surfels (>= 5 updates), inactive surfels, and
  the map planes' clouds flattened onto their planes (:62-135), written
  as the reference's PLY.

Depth reaches ``insert_keyframe`` as the caller gave it to the tracker:
float32 metres, or uint16 in 1/DEPTH_QUANT m (the sensor-native frames of
bench.py), which is converted to metres here.  The reference hands a
uint16 frame to its superpixels unconverted and places that map 5000x
too far (ROADMAP Queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend.device_tracker import depth_in_metres, to_device
from manhattanslam_tpu_torch.io.ply import save_surfel_ply
from manhattanslam_tpu_torch.ops import surfels as surf_ops
from manhattanslam_tpu_torch.slam_map import SlamMap

DRIFT_FREE_POSES = 10
STABLE_UPDATES = 5


def window_active(attach_kf: torch.Tensor, valid: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """active[i] = valid[i] and attach_kf[i] in the drift-free window
    (lut: one flag per keyframe slot)."""
    return valid & lut[torch.clamp(attach_kf, 0, lut.shape[0] - 1).long()]


def plane_mask(membership, H: int, W: int, device) -> torch.Tensor:
    """The full-resolution plane-pixel mask (H, W) bool on the device from
    a half-resolution plane membership (int32, -1 = none; a device tensor
    or an array), each cell repeated 2x; None: no plane pixel."""
    mask = torch.zeros((H, W), dtype=torch.bool, device=device)
    if membership is None:
        return mask
    if not isinstance(membership, torch.Tensor):
        membership = to_device(np.asarray(membership), device)
    h, w = membership.shape
    up = (membership >= 0)[:, None, :, None].expand(h, 2, w, 2).reshape(2 * h, 2 * w)
    uh, uw = min(up.shape[0], H), min(up.shape[1], W)
    mask[:uh, :uw] = up[:uh, :uw]
    return mask


class SurfelMapper:
    def __init__(self, cfg: SlamConfig, slam_map: SlamMap, device):
        self.cfg = cfg
        self.map = slam_map
        self.device = torch.device(device)
        self.K = torch.tensor(np.asarray(cfg.camera.K, np.float32), device=self.device)
        self.surfels = surf_ops.empty_state(cfg.surfel.max_surfels, self.device)
        self.pose_links: dict[int, set[int]] = {}
        self.n_keyframes = 0
        self._last_inserted: int | None = None

    def reset(self, slam_map: SlamMap) -> None:
        """An empty surfel map for a new map; the state is zeroed in place."""
        self.map = slam_map
        for v in self.surfels.values():
            v.zero_()
        self.pose_links = {}
        self.n_keyframes = 0
        self._last_inserted = None

    # ------------------------------------------------------------------ API
    def insert_keyframe(self, kf_id: int, gray: np.ndarray, depth: np.ndarray,
                        plane_membership=None, ref_kf: int | None = None) -> None:
        """Fuse keyframe kf_id's own frame into the surfel map.
        plane_membership: its half-resolution plane membership (int32,
        -1 = none; a device tensor or an array; None: no plane mask).
        ref_kf: the tracker's reference keyframe before this one, which
        the new pose links to."""
        m = self.map
        T_cw = m.kf_pose[kf_id].astype(np.float32)
        T_wc = np.linalg.inv(T_cw)

        # the pose-graph link goes to the tracker's REFERENCE keyframe, not
        # the chronological predecessor (SurfelMapping.cpp:162-168): after a
        # relocalization it reaches back into the revisited region, so the
        # window reactivates the surfels there
        self.pose_links.setdefault(kf_id, set())
        if self.n_keyframes > 0:
            link = (ref_kf if ref_kf is not None and ref_kf != kf_id
                    and ref_kf in self.pose_links else self._last_inserted)
            if link is not None and link != kf_id:
                self.pose_links[kf_id].add(link)
                self.pose_links.setdefault(link, set()).add(kf_id)
        self.n_keyframes += 1
        self._last_inserted = kf_id

        window = self._bfs_window(kf_id)
        lut = np.zeros(self.cfg.caps.max_keyframes, bool)
        lut[np.fromiter(window, int)] = True
        s = self.surfels
        s["active"].copy_(window_active(s["attach_kf"], s["valid"], to_device(lut, self.device)))

        H, W = gray.shape
        mask = plane_mask(plane_membership, H, W, self.device)
        # uploads through pinned memory, ordered on the stream without a
        # wait: in chunk mode this runs while the card works on a chunk
        gray_t = to_device(np.asarray(gray, np.float32), self.device)
        depth_t = to_device(depth_in_metres(depth), self.device)
        sp = surf_ops.superpixels(gray_t, depth_t, mask, self.K)
        T_cw_t = to_device(T_cw, self.device)
        T_wc_t = to_device(np.asarray(T_wc, np.float32), self.device)
        fused = surf_ops.fuse_surfels(s, sp, T_cw_t, T_wc_t, self.K, kf_id, H, W)
        surf_ops.add_new_surfels(s, sp, fused, T_wc_t, kf_id)

    def _bfs_window(self, start: int) -> set[int]:
        seen = {start}
        frontier = [start]
        for _ in range(DRIFT_FREE_POSES):
            nxt = []
            for p in frontier:
                for q in self.pose_links.get(p, ()):
                    if q not in seen:
                        seen.add(q)
                        nxt.append(q)
            frontier = nxt
        return seen

    # --------------------------------------------------------------- export
    def finish(self) -> None:
        """Nothing is queued: every keyframe was inserted when it came."""

    def state_to_numpy(self) -> dict:
        """The surfel state as numpy arrays."""
        return {k: v.cpu().numpy() for k, v in self.surfels.items()}

    def export_arrays(self) -> dict:
        """Stable surfels and the map planes' clouds flattened onto their
        planes (System.cc:296-382)."""
        s = self.state_to_numpy()
        keep = s["valid"] & ((s["n_updates"] >= STABLE_UPDATES) | ~s["active"])
        # never-confirmed surfels are dropped like the reference's unstable
        # local surfels
        keep &= s["n_updates"] >= 1
        pos = [s["pos"][keep]]
        nrm = [s["normal"][keep]]
        col = [s["color"][keep]]
        qual = [s["weight"][keep]]
        rad = [s["radius"][keep]]

        m = self.map
        for j in np.nonzero(m.pl_valid)[0]:
            cloud = m.pl_pts[j, : m.pl_n_pts[j]]
            if len(cloud) == 0:
                continue
            c = m.pl_coeffs[j]
            n = c[:3] / np.linalg.norm(c[:3])
            # project the cloud onto the plane along its normal
            # (System.cc:340-360)
            d = cloud @ n + c[3]
            flat = cloud - d[:, None] * n[None]
            pos.append(flat.astype(np.float32))
            nrm.append(np.tile(n.astype(np.float32), (len(flat), 1)))
            col.append(np.full(len(flat), 128.0, np.float32))
            qual.append(np.ones(len(flat), np.float32))
            rad.append(np.full(len(flat), 0.1, np.float32))

        return {
            "pos": np.concatenate(pos),
            "normal": np.concatenate(nrm),
            "intensity": np.concatenate(col),
            "quality": np.concatenate(qual),
            "radius": np.concatenate(rad),
        }

    def save_ply(self, path: str) -> None:
        a = self.export_arrays()
        save_surfel_ply(path, a["pos"], a["normal"], a["intensity"], a["quality"], a["radius"])
