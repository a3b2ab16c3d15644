"""Headless viewer: snapshot renders of the map and the annotated frame
(counterpart of manhattanslam_tpu/viewer.py).

The reference's Pangolin/OpenGL thread (Viewer.cc, MapDrawer.cc,
FrameDrawer.cc) needs a desktop GL context; a card host is headless, so
``update()`` keeps the latest tracking state (no copy, no sync), and
``save_map_png`` / ``save_frame_png`` render what the reference draws:
map points, lines, plane clouds coloured per plane, the surfels,
keyframe positions and the covisibility graph, the current camera, and
the camera image with the keypoints, the tracked ones apart, and the
status text (FrameDrawer.cc:125-160).  The renders import matplotlib
inside them, so ``System(use_viewer=True)`` runs where matplotlib is not
installed; only the two renders need it.
"""

from __future__ import annotations

import numpy as np


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


class Viewer:
    def __init__(self, cfg, slam_map, tracker, surfel_mapper=None):
        self.cfg = cfg
        self.map = slam_map
        self.tracker = tracker
        self.surfel_mapper = surfel_mapper
        self._res = None

    def update(self) -> None:
        """Keep the latest tracking state (Viewer/FrameDrawer::Update); the
        keypoints are pulled only when a frame is rendered."""
        res = getattr(self.tracker, "last_result", None)
        if res is not None:
            self._res = res

    # ------------------------------------------------------------- renders
    def save_map_png(self, path: str) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        m = self.map
        fig = plt.figure(figsize=(9, 7))
        ax = fig.add_subplot(111, projection="3d")
        pts = m.mp_pos[m.mp_valid]
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c="k", alpha=0.4)
        for j in np.nonzero(m.ml_valid)[0]:
            ax.plot(*zip(m.ml_sp[j], m.ml_ep[j]), c="b", lw=1)
        for j in np.nonzero(m.pl_valid)[0]:
            cl = m.pl_pts[j, : m.pl_n_pts[j]]
            if len(cl):
                ax.scatter(cl[:, 0], cl[:, 1], cl[:, 2], s=2, color=m.pl_color[j], alpha=0.6)
        # surfels shaded by intensity (MapDrawer.cc:141-165), decimated
        if self.surfel_mapper is not None:
            surf = self.surfel_mapper.export_arrays()
            if len(surf["pos"]):
                sp, si = surf["pos"], surf["intensity"] / 255.0
                step = max(1, len(sp) // 4000)
                ax.scatter(sp[::step, 0], sp[::step, 1], sp[::step, 2], s=1,
                           c=np.clip(si[::step], 0, 1), cmap="gray", alpha=0.3)
        # keyframes and the covisibility graph (MapDrawer.cc:166-243)
        kf_centers = []
        for i in range(m.n_kf):
            if not m.kf_valid[i]:
                continue
            T = m.kf_pose[i]
            c = -T[:3, :3].T @ T[:3, 3]
            kf_centers.append((i, c))
            ax.scatter(*c, marker="s", c="g", s=14)
        for i, ci in kf_centers:
            for j, cj in kf_centers:
                if j > i and m.covis[i, j] >= 15:
                    ax.plot(*zip(ci, cj), c="g", lw=0.3, alpha=0.5)
        # the current camera
        T = self.tracker.T_cw
        c = -T[:3, :3].T @ T[:3, 3]
        ax.scatter(*c, marker="^", c="r", s=40)
        ax.set_title(
            f"KFs: {int(m.kf_valid.sum())}  MPs: {int(m.mp_valid.sum())} "
            f"MLs: {int(m.ml_valid.sum())}  Planes: {int(m.pl_valid.sum())}"
        )
        fig.savefig(path, dpi=110)
        plt.close(fig)

    def save_frame_png(self, path: str, gray: np.ndarray | None = None) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        tr = self.tracker
        fig, ax = plt.subplots(figsize=(8, 6))
        if gray is not None:
            ax.imshow(gray, cmap="gray", vmin=0, vmax=255)
        if self._res is not None:
            xy, v = _host(self._res["feats"]["xy"]), _host(self._res["feats"]["valid"])
            if xy.ndim == 3:  # a chunk: its last frame
                xy, v = xy[-1], v[-1]
            matched = tr.last_mp_idx >= 0
            ax.scatter(xy[v & ~matched, 0], xy[v & ~matched, 1], s=4, c="b", marker="o",
                       label="keypoints")
            ax.scatter(xy[v & matched, 0], xy[v & matched, 1], s=6, c="lime", marker="o",
                       label="tracked")
        ax.set_title(
            f"{tr.state} | KFs {int(self.map.kf_valid.sum())} "
            f"MPs {int(self.map.mp_valid.sum())} inliers {tr.n_inliers}"
        )
        ax.legend(loc="lower right", fontsize=7)
        fig.savefig(path, dpi=110)
        plt.close(fig)
