"""Ground-truth camera paths through the box room, as camera-to-world
(T_wc) 4x4 float32 matrices: copies of ``near_corner_poses`` and
``walk_poses`` of the port's ``datasets/synthetic.py``.

Both are periodic, so the traffic renders one period and feeds it
cyclically with the motion continuous across the wrap:

- ``near_corner``: the camera 0.54 m above the floor, looking at the floor
  corner from 1.8 m and swaying by ``sway`` along one sine period of
  ``period`` frames (synthetic.py's near_corner_poses with n = period).
- ``walk``: one lap of the interior ellipse at about ``speed`` m a frame,
  gazing outward (synthetic.py's walk_poses, with the lap closed: frame i
  at angle 2 pi i / n, n the lap's length in frames).

A few hundred poses are host arithmetic; the renderer is what runs on the
card.
"""

from __future__ import annotations

import numpy as np

UP = np.array([0.0, 1.0, 0.0], np.float32)


def _frame_from_gaze(pos: np.ndarray, z: np.ndarray) -> np.ndarray:
    z = z / np.linalg.norm(z)
    x = np.cross(UP, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, pos
    return T


def near_corner(room_size, period: int = 120, sway: float = 0.15) -> np.ndarray:
    far = np.array(room_size, np.float32)
    target = far - np.float32([0.18, 0.135, 0.24])
    base = far - np.float32([1.17, 0.54, 1.68])
    poses = []
    for i in range(period):
        a = np.sin(2 * np.pi * i / max(period, 1))
        pos = base + np.array([sway * a, 0.05 * np.sin(2 * a), 0.1 * a], np.float32)
        poses.append(_frame_from_gaze(pos, target - pos))
    return np.stack(poses)


def walk_lap_length(room_size, radius_frac: float = 0.5, speed: float = 0.02) -> int:
    """Frames in one lap of the walk's ellipse at `speed` m a frame."""
    sx, _, sz = room_size
    rx, rz = radius_frac * sx / 2, radius_frac * sz / 2
    circumference = np.pi * (3 * (rx + rz) - np.sqrt((3 * rx + rz) * (rx + 3 * rz)))
    return int(round(circumference / speed))


def walk(room_size, radius_frac: float = 0.5, speed: float = 0.02) -> np.ndarray:
    sx, sy, sz = room_size
    cx, cz = sx / 2, sz / 2
    rx, rz = radius_frac * sx / 2, radius_frac * sz / 2
    n = walk_lap_length(room_size, radius_frac, speed)
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        pos = np.array([cx + rx * np.sin(a), sy / 2 + 0.05 * np.sin(3 * a), cz + rz * np.cos(a)],
                       np.float32)
        poses.append(_frame_from_gaze(pos, np.array([np.sin(a), 0.0, np.cos(a)], np.float32)))
    return np.stack(poses)


POSE_GENERATORS = {"near_corner": near_corner, "walk": walk}


def relative_cw(poses: np.ndarray, idx, origin: int = 0) -> np.ndarray:
    """T_cw of frames `idx` in the camera frame of frame `origin`, the
    world of a tracker whose first frame is `origin` (float64)."""
    P = poses.astype(np.float64)
    return np.linalg.inv(P[np.asarray(idx)]) @ P[origin]
