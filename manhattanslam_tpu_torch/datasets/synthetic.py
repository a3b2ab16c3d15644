"""Synthetic box-room RGB-D renderer (test + benchmark data source).

The reference is validated on TUM/ICL/TAMU sequences which are not shipped;
SURVEY.md section 4 calls for synthetic-geometry integration tests: a textured
axis-aligned room whose walls are exactly perpendicular, so Manhattan-frame
detection must recover the ground-truth rotation and ATE can be measured
against exact poses.

The renderer is a vectorized numpy raycaster over axis-aligned rectangles
(6 room faces + optional inner boxes), with a procedural high-contrast
texture (checker + hash noise) that gives FAST corners and LSD-able edges.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from manhattanslam_tpu_torch.config import CameraConfig


@dataclass
class BoxRoom:
    """Axis-aligned room [0,sx]x[0,sy]x[0,sz] viewed from inside."""

    size: tuple = (6.0, 3.0, 8.0)
    boxes: list = field(default_factory=lambda: [((1.0, 0.0, 5.0), (2.2, 1.2, 6.2))])
    seed: int = 7
    # optional texture override: fn(u, v, face_id, seed) -> gray [0, 255]
    # (datasets/phototex.py installs a real-photograph sampler here)
    texture_fn: object = None

    def faces(self):
        """Returns list of (axis, sign, coord, lo2d, hi2d) rectangles.

        axis: normal axis; sign: +1 if normal points toward +axis (into room
        for walls at coordinate 0).  Room faces seen from inside + box faces
        seen from outside.
        """
        sx, sy, sz = self.size
        out = []
        # room walls: at 0 (normal +) and at s (normal -)
        for ax, s in ((0, sx), (1, sy), (2, sz)):
            lo = (0.0, 0.0)
            hi = ({0: (sy, sz), 1: (sx, sz), 2: (sx, sy)})[ax]
            out.append((ax, +1, 0.0, lo, hi))
            out.append((ax, -1, s, lo, hi))
        # inner boxes: normals point outward
        for (bx0, by0, bz0), (bx1, by1, bz1) in self.boxes:
            lohi = ((bx0, bx1), (by0, by1), (bz0, bz1))
            for ax in range(3):
                u, v = [a for a in range(3) if a != ax]
                lo2 = (lohi[u][0], lohi[v][0])
                hi2 = (lohi[u][1], lohi[v][1])
                out.append((ax, -1, lohi[ax][0], lo2, hi2))
                out.append((ax, +1, lohi[ax][1], lo2, hi2))
        return out


def _hash_noise(iu: np.ndarray, iv: np.ndarray, salt: int) -> np.ndarray:
    """Deterministic integer-hash noise in [0, 1) — aperiodic by construction."""
    h = (iu * 73856093) ^ (iv * 19349663) ^ (np.int64(salt) * 83492791)
    h = (h ^ (h >> 13)) * 1274126177
    return ((h ^ (h >> 16)) % 65521).astype(np.float32) / 65521.0


def _texture(u: np.ndarray, v: np.ndarray, face_id: int, seed: int) -> np.ndarray:
    """Procedural gray texture in [0,255] with strong, NON-repeating corners.

    Blocky hash noise at two scales: every cell boundary is an L-junction
    with a locally unique neighborhood, so descriptors can discriminate
    (a periodic texture would alias matches at the pattern period).
    """
    s = face_id * 7919 + seed
    iu1 = np.floor(u * 4.0).astype(np.int64)
    iv1 = np.floor(v * 4.0).astype(np.int64)
    iu2 = np.floor(u * 11.0).astype(np.int64)
    iv2 = np.floor(v * 11.0).astype(np.int64)
    g = (
        30.0
        + 140.0 * _hash_noise(iu1, iv1, s)
        + 80.0 * _hash_noise(iu2, iv2, s + 1)
    )
    return np.clip(g, 0, 255)


def render_frame(
    cam: CameraConfig,
    Twc: np.ndarray,
    room: BoxRoom,
    depth_noise: float = 0.0,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Render (gray(H,W) float32 [0,255], depth(H,W) float32 meters).

    Twc: camera-to-world 4x4.  Camera: z forward, x right, y down (as TUM).
    """
    H, W = cam.height, cam.width
    xs = (np.arange(W, dtype=np.float32) - cam.cx) / cam.fx
    ys = (np.arange(H, dtype=np.float32) - cam.cy) / cam.fy
    dirs_cam = np.stack(
        [np.tile(xs, (H, 1)), np.tile(ys[:, None], (1, W)), np.ones((H, W), np.float32)], -1
    )
    R = Twc[:3, :3].astype(np.float32)
    o = Twc[:3, 3].astype(np.float32)
    dirs = dirs_cam @ R.T  # world-frame ray directions (unnormalized; t = z-depth)

    best_t = np.full((H, W), np.inf, np.float32)
    gray = np.zeros((H, W), np.float32)
    for fid, (ax, sign, coord, lo, hi) in enumerate(room.faces()):
        d_ax = dirs[..., ax]
        # rays parallel to the face (d_ax == 0) never hit it: send t to a
        # large finite value instead of inf (inf * 0 in the point formula
        # below makes NaNs that ride into u/v and the texture lookup)
        safe = np.abs(d_ax) > 1e-12
        t = np.where(
            safe, (coord - o[ax]) / np.where(safe, d_ax, 1.0), 1e9
        )
        # facing check: ray must travel against the face normal to see it
        facing = (d_ax * sign) < -1e-9
        pts = o[None, None, :] + t[..., None] * dirs
        u_ax, v_ax = [a for a in range(3) if a != ax]
        u = pts[..., u_ax]
        v = pts[..., v_ax]
        hit = (
            facing
            & (t > 0.05)
            & (t < best_t)
            & (u >= lo[0] - 1e-6)
            & (u <= hi[0] + 1e-6)
            & (v >= lo[1] - 1e-6)
            & (v <= hi[1] + 1e-6)
        )
        if not hit.any():
            continue
        tex = (room.texture_fn or _texture)(u, v, fid, room.seed)
        gray = np.where(hit, tex, gray)
        best_t = np.where(hit, t, best_t)

    depth = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
    if depth_noise > 0 and rng is not None:
        depth = depth + (depth > 0) * rng.normal(0, depth_noise, depth.shape).astype(
            np.float32
        ) * np.square(depth)
    return gray, depth


def _flat_texture(amp: float = 6.0, end_face: int = 5, end_amp: float = 45.0):
    """Texture factory for the LOW-TEXTURE corridor proof.

    Side walls / floor / ceiling get a per-face base gray plus coarse
    noise of amplitude `amp` — deliberately BELOW the FAST fallback
    threshold (minThFAST=7, ORBextractor.cc:763-769 semantics), so ORB
    starves there and only the junction shading edges remain.  The far
    end wall (`end_face`) keeps a moderate texture (a corridor's door /
    poster): those corners are FAR points, which constrain rotation but
    barely constrain the along-corridor translation — the regime where
    the reference leans on planes + Manhattan (Tracking.cc:846-944).
    """

    def fn(u, v, face_id, seed):
        s = face_id * 7919 + seed
        base = 95.0 + 18.0 * ((face_id * 37) % 5)
        if face_id == end_face:
            iu = np.floor(u * 3.0).astype(np.int64)
            iv = np.floor(v * 3.0).astype(np.int64)
            return np.clip(base + end_amp * _hash_noise(iu, iv, s), 0, 255)
        iu = np.floor(u * 0.7).astype(np.int64)
        iv = np.floor(v * 0.7).astype(np.int64)
        return np.clip(base + amp * _hash_noise(iu, iv, s), 0, 255)

    return fn


def corridor_room(length: float = 10.0) -> BoxRoom:
    """Blank-walled corridor: 3.2 m wide, 2.6 m tall, `length` m deep,
    no inner boxes — the plane/Manhattan path must carry the pose."""
    return BoxRoom(size=(3.2, 2.6, length), boxes=[],
                   texture_fn=_flat_texture())


def corridor_poses(
    n: int, room: BoxRoom, z0: float = 1.5, z1: float = 6.0,
    sway: float = 0.04,
) -> np.ndarray:
    """n poses advancing down the corridor axis (+z) with small lateral
    sway and yaw — the TAMU-corridor analog (BASELINE config 4)."""
    sx, sy, _sz = room.size
    poses = []
    for i in range(n):
        f = i / max(n - 1, 1)
        a = np.sin(2 * np.pi * f * 1.5)
        pos = np.array(
            [sx / 2 + sway * a, sy / 2 + 0.02 * np.sin(3 * a), z0 + (z1 - z0) * f],
            np.float32,
        )
        yaw = 0.03 * a
        cy, sy_ = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy, 0, sy_], [0, 1, 0], [-sy_, 0, cy]], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T)
    return np.stack(poses)


def orbit_poses(n: int, room: BoxRoom, radius: float = 1.0) -> np.ndarray:
    """n camera-to-world poses: gentle arc inside the room looking at +z wall."""
    sx, sy, sz = room.size
    center = np.array([sx / 2, sy / 2, sz * 0.25], np.float32)
    poses = []
    for i in range(n):
        a = 0.25 * np.sin(2 * np.pi * i / max(n, 1))
        pos = center + np.array([radius * np.sin(a), 0.1 * np.sin(4 * a), 0.3 * a], np.float32)
        yaw = 0.1 * np.sin(a * 3)
        cy, sy_ = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy, 0, sy_], [0, 1, 0], [-sy_, 0, cy]], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T)
    return np.stack(poses)


def walk_poses(
    n: int, room: BoxRoom, radius_frac: float = 0.5, speed: float = 0.02,
) -> np.ndarray:
    """n poses walking an interior ellipse at ~`speed` m/frame, gazing
    outward at the walls: a TUM-fr3-like sweep whose continuous viewpoint
    change forces a realistic keyframe cadence (~1 KF / 20-30 frames at
    640x480 defaults) — the regime the reference's always-on LocalMapping
    + SurfelMapping threads live in (System.cc:90-107)."""
    sx, sy, sz = room.size
    cx, cz = sx / 2, sz / 2
    rx, rz = radius_frac * sx / 2, radius_frac * sz / 2
    circumference = np.pi * (3 * (rx + rz) - np.sqrt((3 * rx + rz) * (rx + 3 * rz)))
    total_angle = 2 * np.pi * (n * speed) / max(circumference, 1e-6)
    poses = []
    for i in range(n):
        a = total_angle * i / max(n - 1, 1)
        pos = np.array(
            [cx + rx * np.sin(a), sy / 2 + 0.05 * np.sin(3 * a),
             cz + rz * np.cos(a)],
            np.float32,
        )
        gaze = np.array([np.sin(a), 0.0, np.cos(a)], np.float32)  # outward
        z = gaze / np.linalg.norm(gaze)
        x = np.cross(np.array([0.0, 1.0, 0.0], np.float32), z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, pos
        poses.append(T)
    return np.stack(poses)


def _look_at_poses(n: int, base: np.ndarray, target: np.ndarray, sway: float) -> np.ndarray:
    """n poses swaying around `base`, each looking at `target`."""
    poses = []
    for i in range(n):
        a = np.sin(2 * np.pi * i / max(n, 1))
        pos = base + np.array(
            [sway * a, 0.05 * np.sin(2 * a), 0.1 * a], np.float32
        )
        z = target - pos
        z = z / np.linalg.norm(z)
        x = np.cross(np.array([0.0, 1.0, 0.0], np.float32), z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, pos
        poses.append(T)
    return np.stack(poses)


def corner_poses(n: int, room: BoxRoom, sway: float = 0.15) -> np.ndarray:
    """n poses looking toward a room corner: floor + two perpendicular walls
    stay in view the whole time (Manhattan-friendly viewpoint)."""
    sx, sy, sz = room.size
    corner = np.array([sx * 0.9, sy * 0.85, sz * 0.9], np.float32)
    base = np.array([sx * 0.35, sy * 0.4, sz * 0.3], np.float32)
    return _look_at_poses(n, base, corner, sway)


def near_corner_poses(n: int, room: BoxRoom, sway: float = 0.15) -> np.ndarray:
    """n poses of a camera 0.54 m above the floor (y = sy) looking at the
    floor corner (sx, sy, sz) from 1.8 m, with corner_poses' sway: the
    floor and the two walls at 0.9-2.2 m depth.  (The "corner" view sees
    them at 3-7 m, where the device plane extraction at 640x480 joins them
    into one plane: ops/planes.py, merge_blocks_device.)"""
    far = np.array(room.size, np.float32)
    target = far - np.float32([0.18, 0.135, 0.24])
    base = far - np.float32([1.17, 0.54, 1.68])
    return _look_at_poses(n, base, target, sway)


class SyntheticSequence:
    """Iterable RGB-D sequence over a BoxRoom (timestamps at 1/fps)."""

    def __init__(
        self,
        n_frames: int = 60,
        cam: CameraConfig | None = None,
        room: BoxRoom | None = None,
        depth_noise: float = 0.0,
        seed: int = 0,
        view: str = "wall",  # "wall" | "corner" | "near_corner" | "corridor" (low-texture) | "walk"
    ):
        self.cam = cam or CameraConfig(
            fx=525.0, fy=525.0, cx=319.5, cy=239.5, k1=0, k2=0, p1=0, p2=0, k3=0
        )
        if view == "corridor" and room is None:
            room = corridor_room()
        self.room = room or BoxRoom()
        if view == "corner":
            self.poses = corner_poses(n_frames, self.room)
        elif view == "near_corner":
            self.poses = near_corner_poses(n_frames, self.room)
        elif view == "corridor":
            self.poses = corridor_poses(n_frames, self.room)
        elif view == "walk":
            self.poses = walk_poses(n_frames, self.room)
        else:
            self.poses = orbit_poses(n_frames, self.room)  # ground-truth Twc
        self.depth_noise = depth_noise
        self.rng = np.random.default_rng(seed)
        self.fps = 30.0

    def __len__(self):
        return len(self.poses)

    def frame(self, i: int):
        gray, depth = render_frame(
            self.cam, self.poses[i], self.room, self.depth_noise, self.rng
        )
        return float(i) / self.fps, gray, depth

    def gt_rows(self):
        """Ground truth as (timestamp, twc, quat) rows for ATE evaluation."""
        from manhattanslam_tpu_torch.geometry import se3

        rows = []
        for i, T in enumerate(self.poses):
            q = se3.rotmat_to_quat_np(T[:3, :3])
            rows.append((float(i) / self.fps, T[:3, 3].copy(), q))
        return rows
