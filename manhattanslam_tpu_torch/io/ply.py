"""PLY export of the surfel cloud (counterpart of
manhattanslam_tpu/io/ply.py; numpy only, the same bytes).

The reference's tinyply schema (System::saveSurfels, System.cc:296-382):
a vertex element with position, normal, colour (red/green/blue/alpha
uint8; the surfels carry a gray intensity, written to all three
channels), quality (fuse weight) and radius, plus the one-row ``camera``
element (identity extrinsics, viewport = point count,
System.cc:321-327).  Binary little-endian.
"""

from __future__ import annotations

import numpy as np

HEADER = """ply
format binary_little_endian 1.0
element vertex {n}
property float x
property float y
property float z
property float nx
property float ny
property float nz
property uchar red
property uchar green
property uchar blue
property uchar alpha
property float quality
property float radius
element camera 1
property float view_px
property float view_py
property float view_pz
property float x_axisx
property float x_axisy
property float x_axisz
property float y_axisx
property float y_axisy
property float y_axisz
property float z_axisx
property float z_axisy
property float z_axisz
property float focal
property float scalex
property float scaley
property float centerx
property float centery
property int viewportx
property int viewporty
property float k1
property float k2
end_header
"""

_VERTEX_DT = np.dtype(
    [
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1"), ("alpha", "u1"),
        ("quality", "<f4"), ("radius", "<f4"),
    ]
)


def save_surfel_ply(
    path: str,
    pos: np.ndarray,
    normal: np.ndarray,
    intensity: np.ndarray,
    quality: np.ndarray,
    radius: np.ndarray,
) -> None:
    n = len(pos)
    v = np.empty(n, dtype=_VERTEX_DT)
    v["x"], v["y"], v["z"] = pos[:, 0], pos[:, 1], pos[:, 2]
    v["nx"], v["ny"], v["nz"] = normal[:, 0], normal[:, 1], normal[:, 2]
    gray = np.clip(np.round(intensity), 0, 255).astype(np.uint8)
    v["red"] = v["green"] = v["blue"] = gray
    v["alpha"] = 1  # the reference writes label=1 per vertex (System.cc:314)
    v["quality"] = quality
    v["radius"] = radius
    # camera element: identity pose, zero intrinsics, viewport = (n, 1)
    # (System.cc:321-327 cameraProp values)
    cam = (
        np.array(
            [0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0], "<f4"
        ).tobytes()
        + np.array([n, 1], "<i4").tobytes()
        + np.array([0, 0], "<f4").tobytes()
    )
    with open(path, "wb") as f:
        f.write(HEADER.format(n=n).encode())
        f.write(v.tobytes())
        f.write(cam)


def load_surfel_ply(path: str) -> dict:
    """Reads back the schema written by save_surfel_ply (for tests)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n = int(
            [ln for ln in header.decode().splitlines() if ln.startswith("element vertex")][
                0
            ].split()[-1]
        )
        raw = f.read()
    v = np.frombuffer(raw[: n * _VERTEX_DT.itemsize], dtype=_VERTEX_DT)
    cam_raw = raw[n * _VERTEX_DT.itemsize:]
    cam1 = np.frombuffer(cam_raw[: 17 * 4], dtype="<f4")
    viewport = np.frombuffer(cam_raw[17 * 4 : 19 * 4], dtype="<i4")
    return {
        "pos": np.stack([v["x"], v["y"], v["z"]], -1),
        "normal": np.stack([v["nx"], v["ny"], v["nz"]], -1),
        "intensity": v["red"].astype(np.float32),
        "quality": v["quality"].astype(np.float32),
        "radius": v["radius"].astype(np.float32),
        "camera": cam1,
        "viewport": viewport,
    }
