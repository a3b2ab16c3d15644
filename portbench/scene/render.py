"""The box room rendered in PyTorch: a copy of ``render_frame`` of the
port's ``datasets/synthetic.py`` (an axis-aligned ray caster over the six
room faces and the inner box's six, with the two-scale hash-noise
texture), batched over frames so that a period renders on the card in a
few calls.  No depth noise: the traffic is exact.

``to_sensor`` turns the rendered float gray and depth into what an RGB-D
sensor hands over: 8-bit RGB (the gray in three channels) and uint16
depth in 1/5000 m, as the port's ``datasets/tum.py`` reads them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

ROOM_SIZE = (6.0, 3.0, 8.0)
ROOM_BOXES = (((1.0, 0.0, 5.0), (2.2, 1.2, 6.2)),)
DEPTH_QUANT = 5000.0  # uint16 depth units per metre (TUM / TAMU DepthMapFactor)


@dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def room_faces(size=ROOM_SIZE, boxes=ROOM_BOXES) -> list[tuple]:
    """(axis, sign, coord, lo2d, hi2d) for each face: the room's walls seen
    from inside, then each box's faces seen from outside (synthetic.py's
    BoxRoom.faces order, which sets each face's texture id)."""
    out = []
    for ax, s in ((0, size[0]), (1, size[1]), (2, size[2])):
        hi = {0: (size[1], size[2]), 1: (size[0], size[2]), 2: (size[0], size[1])}[ax]
        out.append((ax, +1, 0.0, (0.0, 0.0), hi))
        out.append((ax, -1, s, (0.0, 0.0), hi))
    for lo3, hi3 in boxes:
        lohi = tuple(zip(lo3, hi3))
        for ax in range(3):
            u, v = [a for a in range(3) if a != ax]
            lo2, hi2 = (lohi[u][0], lohi[v][0]), (lohi[u][1], lohi[v][1])
            out.append((ax, -1, lohi[ax][0], lo2, hi2))
            out.append((ax, +1, lohi[ax][1], lo2, hi2))
    return out


def _hash_noise(iu: torch.Tensor, iv: torch.Tensor, salt: int) -> torch.Tensor:
    """synthetic.py's integer hash in [0, 1), in wrapping int64."""
    s = torch.tensor(salt, dtype=torch.int64, device=iu.device)
    h = (iu * 73856093) ^ (iv * 19349663) ^ (s * 83492791)
    h = (h ^ (h >> 13)) * 1274126177
    return torch.remainder(h ^ (h >> 16), 65521).to(torch.float32) / 65521.0


def _texture(u: torch.Tensor, v: torch.Tensor, face_id: int, seed: int) -> torch.Tensor:
    s = face_id * 7919 + seed
    iu1, iv1 = torch.floor(u * 4.0).to(torch.int64), torch.floor(v * 4.0).to(torch.int64)
    iu2, iv2 = torch.floor(u * 11.0).to(torch.int64), torch.floor(v * 11.0).to(torch.int64)
    g = 30.0 + 140.0 * _hash_noise(iu1, iv1, s) + 80.0 * _hash_noise(iu2, iv2, s + 1)
    return torch.clamp(g, 0, 255)


def render_frames(cam: Camera, Twc: torch.Tensor, seed: int,
                  faces=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Twc (F, 4, 4) float32 on the rendering device -> gray (F, H, W)
    float32 in [0, 255] and depth (F, H, W) float32 metres (0 where no
    face is hit).  Camera: z forward, x right, y down."""
    faces = room_faces() if faces is None else faces
    dev = Twc.device
    H, W = cam.height, cam.width
    xs = (torch.arange(W, dtype=torch.float32, device=dev) - cam.cx) / cam.fx
    ys = (torch.arange(H, dtype=torch.float32, device=dev) - cam.cy) / cam.fy
    X, Y = xs[None, None, :], ys[None, :, None]
    R = Twc[:, :3, :3].to(torch.float32)
    o = Twc[:, :3, 3].to(torch.float32)
    # world-frame ray directions (unnormalised; t is the z depth)
    dirs = [X * R[:, k, 0, None, None] + Y * R[:, k, 1, None, None] + R[:, k, 2, None, None]
            for k in range(3)]
    n = Twc.shape[0]
    best_t = torch.full((n, H, W), float("inf"), device=dev)
    gray = torch.zeros((n, H, W), device=dev)
    for fid, (ax, sign, coord, lo, hi) in enumerate(faces):
        d_ax = dirs[ax]
        safe = d_ax.abs() > 1e-12
        t = torch.where(safe, (coord - o[:, ax, None, None]) / torch.where(safe, d_ax, 1.0),
                        torch.full_like(d_ax, 1e9))
        facing = (d_ax * sign) < -1e-9
        u_ax, v_ax = [a for a in range(3) if a != ax]
        u = o[:, u_ax, None, None] + t * dirs[u_ax]
        v = o[:, v_ax, None, None] + t * dirs[v_ax]
        hit = (facing & (t > 0.05) & (t < best_t) & (u >= lo[0] - 1e-6) & (u <= hi[0] + 1e-6)
               & (v >= lo[1] - 1e-6) & (v <= hi[1] + 1e-6))
        gray = torch.where(hit, _texture(u, v, fid, seed), gray)
        best_t = torch.where(hit, t, best_t)
    depth = torch.where(torch.isfinite(best_t), best_t, torch.zeros_like(best_t))
    return gray, depth


def to_sensor(gray: torch.Tensor, depth: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Float gray and metres -> (rgb8 (..., H, W, 3) uint8, depth (..., H, W)
    int32 in 1/5000 m, within uint16's range: the host stores it as uint16),
    rounded as the port's sensor-native conversion rounds."""
    g8 = torch.clamp(torch.round(gray), 0, 255).to(torch.uint8)
    d = torch.clamp(torch.round(depth * DEPTH_QUANT), 0, 65535).to(torch.int32)
    return g8[..., None].expand(g8.shape + (3,)).contiguous(), d
