"""The one generator of the benchmark's traffic: a traffic file's ``path``
and its parameters give the ground-truth poses of one period of frames,
rendered on the card from the seed and handed to the host as a sensor
delivers them."""

from __future__ import annotations

import numpy as np
import torch

from portbench.scene.poses import POSE_GENERATORS
from portbench.scene.render import ROOM_SIZE, Camera, render_frames, to_sensor

RENDER_BATCH = 16  # frames per rendering call
POSE_KEYS = {"near_corner": ("period", "sway"), "walk": ("radius_frac", "speed")}


def period_poses(traffic: dict) -> np.ndarray:
    """(P, 4, 4) float32 T_wc of one period of the traffic's path."""
    path = traffic["path"]
    kw = {k: traffic[k] for k in POSE_KEYS[path] if k in traffic}
    return POSE_GENERATORS[path](ROOM_SIZE, **kw)


def camera_of(settings: dict) -> Camera:
    return Camera(fx=float(settings["Camera.fx"]), fy=float(settings["Camera.fy"]),
                  cx=float(settings["Camera.cx"]), cy=float(settings["Camera.cy"]),
                  width=int(settings["Camera.width"]), height=int(settings["Camera.height"]))


def render_period(cam: Camera, poses: np.ndarray, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """Every frame of the period from the seed's texture: rgb (P, H, W, 3)
    uint8 and depth (P, H, W) uint16 in 1/5000 m, in host memory."""
    rgb = np.empty((len(poses), cam.height, cam.width, 3), np.uint8)
    d16 = np.empty((len(poses), cam.height, cam.width), np.uint16)
    Twc = torch.from_numpy(poses).to(device)
    for lo in range(0, len(poses), RENDER_BATCH):
        gray, depth = render_frames(cam, Twc[lo: lo + RENDER_BATCH], seed)
        c, d = to_sensor(gray, depth)
        rgb[lo: lo + RENDER_BATCH] = c.cpu().numpy()
        d16[lo: lo + RENDER_BATCH] = d.cpu().numpy().astype(np.uint16)
    return rgb, d16


def sample_events(seed: int, span: int, n: int) -> list[int]:
    """The n events (chunks, frames or steps of the window) among the first
    `span` that the check compares, drawn from the seed; the first event
    of the window is always one."""
    rng = np.random.default_rng(seed)
    picks = rng.choice(np.arange(1, span), size=n - 1, replace=False)
    return sorted({0, *(int(p) for p in picks)})
