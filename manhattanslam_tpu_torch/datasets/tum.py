"""TUM RGB-D sequence loading, associations format (counterpart of
manhattanslam_tpu/datasets/tum.py).

As the reference CLI loader (Example/manhattan_slam.cc:122-144): an
associations file with lines ``t_rgb rgb_path t_depth depth_path``; RGB
is 8-bit, depth 16-bit PNG scaled by DepthMapFactor (Frame.cc:95-98).
The PNGs are read by ``io/png.py`` (no image library needed) into what
the reference's cv2 reading gives: RGB in RGB order, a gray image
replicated to 3 channels, depth as float32 metres.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from manhattanslam_tpu_torch.io.png import read_png


@dataclass
class RGBDFrame:
    timestamp: float
    rgb: np.ndarray  # (H, W, 3) uint8
    depth: np.ndarray  # (H, W) float32, meters; 0 = invalid


def load_associations(path: str) -> list[tuple[float, str, float, str]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t_rgb, rgb, t_d, d = line.split()[:4]
            rows.append((float(t_rgb), rgb, float(t_d), d))
    return rows


def _imread(path: str) -> np.ndarray:
    """The reference's cv2 reading (IMREAD_UNCHANGED, then the channel
    order reversed): RGB for RGB files, and (A, R, G, B) for RGBA files."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    img = read_png(path)
    if img.ndim == 3 and img.shape[-1] == 4:
        img = img[..., [3, 0, 1, 2]]
    return img


class TumSequence:
    """Iterates RGBDFrame objects from a TUM-format sequence directory."""

    def __init__(self, seq_dir: str, associations: str, depth_factor: float = 5000.0):
        self.seq_dir = seq_dir
        self.rows = load_associations(associations)
        self.depth_factor = depth_factor

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i: int) -> RGBDFrame:
        t_rgb, rgb_rel, _, d_rel = self.rows[i]
        rgb = _imread(os.path.join(self.seq_dir, rgb_rel))
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, -1)
        depth_raw = _imread(os.path.join(self.seq_dir, d_rel))
        depth = depth_raw.astype(np.float32) / self.depth_factor
        return RGBDFrame(t_rgb, rgb.astype(np.uint8), depth)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def to_gray(rgb: np.ndarray, rgb_order: int = 1) -> np.ndarray:
    """uint8 RGB/BGR -> float32 gray in [0,255] (ITU-R BT.601 like cv2)."""
    rgbf = rgb.astype(np.float32)
    if rgb_order == 1:
        r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    else:
        b, g, r = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b
