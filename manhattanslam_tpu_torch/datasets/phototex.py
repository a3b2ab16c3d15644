"""Photo-textured validation scene: real-image statistics without datasets
(counterpart of manhattanslam_tpu/datasets/phototex.py).

The box-room raycaster textured with crops of a real PHOTOGRAPH,
matplotlib's bundled ``grace_hopper.jpg``: each room face samples a
randomly rotated and offset window of the photo, mirror-tiled and mixed
across two zoom levels, so frames carry natural image statistics (real
gradient distributions, corner structure, multi-scale texture) instead
of procedural hash noise; the renderer's geometry and ground-truth poses
are unchanged (datasets/synthetic.py).

CPU only: ``load_photo`` reads the photo from matplotlib's sample data
through PIL, and the card's machine has neither.  Both are imported
inside ``load_photo``, so this module imports anywhere.
"""

from __future__ import annotations

import os

import numpy as np

from manhattanslam_tpu_torch.config import CameraConfig
from manhattanslam_tpu_torch.datasets.synthetic import BoxRoom, SyntheticSequence

_photo_cache = None


def load_photo() -> np.ndarray:
    """The bundled real photograph as float32 gray (H, W) in [0, 255]."""
    global _photo_cache
    if _photo_cache is not None:
        return _photo_cache
    import matplotlib

    path = os.path.join(
        os.path.dirname(matplotlib.__file__), "mpl-data", "sample_data",
        "grace_hopper.jpg",
    )
    from PIL import Image

    img = np.asarray(Image.open(path).convert("L"), dtype=np.float32)
    _photo_cache = img
    return _photo_cache


def _reflect_idx(i: np.ndarray, n: int) -> np.ndarray:
    """Mirror-tiling index: ...2,1,0,1,2...n-1,n-2... (no seams)."""
    period = 2 * (n - 1)
    j = np.abs(np.mod(i, period))
    return np.where(j >= n, period - j, j).astype(np.int64)


def _sample(photo: np.ndarray, px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """Bilinear sample with mirror tiling (px, py in photo pixels)."""
    h, w = photo.shape
    x0 = np.floor(px)
    y0 = np.floor(py)
    fx = (px - x0).astype(np.float32)
    fy = (py - y0).astype(np.float32)
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)
    xi0 = _reflect_idx(x0, w)
    xi1 = _reflect_idx(x0 + 1, w)
    yi0 = _reflect_idx(y0, h)
    yi1 = _reflect_idx(y0 + 1, h)
    v00 = photo[yi0, xi0]
    v01 = photo[yi0, xi1]
    v10 = photo[yi1, xi0]
    v11 = photo[yi1, xi1]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def make_photo_texture(px_per_m: float = 160.0):
    """Returns texture(u, v, face_id, seed) sampling the real photo.

    Per-face random rotation + offset decorrelates the walls; two zoom
    levels (1x and 0.23x) give multi-scale structure so coarse pyramid
    levels still see texture.
    """
    photo = load_photo()

    def texture(u, v, face_id, seed):
        rng = np.random.default_rng(seed * 1009 + face_id)
        out = None
        for scale, weight in ((1.0, 0.65), (0.23, 0.35)):
            ang = rng.uniform(0, 2 * np.pi)
            ox, oy = rng.uniform(0, 1000, 2)
            ca, sa = np.cos(ang), np.sin(ang)
            px = (u * ca - v * sa) * px_per_m * scale + ox
            py = (u * sa + v * ca) * px_per_m * scale + oy
            s = _sample(photo, px, py)
            out = s * weight if out is None else out + s * weight
        # mild per-face brightness variation (lighting-like)
        gain = rng.uniform(0.75, 1.05)
        return np.clip(out * gain + rng.uniform(0, 25), 0, 255)

    return texture


class PhotoSequence(SyntheticSequence):
    """Box-room RGB-D sequence with real-photograph textures and a
    Kinect-like quadratic depth-noise model."""

    def __init__(
        self,
        n_frames: int = 30,
        cam: CameraConfig | None = None,
        depth_noise: float = 1.425e-3,  # sigma(z) = noise * z^2 (Kinect-like)
        seed: int = 0,
        view: str = "corner",
    ):
        room = BoxRoom(texture_fn=make_photo_texture(), seed=7 + seed)
        super().__init__(
            n_frames=n_frames, cam=cam, room=room,
            depth_noise=depth_noise, seed=seed, view=view,
        )
