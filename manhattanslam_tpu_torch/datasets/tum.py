"""TUM RGB-D helpers (counterpart of manhattanslam_tpu/datasets/tum.py).

Only the colour conversion that ``System.track`` needs; the sequence
loader comes with the slice that runs recorded sequences.
"""

from __future__ import annotations

import numpy as np


def to_gray(rgb: np.ndarray, rgb_order: int = 1) -> np.ndarray:
    """uint8 RGB/BGR -> float32 gray in [0,255] (ITU-R BT.601 like cv2)."""
    rgbf = rgb.astype(np.float32)
    if rgb_order == 1:
        r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    else:
        b, g, r = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b
