"""Tracking states and the per-frame trajectory record (counterpart of the
definitions at the top of manhattanslam_tpu/frontend/tracking.py)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
LOST = "LOST"


@dataclass
class FrameRecord:
    """Per-frame trajectory bookkeeping (Tracking.cc:531-544)."""

    timestamp: float
    ref_kf: int
    T_cr: np.ndarray  # Tcw * inv(T_ref)
    lost: bool
