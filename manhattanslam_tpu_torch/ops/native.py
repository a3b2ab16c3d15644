"""ctypes binding of the exact AHC plane merge in host C++
(``csrc/ahc_merge.cpp``; counterpart of manhattanslam_tpu/ops/native.py).

The card does the dense plane math; the inherently sequential min-MSE
merge heap runs on the host, in C++.  ``ops/kernel_build.py`` compiles
the source on first use with one ``g++`` call into the git-ignored
``build/torch_kernels/``.  Nothing falls back: a missing compiler or a
failed build raises (``merge_blocks(use_native=False)`` asks for the
Python merge explicitly).
"""

from __future__ import annotations

import ctypes

import numpy as np

from manhattanslam_tpu_torch.ops import kernel_build


def have_native() -> bool:
    """Does the C++ merge build and load here?"""
    try:
        kernel_build.kernel("ahc_merge")
    except (RuntimeError, OSError):
        return False
    return True


def ahc_merge_native(
    stats: dict, grid_shape: tuple[int, int], min_support: int,
    angle_cos: float | None = None,
) -> np.ndarray:
    """C++ AHC merge of host block stats; returns labels (B,) int32.

    angle_cos=None selects the dynamic T_ang(INIT, z) gate in the C++
    (sentinel -1); a float forces a fixed normal gate."""
    if angle_cos is None:
        angle_cos = -1.0
    fn = kernel_build.kernel("ahc_merge")
    bh, bw = grid_shape
    B = bh * bw

    def as64(a, shape):
        return np.ascontiguousarray(np.asarray(a, dtype=np.float64)).reshape(shape)

    n = as64(stats["n"], (B,))
    s1 = as64(stats["s1"], (B, 3))
    s2 = as64(stats["s2"], (B, 3, 3))
    normal = as64(stats["normal"], (B, 3))
    mean = as64(stats["mean"], (B, 3))
    valid = np.ascontiguousarray(np.asarray(stats["valid"]).astype(np.uint8))
    labels = np.empty(B, np.int32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    fn(
        bh, bw,
        p(n, ctypes.c_double), p(s1, ctypes.c_double), p(s2, ctypes.c_double),
        p(normal, ctypes.c_double), p(mean, ctypes.c_double),
        p(valid, ctypes.c_uint8),
        ctypes.c_double(angle_cos), ctypes.c_double(min_support),
        p(labels, ctypes.c_int32),
    )
    return labels
