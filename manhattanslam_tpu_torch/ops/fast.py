"""FAST-9/16 corner detection (counterpart of manhattanslam_tpu/ops/fast.py
and, for the dense score, of the Pallas kernel in ops/fast_pallas.py).

``fast_score_map`` is the kernel's wrapper: for a CPU tensor it runs the
plain PyTorch version ``fast_score_map_plain``; for a CUDA tensor it
launches ``csrc/fast.cu`` (see the bound and design notes there) or
raises.  ``fast_corners`` adds the reference's per-cell threshold
fallback (iniThFAST / minThFAST) and 3x3 non-maximum suppression.

Images are (H, W), or (B, H, W) for B streams (the reference's vmapped
replay, whose batched Pallas twin ``_fast_kernel_batched`` grids over the
batch): one kernel launch scores all B images.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from manhattanslam_tpu_torch.ops import kernel_build
from manhattanslam_tpu_torch.ops.image import maxpool3x3, shift2d

# Bresenham circle of radius 3 (16 offsets, clockwise from 12 o'clock),
# (dy, dx) pairs — the standard FAST-9/16 test set.
CIRCLE_OFFSETS: list[tuple[int, int]] = [
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
]
ARC_LEN = 9  # FAST-9: contiguous arc of >= 9 of 16
HALO = 3


def fast_score_map_plain(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9 score: max(0, max over the 16 rotations of the min over
    a 9-arc of the circle differences), bright and dark; 3-px border 0.
    img: (..., H, W)."""
    h, w = img.shape[-2:]
    diffs = torch.stack([shift2d(img, dy, dx) for dy, dx in CIRCLE_OFFSETS]) - img[None]

    def arc_min(d):
        rolled = [torch.roll(d, -k, dims=0) for k in range(ARC_LEN)]
        return torch.stack(rolled).amin(dim=0)

    bright = arc_min(diffs).amax(dim=0)
    dark = arc_min(-diffs).amax(dim=0)
    score = torch.clamp(torch.maximum(bright, dark), min=0.0)
    out = torch.zeros_like(score)
    out[..., HALO : h - HALO, HALO : w - HALO] = score[..., HALO : h - HALO, HALO : w - HALO]
    return out


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9 score map of an (H, W) or (B, H, W) float32 image
    stack: the plain version on the CPU, one launch of the CUDA kernel
    (counted) for all B images on the card."""
    if img.device.type == "cpu":
        return fast_score_map_plain(img)
    if img.device.type != "cuda":
        raise ValueError(f"fast_score_map: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() not in (2, 3) or not img.is_contiguous():
        raise ValueError("fast_score_map: needs a contiguous (H, W) or (B, H, W) float32 image")
    h, w = img.shape[-2:]
    b = img.shape[0] if img.dim() == 3 else 1
    out = torch.empty_like(img)
    fn = kernel_build.kernel("fast")
    err = fn(img.data_ptr(), out.data_ptr(), b, h, w,
             torch.cuda.current_stream(img.device).cuda_stream)
    kernel_build.check_launch("fast", err)
    fast_score_map.launches += 1
    return out


fast_score_map.launches = 0


def fast_corners(
    img: torch.Tensor, cell: int = 30, ini_th: int = 20, min_th: int = 7
) -> torch.Tensor:
    """Corner response map with the reference's per-cell fallback + NMS.

    A pixel survives if its score exceeds iniThFAST, or exceeds minThFAST
    in a cell where no pixel passed iniThFAST (ORBextractor.cc:763-769),
    and it is a 3x3 local maximum.  Returns the masked score map; img is
    (..., H, W).
    """
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    score = fast_score_map(img)
    ch, cw = -(-h // cell), -(-w // cell)
    sp = F.pad(score, (0, cw * cell - w, 0, ch * cell - h))
    cells = sp.reshape(*lead, ch, cell, cw, cell)
    has_high = (cells > ini_th).any(dim=-1).any(dim=-3)  # (..., ch, cw)
    has_high_full = has_high.repeat_interleave(cell, -2).repeat_interleave(cell, -1)
    has_high_full = has_high_full[..., :h, :w]
    th = torch.where(has_high_full, float(ini_th), float(min_th))
    passed = score > th
    is_max = score >= maxpool3x3(score)
    return torch.where(passed & is_max, score, torch.zeros_like(score))
