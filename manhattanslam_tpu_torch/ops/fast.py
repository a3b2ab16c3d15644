"""FAST-9/16 corner detection (counterpart of manhattanslam_tpu/ops/fast.py
and, for the dense score, of the Pallas kernels in ops/fast_pallas.py).

``fast_score_levels`` is the kernel's wrapper: it scores every pyramid
level of a frame (or of B streams' frames) into one level-major buffer.
For CPU tensors it runs the plain PyTorch version
``fast_score_levels_plain``; for CUDA tensors it makes ONE launch of
``csrc/fast.cu`` (see the bound and design notes there) or raises.
``fast_score_map`` scores one level through it.  ``fast_corners`` adds the
reference's per-cell threshold fallback (iniThFAST / minThFAST) and 3x3
non-maximum suppression.

Images are (H, W), or (B, H, W) for B streams (the reference's vmapped
replay, whose batched Pallas twin ``_fast_kernel_batched`` grids over the
batch).
"""

from __future__ import annotations

import ctypes
import math

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


TILE = (32, 32)  # (rows, columns) of a csrc/fast.cu tile, halo excluded


def fast_tile_table(shapes, batch: int) -> dict[str, list[int]]:
    """The tile table of one csrc/fast.cu launch over levels of these
    (h, w) shapes, `batch` images each: per level the tile columns and the
    tiles of one image, and the prefix over levels of batch * tiles, so
    flat tile i lies in the level whose prefix range holds it."""
    tiles_x = [-(-w // TILE[1]) for _, w in shapes]
    tiles_img = [-(-h // TILE[0]) * tx for (h, _), tx in zip(shapes, tiles_x)]
    return {"tiles_x": tiles_x, "tiles_img": tiles_img,
            "tile_start": kernel_build.prefix(batch * t for t in tiles_img)}


def fast_score_levels_plain(levels: list[torch.Tensor]) -> list[torch.Tensor]:
    """The plain version per level, filling the same level-major buffer."""
    out = levels[0].new_empty(sum(lv.numel() for lv in levels))
    views = kernel_build.level_views(out, [lv.shape for lv in levels])
    for view, lv in zip(views, levels):
        view.copy_(fast_score_map_plain(lv))
    return views


def kernel_args(levels: list[torch.Tensor], outs: list[torch.Tensor]) -> tuple:
    """The C arguments of one csrc/fast.cu launch over `levels` into the
    score maps `outs`, all but the stream: host arrays of the level
    table."""
    shapes = [tuple(lv.shape[-2:]) for lv in levels]
    table = fast_tile_table(shapes, math.prod(levels[0].shape[:-2]))
    return (
        kernel_build.c_array(ctypes.c_void_p, [lv.data_ptr() for lv in levels]),
        kernel_build.c_array(ctypes.c_void_p, [o.data_ptr() for o in outs]),
        kernel_build.c_array(ctypes.c_int, [h for h, _ in shapes]),
        kernel_build.c_array(ctypes.c_int, [w for _, w in shapes]),
        kernel_build.c_array(ctypes.c_int, table["tiles_x"]),
        kernel_build.c_array(ctypes.c_int, table["tiles_img"]),
        kernel_build.c_array(ctypes.c_int, table["tile_start"]),
        len(levels),
    )


def fast_score_levels(levels: list[torch.Tensor]) -> list[torch.Tensor]:
    """Dense FAST-9 score maps of the pyramid levels `levels`, each an
    (H_l, W_l) or (B, H_l, W_l) float32 image with the same leading shape.
    Returns one score map per level, each a contiguous view of one
    level-major buffer [level][B][H_l][W_l].  The plain version on the
    CPU; on the card one launch of the CUDA kernel (counted) for every
    level and stream."""
    if levels[0].device.type == "cpu":
        return fast_score_levels_plain(levels)
    dev, lead = levels[0].device, levels[0].shape[:-2]
    if dev.type != "cuda":
        raise ValueError(f"fast_score_levels: unsupported device {dev}")
    if not 1 <= len(levels) <= kernel_build.MAX_LEVELS:
        raise ValueError(f"fast_score_levels: takes 1 to {kernel_build.MAX_LEVELS} levels")
    for lv in levels:
        if (lv.device != dev or lv.dtype != torch.float32 or lv.dim() not in (2, 3)
                or lv.shape[:-2] != lead or not lv.is_contiguous()):
            raise ValueError("fast_score_levels: needs contiguous (H, W) or (B, H, W) float32 "
                             "images with one leading shape on one CUDA device")
    out = torch.empty(sum(lv.numel() for lv in levels), dtype=torch.float32, device=dev)
    views = kernel_build.level_views(out, [lv.shape for lv in levels])
    fn = kernel_build.kernel("fast")
    err = fn(*kernel_args(levels, views), torch.cuda.current_stream(dev).cuda_stream)
    kernel_build.check_launch("fast", err)
    fast_score_levels.launches += 1
    return views


fast_score_levels.launches = 0


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9 score map of one (H, W) or (B, H, W) float32 image
    stack (``fast_score_levels`` of one level)."""
    return fast_score_levels([img])[0]


def threshold_nms(score: torch.Tensor, cell: int = 30, ini_th: int = 20,
                  min_th: int = 7) -> torch.Tensor:
    """The reference's per-cell threshold fallback and 3x3 NMS on a FAST
    score map (..., H, W).

    A pixel survives if its score exceeds iniThFAST, or exceeds minThFAST
    in a cell where no pixel passed iniThFAST (ORBextractor.cc:763-769),
    and it is a 3x3 local maximum.  Returns the masked score map.
    """
    lead, (h, w) = score.shape[:-2], score.shape[-2:]
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


def fast_corners(
    img: torch.Tensor, cell: int = 30, ini_th: int = 20, min_th: int = 7
) -> torch.Tensor:
    """Corner response map of an image (..., H, W): its FAST score through
    ``threshold_nms``."""
    return threshold_nms(fast_score_map(img), cell, ini_th, min_th)
