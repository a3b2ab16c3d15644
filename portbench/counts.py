"""Operations and bytes of the port's three hand-written CUDA kernels, and
the least time the card could take for them: the yardstick's copy of
chip_smoke.py's counts and of the published peaks of one H100 SXM.

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again; where the work depends on the keypoints
(the pixels IC's discs and BRIEF's samples touch), the counts take the
keypoints the plain reference extracts from the same frame.  The least
time is the larger of bytes over the HBM rate and float operations over
the float32 rate outside the tensor cores, at the full 700 W.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import orb as ref_orb

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# float ops per interior pixel of the FAST score: per polarity 42 min (max)
# for the 16 arcs and 15 to reduce the rotations; 2 subtractions of the
# centre; 2 final maxes
FAST_OPS_PER_PIXEL = 2 * (42 + 15) + 2 + 2
# per disc pixel: 2 multiplies + 2 adds (m01, m10)
IC_OPS_PER_PIXEL = 4
# per pattern point: 4 multiplies, 2 add/sub, 2 adds, 2 roundings, 4
# clamps; per pair 2 points + 1 compare
BRIEF_OPS_PER_PAIR = 2 * 14 + 1
# per blurred pixel: 7 multiplies and 6 adds in each of the two passes
BLUR_OPS_PER_PIXEL = 2 * (7 + 6)
IC_ROW_EXTENT_LEN = ref_orb.HALF_PATCH + 1  # int32 table of the disc's row extents
PATTERN_INTS = 256 * 2 * 2
# the kernels' names in a device trace
KERNEL_NAMES = {"fast": "fast_score_levels_kernel", "ic_angle": "ic_angle_levels_kernel",
                "brief": "brief_levels_kernel"}


def least_ms(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3


def active_shapes(h: int, w: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    """The pyramid levels large enough for the 31x31 patch window, the
    ones every kernel reads."""
    return [s for s in ref_orb.pyramid_shapes(h, w, n_levels, scale)
            if min(s) >= 2 * ref_orb.EDGE_THRESHOLD + 3]


def fast_counts(shapes, batch: int) -> tuple[float, float]:
    """(bytes, ops) of one FAST launch over levels of these shapes, `batch`
    images each: every level pixel read and its score written (float32)."""
    n_bytes = sum(2 * batch * h * w * 4 for h, w in shapes)
    n_ops = sum(FAST_OPS_PER_PIXEL * batch * (h - 6) * (w - 6) for h, w in shapes)
    return float(n_bytes), float(n_ops)


def ic_counts(n_kp: int, disc_pixels: int, distinct_pixels: int) -> tuple[float, float]:
    """(bytes, ops) of one IC-angle launch: `n_kp` keypoint slots of every
    level and image (xy in, angle out, the row-extent table), the distinct
    level pixels their discs cover read once; `disc_pixels` pixels per
    disc."""
    n_bytes = 4 * IC_ROW_EXTENT_LEN + 8 * n_kp + 4 * n_kp + 4 * distinct_pixels
    return float(n_bytes), float(IC_OPS_PER_PIXEL * disc_pixels * n_kp)


def brief_counts(n_kp: int, sampled_pixels: int, blurred_pixels: int) -> tuple[float, float]:
    """(bytes, ops) of one BRIEF launch: each level pixel within the blur's
    radius of a sample read once, keypoints and angles in, 8 words out; the
    pairs' float ops and the blur's at each distinct sampled pixel."""
    n_bytes = 4 * blurred_pixels + 12 * n_kp + 4 * PATTERN_INTS + 32 * n_kp
    n_ops = BRIEF_OPS_PER_PAIR * 256 * n_kp + BLUR_OPS_PER_PIXEL * sampled_pixels
    return float(n_bytes), float(n_ops)


def keypoint_pixels(levels: list[torch.Tensor], level_xy: list[torch.Tensor],
                    level_angle: list[torch.Tensor]) -> dict:
    """The data-dependent terms of one launch over these active levels
    (..., h, w) and every slot's keypoints (..., n, 2) and angles (..., n):
    IC's distinct disc pixels, BRIEF's distinct sampled pixels and the
    distinct pixels within the blur's radius of them, over all images."""
    r = ref_orb.HALF_PATCH
    circ = torch.from_numpy(ref_orb.CIRC_MASK).reshape(-1)
    d = torch.arange(-r, r + 1)
    pat = torch.from_numpy(ref_orb.PATTERN).to(torch.float32)
    py, px = pat[..., 0], pat[..., 1]
    distinct = sampled = blurred = 0
    for lv, xy, ang in zip(levels, level_xy, level_angle):
        h, w = lv.shape[-2:]
        xy, ang = xy.reshape(-1, xy.shape[-2], 2).cpu(), ang.reshape(-1, ang.shape[-1]).cpu()
        b, n = xy.shape[:2]
        off = (torch.arange(b) * h * w)[:, None, None]
        x0 = torch.clamp(xy[..., 0].to(torch.int32), r, w - r - 1).long()
        y0 = torch.clamp(xy[..., 1].to(torch.int32), r, h - r - 1).long()
        disc = ((y0[..., None, None] + d[:, None]) * w + (x0[..., None, None] + d[None, :]))
        disc = disc.reshape(b, n, -1)[..., circ]
        distinct += int(torch.unique(disc + off).numel())
        c, s = torch.cos(ang)[..., None, None], torch.sin(ang)[..., None, None]
        sx = torch.clamp(torch.round(xy[..., 0, None, None] + (px * c - py * s)), 0, w - 1).long()
        sy = torch.clamp(torch.round(xy[..., 1, None, None] + (px * s + py * c)), 0, h - 1).long()
        mask = torch.zeros(b * h * w)
        mask[((sy * w + sx).reshape(b, n, -1) + off).reshape(-1)] = 1.0
        sampled += int(mask.sum())
        k = ref_orb.BLUR_KSIZE // 2
        blurred += int(F.max_pool2d(mask.view(b, 1, h, w), 2 * k + 1, 1, k).sum())
    return {"disc_pixels": int(circ.sum()), "distinct": distinct, "sampled": sampled,
            "blurred": blurred}


def launch_least_ms(shapes, batch: int, n_kp: int, pixels: dict) -> dict:
    """Least ms of one launch of each kernel (keyed as KERNEL_NAMES)."""
    return {
        "fast": least_ms(*fast_counts(shapes, batch)),
        "ic_angle": least_ms(*ic_counts(n_kp, pixels["disc_pixels"], pixels["distinct"])),
        "brief": least_ms(*brief_counts(n_kp, pixels["sampled"], pixels["blurred"])),
    }
