"""Oriented-BRIEF keypoints: grid top-K selection, IC angle, steered BRIEF
(counterpart of manhattanslam_tpu/ops/orb.py and, for the angle and the
descriptor, of the Pallas kernels in ops/orb_pallas.py).

``ic_angle_levels`` and ``brief_levels`` are kernel wrappers: for CPU
tensors they run the plain PyTorch versions (``*_plain``); for CUDA
tensors they launch ``csrc/ic_angle.cu`` / ``csrc/brief.cu`` (bound and
design notes there) or raise.  Each takes every pyramid level's
keypoints in one level-major buffer and makes one launch for all of
them; ``ic_angle`` and ``brief_level`` are their one-level forms.
``brief_levels`` takes the raw level images and computes the
integer-rounded blur that BRIEF samples itself;
``brief_descriptors_plain`` samples an image blurred already (the
reference's ``brief_descriptors``).

Every function takes one image with its (N,) keypoints, or B streams'
images (B, H, W) with (B, N) keypoints each (the reference's vmapped
replay, whose batched Pallas twins ``_make_moments_kernel_batched`` and
``_make_brief_kernel_batched`` grid over the batch): one kernel launch
serves all B streams.

Descriptors are (..., N, 8) int32 tensors holding the bits of the
reference's uint32 words (torch has no right shift for uint32 on the
CPU); compare them through ``.view(torch.uint32)`` or numpy.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from manhattanslam_tpu_torch.ops import image as image_ops
from manhattanslam_tpu_torch.ops import kernel_build

HALF_PATCH = 15  # IC_Angle circular patch radius (ORBextractor.cc HALF_PATCH_SIZE)
EDGE_THRESHOLD = 19  # min distance of a keypoint from the level border
PATTERN_BITS = 256


def _make_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 2, 2) int32 sample-point pairs (y, x), Gaussian sigma=patch/5,
    clipped to the radius-13 disc so any rotation stays inside the 31x31
    patch read window (the reference package's seeded pattern)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 31 / 5.0, size=(PATTERN_BITS, 2, 2))
    r = np.sqrt((pts**2).sum(-1, keepdims=True))
    scale = np.minimum(1.0, 13.0 / np.maximum(r, 1e-6))
    return np.round(pts * scale).astype(np.int32)


PATTERN = _make_pattern()  # (256, 2, 2) as (bit, point01, (y, x))
# A rotated pattern point r keeps its norm, so |round(r_x)|, |round(r_y)|
# <= round(max norm) = 13 at any angle; plus 1 for a keypoint between
# pixels, every sample lies within this radius of the keypoint's floor
# (csrc/brief.cu kSampleR, which stages that window plus the blur's)
BRIEF_SAMPLE_RADIUS = int(np.floor(np.sqrt((PATTERN.astype(np.float64) ** 2).sum(-1)).max()
                                   + 0.5)) + 1
# the integer-rounded Gaussian blur BRIEF samples (ORBextractor.cc:850-856)
BLUR_KSIZE = 7
BLUR_SIGMA = 2.0


def _circular_umax(radius: int = HALF_PATCH) -> np.ndarray:
    """Per-row max |x| of the circular patch (reference umax)."""
    umax = np.zeros(radius + 1, dtype=np.int32)
    for v in range(radius + 1):
        umax[v] = int(np.sqrt(radius * radius - v * v) + 0.5)
    return umax


UMAX = _circular_umax()
# disc rows of column |dx|: |dy| <= IC_ROW_EXTENT[|dx|] (UMAX is
# non-increasing, so they are one contiguous range)
IC_ROW_EXTENT = np.array(
    [max(v for v in range(HALF_PATCH + 1) if UMAX[v] >= a) for a in range(HALF_PATCH + 1)],
    dtype=np.int32,
)


def _patch_mask(radius: int = HALF_PATCH) -> np.ndarray:
    """(2r+1, 2r+1) bool mask of the circular patch."""
    d = 2 * radius + 1
    _, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    mask = np.zeros((d, d), bool)
    for v in range(-radius, radius + 1):
        mask[v + radius, :] = np.abs(xs[v + radius]) <= UMAX[abs(v)]
    return mask


CIRC_MASK = _patch_mask()


@functools.lru_cache(maxsize=None)
def device_constant(name: str, device: torch.device) -> torch.Tensor:
    """PATTERN / CIRC_MASK as a tensor on `device`, uploaded once."""
    table = {"PATTERN": PATTERN, "CIRC_MASK": CIRC_MASK}[name]
    return torch.from_numpy(table).to(device)


def _topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, lowest index first among ties (the order
    of jax.lax.top_k; torch.topk leaves ties unordered)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_grid_topk(
    score: torch.Tensor, n_out: int, cell: int = 32, k_per_cell: int = 8
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick n_out keypoints of each score map (..., H, W): top-k_per_cell
    per cell, then global top-n_out.

    Returns (xy (..., n_out, 2) float32, response (..., n_out), valid
    (..., n_out) bool).  Invalid slots have response 0.
    """
    lead, (h, w) = score.shape[:-2], score.shape[-2:]
    ch, cw = -(-h // cell), -(-w // cell)
    sp = F.pad(score, (0, cw * cell - w, 0, ch * cell - h))
    cells = sp.reshape(*lead, ch, cell, cw, cell).transpose(-3, -2)
    cells = cells.reshape(*lead, ch * cw, cell * cell)
    vals, idx = _topk_stable(cells, k_per_cell)
    cid = torch.arange(ch * cw, device=score.device)[:, None]
    ys = (cid // cw) * cell + idx // cell
    xs = (cid % cw) * cell + idx % cell
    flat_v, flat_y, flat_x = (t.reshape(*lead, -1) for t in (vals, ys, xs))
    n_cand = flat_v.shape[-1]
    if n_cand < n_out:
        padn = n_out - n_cand
        flat_v = F.pad(flat_v, (0, padn))
        flat_y = F.pad(flat_y, (0, padn))
        flat_x = F.pad(flat_x, (0, padn))
    top_v, top_i = _topk_stable(flat_v, n_out)
    xy = torch.stack([flat_x.gather(-1, top_i), flat_y.gather(-1, top_i)], -1)
    return xy.to(torch.float32), top_v, top_v > 0.0


def gather_pixels(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """img (..., H, W) at flat pixel indices idx (..., *) of each image."""
    lead = img.shape[:-2]
    flat = img.reshape(*lead, -1)
    return flat.gather(-1, idx.reshape(*lead, -1)).reshape(idx.shape)


def _check_keypoint_batch(name: str, img: torch.Tensor, xy: torch.Tensor) -> tuple[int, int]:
    """Kernel-side checks shared by the wrappers: an (H, W) or (B, H, W)
    contiguous float32 image with contiguous (N, 2) or (B, N, 2) float32
    keypoints on the same CUDA device.  Returns (B, N)."""
    if img.device.type != "cuda" or xy.device != img.device:
        raise ValueError(f"{name}: unsupported devices {img.device}, {xy.device}")
    if img.dtype != torch.float32 or img.dim() not in (2, 3) or not img.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous (H, W) or (B, H, W) float32 image")
    if (xy.dtype != torch.float32 or xy.dim() != img.dim() or xy.shape[-1] != 2
            or xy.shape[:-2] != img.shape[:-2] or not xy.is_contiguous()):
        raise ValueError(f"{name}: needs contiguous (N, 2) or (B, N, 2) float32 keypoints")
    return (img.shape[0] if img.dim() == 3 else 1), xy.shape[-2]


def ic_patch_index(xy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., N, 31, 31) flat pixel indices of each keypoint's IC-angle
    patch.  Centres are truncated to integers and clipped so the disc
    stays inside the image."""
    r = HALF_PATCH
    x0 = torch.clamp(xy[..., 0].to(torch.int32), r, w - r - 1).long()
    y0 = torch.clamp(xy[..., 1].to(torch.int32), r, h - r - 1).long()
    d = torch.arange(-r, r + 1, device=xy.device)
    return (y0[..., None, None] + d[:, None]) * w + (x0[..., None, None] + d[None, :])


def ic_angle_plain(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint (radians): first moments
    of the radius-15 circular patch (CIRC_MASK), atan2(m01, m10).
    img (..., H, W), xy (..., N, 2) -> (..., N).

    The moments and atan2 are taken in float64 and the angle is rounded to
    float32 (a float32 pixel times an offset below 16 is exact in float64):
    the CPU's float32 atan2 rounds an element differently depending on
    whether it falls in a vector lane or the scalar tail, so a float32
    angle would depend on the batch shape."""
    h, w = img.shape[-2:]
    patch = gather_pixels(img, ic_patch_index(xy, h, w)).to(torch.float64)
    mask = device_constant("CIRC_MASK", img.device)
    vals = torch.where(mask, patch, torch.zeros((), dtype=torch.float64, device=img.device))
    df = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=img.device, dtype=torch.float64)
    m01 = torch.sum(vals * df[:, None], dim=(-2, -1))
    m10 = torch.sum(vals * df[None, :], dim=(-2, -1))
    return torch.atan2(m01, m10).to(torch.float32)


def keypoint_starts(budgets, batch: int) -> list[int]:
    """Start of each level's keypoints in the level-major layout
    [level][B][n_l] (and the total, last): the prefix of batch * n_l."""
    return kernel_build.prefix(batch * n for n in budgets)


def level_keypoint_views(flat: torch.Tensor, budgets, lead) -> list[torch.Tensor]:
    """Each level's (*lead, n_l, ...) contiguous view of a level-major
    keypoint buffer flat (sum B * n_l, ...)."""
    return kernel_build.level_views(
        flat.reshape(-1), [tuple(lead) + (n,) + flat.shape[1:] for n in budgets])


def ic_angle_levels_plain(levels, xy_flat, budgets) -> torch.Tensor:
    """The plain version per level, filling the same level-major layout."""
    lead = levels[0].shape[:-2]
    out = torch.empty(xy_flat.shape[:1], dtype=torch.float32, device=xy_flat.device)
    for ang, lv, xy in zip(level_keypoint_views(out, budgets, lead), levels,
                           level_keypoint_views(xy_flat, budgets, lead)):
        ang.copy_(ic_angle_plain(lv, xy))
    return out


def _level_table(levels, budgets) -> tuple:
    """The level table of a csrc/ic_angle.cu or csrc/brief.cu launch as
    host arrays: image pointers, h, w, keypoints per image, keypoint
    starts."""
    shapes = [tuple(lv.shape[-2:]) for lv in levels]
    return (
        kernel_build.c_array(ctypes.c_void_p, [lv.data_ptr() for lv in levels]),
        kernel_build.c_array(ctypes.c_int, [h for h, _ in shapes]),
        kernel_build.c_array(ctypes.c_int, [w for _, w in shapes]),
        kernel_build.c_array(ctypes.c_int, list(budgets)),
        kernel_build.c_array(ctypes.c_int,
                             keypoint_starts(budgets, math.prod(levels[0].shape[:-2]))),
    )


def kernel_args(levels, budgets) -> tuple:
    """The level-table arguments of one csrc/ic_angle.cu launch (host
    arrays), to be followed by xy, angle and the stream."""
    return (*_level_table(levels, budgets),
            kernel_build.c_array(ctypes.c_int, IC_ROW_EXTENT.tolist()), len(levels))


def _check_levels(name: str, levels, xy_flat: torch.Tensor, budgets, min_side: int) -> None:
    """Kernel-side checks of an all-level wrapper: 1 to MAX_LEVELS
    contiguous float32 images (H_l, W_l) or (B, H_l, W_l) with one leading
    shape on one CUDA device, each at least min_side on a side, with a
    budget each, and the contiguous (sum B * n_l, 2) float32 keypoints."""
    dev, lead = levels[0].device, levels[0].shape[:-2]
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not 1 <= len(levels) == len(budgets) <= kernel_build.MAX_LEVELS:
        raise ValueError(f"{name}: takes 1 to {kernel_build.MAX_LEVELS} levels, "
                         "each with its budget")
    for lv in levels:
        if (lv.device != dev or lv.dtype != torch.float32 or lv.dim() not in (2, 3)
                or lv.shape[:-2] != lead or not lv.is_contiguous()):
            raise ValueError(f"{name}: needs contiguous (H, W) or (B, H, W) float32 "
                             "images with one leading shape on one CUDA device")
        if min(lv.shape[-2:]) < min_side:
            raise ValueError(f"{name}: image side below {min_side}")
    if (xy_flat.device != dev or xy_flat.dtype != torch.float32 or not xy_flat.is_contiguous()
            or tuple(xy_flat.shape) != (keypoint_starts(budgets, math.prod(lead))[-1], 2)):
        raise ValueError(f"{name}: needs contiguous (sum B * n_l, 2) float32 keypoints")


def ic_angle_levels(levels: list[torch.Tensor], xy_flat: torch.Tensor, budgets) -> torch.Tensor:
    """IC angles of every level's keypoints: levels[l] is an (H_l, W_l) or
    (B, H_l, W_l) float32 image (one leading shape for all), budgets[l]
    its keypoints per image, and xy_flat the (sum_l B * n_l, 2) float32
    keypoints in the level-major layout [level][B][n_l].  Returns the
    (sum_l B * n_l,) angles in the same layout, so each level's angles are
    a contiguous (B, n_l) view.  The plain version on the CPU; on the card
    one launch of the CUDA kernel (counted) for every level and stream."""
    if levels[0].device.type == "cpu":
        return ic_angle_levels_plain(levels, xy_flat, budgets)
    _check_levels("ic_angle_levels", levels, xy_flat, budgets, 2 * HALF_PATCH + 1)
    dev = levels[0].device
    out = torch.empty(xy_flat.shape[:1], dtype=torch.float32, device=dev)
    fn = kernel_build.kernel("ic_angle")
    err = fn(*kernel_args(levels, budgets), xy_flat.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    kernel_build.check_launch("ic_angle", err)
    ic_angle_levels.launches += 1
    return out


ic_angle_levels.launches = 0


def ic_angle(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """IC angle of keypoints xy (N, 2) on an (H, W) float32 image, or of
    (B, N, 2) on a (B, H, W) stack (``ic_angle_levels`` of one level)."""
    if img.device.type != "cpu":
        _check_keypoint_batch("ic_angle", img, xy)
    return ic_angle_levels([img], xy.reshape(-1, 2), [xy.shape[-2]]).view(xy.shape[:-1])


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 words, bit j of word i = bit 32i+j."""
    lanes = bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device
    )
    words = torch.sum(lanes * weights, dim=-1)  # in [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def brief_sample_index(
    xy: torch.Tensor, cos_a: torch.Tensor, sin_a: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """(..., N, 256, 2) flat pixel indices of the steered pattern: each
    point (py, px) rotated by the keypoint angle, added to the keypoint,
    rounded half to even and clipped to the image."""
    pat = device_constant("PATTERN", xy.device).to(torch.float32)  # (256, 2, 2)
    py, px = pat[..., 0], pat[..., 1]
    c, s = cos_a[..., None, None], sin_a[..., None, None]
    rx = px * c - py * s
    ry = px * s + py * c
    sx = torch.clamp(torch.round(xy[..., 0, None, None] + rx), 0, w - 1).to(torch.int64)
    sy = torch.clamp(torch.round(xy[..., 1, None, None] + ry), 0, h - 1).to(torch.int64)
    return sy * w + sx


def brief_descriptors_plain(
    blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor
) -> torch.Tensor:
    """Steered BRIEF: (..., N, 8) int32 words, bit j of word i set when the
    first sample of pair 32i+j is darker than the second (integer-rounded
    blurred intensities (..., H, W))."""
    h, w = blurred.shape[-2:]
    idx = brief_sample_index(xy, torch.cos(angle), torch.sin(angle), h, w)
    vals = gather_pixels(blurred, idx)
    return _pack_words(vals[..., 0] < vals[..., 1])


def brief_levels_plain(levels, xy_flat, angle_flat, budgets) -> torch.Tensor:
    """The plain version per level: the integer-rounded blur of the level,
    then ``brief_descriptors_plain``, filling the same level-major
    layout."""
    lead = levels[0].shape[:-2]
    out = torch.empty(xy_flat.shape[:1] + (8,), dtype=torch.int32, device=xy_flat.device)
    for desc, lv, xy, a in zip(level_keypoint_views(out, budgets, lead), levels,
                               level_keypoint_views(xy_flat, budgets, lead),
                               level_keypoint_views(angle_flat, budgets, lead)):
        blurred = torch.round(image_ops.gaussian_blur(lv, BLUR_KSIZE, BLUR_SIGMA))
        desc.copy_(brief_descriptors_plain(blurred, xy, a))
    return out


def brief_threads(batch: int) -> int:
    """Threads per keypoint of a csrc/brief.cu launch over `batch`
    streams: a block of 128 for one stream, whose ~1000 keypoints leave
    most of the card idle, so a keypoint's shorter chain wins; one warp
    for more, which fill it (the faster of the two at B = 1 and B = 8 on
    the H100; chip_smoke.py times both)."""
    return 128 if batch == 1 else 32


def brief_kernel_args(levels, budgets, threads: int | None = None) -> tuple:
    """The level-table arguments of one csrc/brief.cu launch (host
    arrays), to be followed by xy, cos, sin, pattern, words and the
    stream; `threads` per keypoint (32 or 128, by default
    ``brief_threads``) picks the kernel's layout."""
    weights = image_ops.gauss_kernel1d(BLUR_KSIZE, BLUR_SIGMA).tolist()
    if threads is None:
        threads = brief_threads(math.prod(levels[0].shape[:-2]))
    return (*_level_table(levels, budgets), kernel_build.c_array(ctypes.c_float, weights),
            len(levels), BRIEF_SAMPLE_RADIUS, threads)


def brief_levels(levels: list[torch.Tensor], xy_flat: torch.Tensor, angle_flat: torch.Tensor,
                 budgets) -> torch.Tensor:
    """Steered BRIEF of every level's keypoints on the integer-rounded blur
    of the raw level images: levels, budgets and xy_flat as
    ``ic_angle_levels`` takes them, angle_flat the (sum_l B * n_l,)
    float32 angles in the same layout.  Returns the (sum_l B * n_l, 8)
    int32 words, level-major, so each level's words are a contiguous
    (B, n_l, 8) view.  The plain version on the CPU; on the card one
    launch of the CUDA kernel (counted) for every level and stream, which
    blurs each keypoint's window itself.  Both take cos/sin of the angles
    from torch, so the two agree bit for bit on the same device."""
    if levels[0].device.type == "cpu":
        return brief_levels_plain(levels, xy_flat, angle_flat, budgets)
    # the blur's reflect padding needs a side above its radius
    _check_levels("brief_levels", levels, xy_flat, budgets, BLUR_KSIZE // 2 + 1)
    dev = levels[0].device
    if (angle_flat.device != dev or angle_flat.dtype != torch.float32
            or not angle_flat.is_contiguous() or angle_flat.shape != xy_flat.shape[:1]):
        raise ValueError("brief_levels: needs contiguous (sum B * n_l,) float32 angles")
    ca = torch.cos(angle_flat)
    sa = torch.sin(angle_flat)
    out = torch.empty(xy_flat.shape[:1] + (8,), dtype=torch.int32, device=dev)
    fn = kernel_build.kernel("brief")
    err = fn(*brief_kernel_args(levels, budgets), xy_flat.data_ptr(), ca.data_ptr(),
             sa.data_ptr(), device_constant("PATTERN", dev).data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    kernel_build.check_launch("brief", err)
    brief_levels.launches += 1
    return out


brief_levels.launches = 0


def brief_level(level_img: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF of keypoints xy (N, 2) with angles (N,) on the
    integer-rounded blur of a raw (H, W) float32 level, or of (B, N, 2) on
    a (B, H, W) stack (``brief_levels`` of one level): (..., N, 8) words."""
    if level_img.device.type != "cpu":
        _check_keypoint_batch("brief_level", level_img, xy)
    words = brief_levels([level_img], xy.reshape(-1, 2), angle.reshape(-1), [xy.shape[-2]])
    return words.view(xy.shape[:-1] + (8,))


def unpack_descriptor_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 256) float32 in {0, 1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (256,)).to(torch.float32)
