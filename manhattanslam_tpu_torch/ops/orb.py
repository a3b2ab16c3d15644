"""Oriented-BRIEF keypoints: grid top-K selection, IC angle, steered BRIEF
(counterpart of manhattanslam_tpu/ops/orb.py and, for the angle and the
descriptor, of the Pallas kernels in ops/orb_pallas.py).

``ic_angle`` and ``brief_descriptors`` are kernel wrappers: for CPU
tensors they run the plain PyTorch versions (``*_plain``); for CUDA
tensors they launch ``csrc/ic_angle.cu`` / ``csrc/brief.cu`` (bound and
design notes there) or raise.

Descriptors are (N, 8) int32 tensors holding the bits of the reference's
uint32 words (torch has no right shift for uint32 on the CPU); compare
them through ``.view(torch.uint32)`` or numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

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


def _circular_umax(radius: int = HALF_PATCH) -> np.ndarray:
    """Per-row max |x| of the circular patch (reference umax)."""
    umax = np.zeros(radius + 1, dtype=np.int32)
    for v in range(radius + 1):
        umax[v] = int(np.sqrt(radius * radius - v * v) + 0.5)
    return umax


UMAX = _circular_umax()


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
    """PATTERN / UMAX / CIRC_MASK as a tensor on `device`, uploaded once."""
    table = {"PATTERN": PATTERN, "UMAX": UMAX, "CIRC_MASK": CIRC_MASK}[name]
    return torch.from_numpy(table).to(device)


def _topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, lowest index first among ties (the order
    of jax.lax.top_k; torch.topk leaves ties unordered)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_grid_topk(
    score: torch.Tensor, n_out: int, cell: int = 32, k_per_cell: int = 8
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick n_out keypoints: top-k_per_cell per cell, then global top-n_out.

    Returns (xy (n_out, 2) float32, response (n_out,), valid (n_out,) bool).
    Invalid slots have response 0.
    """
    h, w = score.shape
    ch, cw = -(-h // cell), -(-w // cell)
    sp = F.pad(score, (0, cw * cell - w, 0, ch * cell - h))
    cells = sp.reshape(ch, cell, cw, cell).permute(0, 2, 1, 3).reshape(ch * cw, cell * cell)
    vals, idx = _topk_stable(cells, k_per_cell)
    cid = torch.arange(ch * cw, device=score.device)[:, None]
    ys = (cid // cw) * cell + idx // cell
    xs = (cid % cw) * cell + idx % cell
    flat_v, flat_y, flat_x = vals.reshape(-1), ys.reshape(-1), xs.reshape(-1)
    n_cand = flat_v.shape[0]
    if n_cand < n_out:
        padn = n_out - n_cand
        flat_v = F.pad(flat_v, (0, padn))
        flat_y = F.pad(flat_y, (0, padn))
        flat_x = F.pad(flat_x, (0, padn))
    top_v, top_i = _topk_stable(flat_v, n_out)
    xy = torch.stack([flat_x[top_i], flat_y[top_i]], -1).to(torch.float32)
    return xy, top_v, top_v > 0.0


def ic_patch_index(xy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, 31, 31) flat pixel indices of each keypoint's IC-angle patch.
    Centres are truncated to integers and clipped so the disc stays inside
    the image."""
    r = HALF_PATCH
    x0 = torch.clamp(xy[:, 0].to(torch.int32), r, w - r - 1).long()
    y0 = torch.clamp(xy[:, 1].to(torch.int32), r, h - r - 1).long()
    d = torch.arange(-r, r + 1, device=xy.device)
    return (y0[:, None, None] + d[None, :, None]) * w + (x0[:, None, None] + d[None, None, :])


def ic_angle_plain(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint (radians): first moments
    of the radius-15 circular patch (CIRC_MASK), atan2(m01, m10)."""
    h, w = img.shape
    patch = img.reshape(-1)[ic_patch_index(xy, h, w)]
    mask = device_constant("CIRC_MASK", img.device)
    vals = torch.where(mask[None], patch, torch.zeros((), device=img.device))
    df = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=img.device, dtype=torch.float32)
    m01 = torch.sum(vals * df[None, :, None], dim=(1, 2))
    m10 = torch.sum(vals * df[None, None, :], dim=(1, 2))
    return torch.atan2(m01, m10)


def ic_angle(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """IC angle of (N,) keypoints xy (N, 2) on an (H, W) float32 image: the
    plain version on the CPU, the CUDA kernel (counted) on the card."""
    if img.device.type == "cpu":
        return ic_angle_plain(img, xy)
    if img.device.type != "cuda" or xy.device != img.device:
        raise ValueError(f"ic_angle: unsupported devices {img.device}, {xy.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError("ic_angle: needs a contiguous (H, W) float32 image")
    if xy.dtype != torch.float32 or xy.dim() != 2 or xy.shape[1] != 2 or not xy.is_contiguous():
        raise ValueError("ic_angle: needs contiguous (N, 2) float32 keypoints")
    h, w = img.shape
    if h < 2 * HALF_PATCH + 1 or w < 2 * HALF_PATCH + 1:
        raise ValueError("ic_angle: image smaller than the 31x31 patch")
    n = xy.shape[0]
    umax = device_constant("UMAX", img.device)
    out = torch.empty(n, dtype=torch.float32, device=img.device)
    fn = kernel_build.kernel("ic_angle")
    err = fn(img.data_ptr(), xy.data_ptr(), umax.data_ptr(), out.data_ptr(), n, h, w,
             torch.cuda.current_stream(img.device).cuda_stream)
    kernel_build.check_launch("ic_angle", err)
    ic_angle.launches += 1
    return out


ic_angle.launches = 0


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 words, bit j of word i = bit 32i+j."""
    lanes = bits.reshape(-1, 8, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device
    )
    words = torch.sum(lanes * weights, dim=-1)  # in [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def brief_sample_index(
    xy: torch.Tensor, cos_a: torch.Tensor, sin_a: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """(N, 256, 2) flat pixel indices of the steered pattern: each point
    (py, px) rotated by the keypoint angle, added to the keypoint, rounded
    half to even and clipped to the image."""
    pat = device_constant("PATTERN", xy.device).to(torch.float32)  # (256, 2, 2)
    py, px = pat[..., 0], pat[..., 1]
    rx = px[None] * cos_a[:, None, None] - py[None] * sin_a[:, None, None]
    ry = px[None] * sin_a[:, None, None] + py[None] * cos_a[:, None, None]
    sx = torch.clamp(torch.round(xy[:, 0, None, None] + rx), 0, w - 1).to(torch.int64)
    sy = torch.clamp(torch.round(xy[:, 1, None, None] + ry), 0, h - 1).to(torch.int64)
    return sy * w + sx


def brief_descriptors_plain(
    blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor
) -> torch.Tensor:
    """Steered BRIEF: (N, 8) int32 words, bit j of word i set when the
    first sample of pair 32i+j is darker than the second (integer-rounded
    blurred intensities)."""
    h, w = blurred.shape
    vals = blurred.reshape(-1)[brief_sample_index(xy, torch.cos(angle), torch.sin(angle), h, w)]
    return _pack_words(vals[..., 0] < vals[..., 1])


def brief_descriptors(
    blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor
) -> torch.Tensor:
    """Steered BRIEF of (N,) keypoints: the plain version on the CPU, the
    CUDA kernel (counted) on the card.  Both take cos/sin of the angle from
    torch, so the two agree bit for bit on the same device."""
    if blurred.device.type == "cpu":
        return brief_descriptors_plain(blurred, xy, angle)
    dev = blurred.device
    if dev.type != "cuda" or xy.device != dev or angle.device != dev:
        raise ValueError(
            f"brief_descriptors: unsupported devices {dev}, {xy.device}, {angle.device}"
        )
    if blurred.dtype != torch.float32 or blurred.dim() != 2 or not blurred.is_contiguous():
        raise ValueError("brief_descriptors: needs a contiguous (H, W) float32 image")
    if xy.dtype != torch.float32 or xy.dim() != 2 or xy.shape[1] != 2 or not xy.is_contiguous():
        raise ValueError("brief_descriptors: needs contiguous (N, 2) float32 keypoints")
    n = xy.shape[0]
    if angle.dtype != torch.float32 or angle.shape != (n,):
        raise ValueError("brief_descriptors: needs (N,) float32 angles")
    h, w = blurred.shape
    ca = torch.cos(angle).contiguous()
    sa = torch.sin(angle).contiguous()
    pattern = device_constant("PATTERN", dev)
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    fn = kernel_build.kernel("brief")
    err = fn(blurred.data_ptr(), xy.data_ptr(), ca.data_ptr(), sa.data_ptr(),
             pattern.data_ptr(), out.data_ptr(), n, h, w,
             torch.cuda.current_stream(dev).cuda_stream)
    kernel_build.check_launch("brief", err)
    brief_descriptors.launches += 1
    return out


brief_descriptors.launches = 0


def unpack_descriptor_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N, 256) float32 in {0, 1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 256).to(torch.float32)
