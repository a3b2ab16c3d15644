"""Plain ORB extraction: a frozen copy of the port's plain versions
(``ops/image.py``'s pyramid and blur, ``ops/fast.py``'s dense FAST-9
score and threshold fallback, ``ops/orb.py``'s grid top-K, IC angle and
steered BRIEF, ``frontend/frame.py``'s stage order), in plain PyTorch
with no kernel, level by level.

``extract`` returns, per keypoint slot, what the program's extractor
returns in its ``feats``: ``xy`` (level-0 pixels), ``level``,
``response`` (the FAST score), ``valid``, ``angle`` and ``desc`` (8 int32
words of the 256 BRIEF bits).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (dy, dx), clockwise from 12 o'clock
CIRCLE_OFFSETS = [
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
]
ARC_LEN = 9
HALO = 3
HALF_PATCH = 15
EDGE_THRESHOLD = 19
BLUR_KSIZE = 7
BLUR_SIGMA = 2.0


def _make_pattern(seed: int = 1234) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 31 / 5.0, size=(256, 2, 2))
    r = np.sqrt((pts**2).sum(-1, keepdims=True))
    scale = np.minimum(1.0, 13.0 / np.maximum(r, 1e-6))
    return np.round(pts * scale).astype(np.int32)


PATTERN = _make_pattern()


def _circ_mask(radius: int = HALF_PATCH) -> np.ndarray:
    umax = [int(np.sqrt(radius * radius - v * v) + 0.5) for v in range(radius + 1)]
    xs = np.arange(-radius, radius + 1)
    return np.stack([np.abs(xs) <= umax[abs(v)] for v in range(-radius, radius + 1)])


CIRC_MASK = _circ_mask()


# ------------------------------------------------------------------ pyramid
def pyramid_shapes(h: int, w: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    return [(int(round(h / scale**i)), int(round(w / scale**i))) for i in range(n_levels)]


def resize_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    scale = out_size / in_size
    out_coords = (np.arange(out_size) + 0.5) / scale - 0.5
    kscale = min(scale, 1.0)
    x = (np.arange(in_size)[None, :] - out_coords[:, None]) * kscale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


def _resize(x: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """ry @ img @ rx^T of every image of x (..., h, w), as the port's two
    products (the images side by side, then on top of each other)."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    xb = x.reshape(-1, h, w)
    b, oh = xb.shape[0], ry.shape[0]
    rows = ry @ xb.transpose(0, 1).reshape(h, b * w)
    out = rows.reshape(oh, b, w).transpose(0, 1).reshape(b * oh, w) @ rx.T
    return out.reshape(*lead, oh, rx.shape[0])


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    shapes = pyramid_shapes(img.shape[-2], img.shape[-1], n_levels, scale)
    levels = [img]
    for (ih, iw), (oh, ow) in zip(shapes[:-1], shapes[1:]):
        ry = torch.from_numpy(resize_matrix_np(ih, oh)).to(img.device)
        rx = torch.from_numpy(resize_matrix_np(iw, ow)).to(img.device)
        levels.append(_resize(levels[-1], ry, rx))
    return levels


def conv1d_shifts(img: torch.Tensor, k: np.ndarray, axis: int, pad_mode: str) -> torch.Tensor:
    """A 1-D stencil along `axis` (0 rows, 1 columns) as shifted adds, in
    tap order."""
    r = len(k) // 2
    h, w = img.shape[-2:]
    pad = (0, 0, r, r) if axis == 0 else (r, r, 0, 0)
    x = F.pad(img.reshape(-1, 1, h, w), pad, mode=pad_mode)
    x = x.reshape(img.shape[:-2] + x.shape[-2:])
    n = img.shape[-2 + axis]
    out = None
    for i, wt in enumerate(k):
        term = float(wt) * (x[..., i: i + n, :] if axis == 0 else x[..., i: i + n])
        out = term if out is None else out + term
    return out


def gaussian_blur(img: torch.Tensor, ksize: int = BLUR_KSIZE, sigma: float = BLUR_SIGMA):
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2 * sigma**2))
    k = (k / k.sum()).astype(np.float32)
    return conv1d_shifts(conv1d_shifts(img, k, 0, "reflect"), k, 1, "reflect")


def shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    h, w = img.shape[-2:]
    out = torch.zeros_like(img)
    ys0, ys1 = max(dy, 0), min(h + dy, h)
    xs0, xs1 = max(dx, 0), min(w + dx, w)
    if ys0 < ys1 and xs0 < xs1:
        out[..., ys0 - dy: ys1 - dy, xs0 - dx: xs1 - dx] = img[..., ys0:ys1, xs0:xs1]
    return out


# --------------------------------------------------------------------- FAST
def fast_score(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9 score (..., H, W), the 3-pixel border 0."""
    h, w = img.shape[-2:]
    diffs = torch.stack([shift2d(img, dy, dx) for dy, dx in CIRCLE_OFFSETS]) - img[None]

    def arc_min(d):
        return torch.stack([torch.roll(d, -k, dims=0) for k in range(ARC_LEN)]).amin(0)

    score = torch.clamp(torch.maximum(arc_min(diffs).amax(0), arc_min(-diffs).amax(0)), min=0.0)
    out = torch.zeros_like(score)
    out[..., HALO: h - HALO, HALO: w - HALO] = score[..., HALO: h - HALO, HALO: w - HALO]
    return out


def threshold_nms(score: torch.Tensor, cell: int, ini_th: int, min_th: int) -> torch.Tensor:
    """Per-cell iniThFAST / minThFAST fallback and 3x3 non-maximum
    suppression (ORBextractor.cc:763-769)."""
    lead, (h, w) = score.shape[:-2], score.shape[-2:]
    ch, cw = -(-h // cell), -(-w // cell)
    cells = F.pad(score, (0, cw * cell - w, 0, ch * cell - h)).reshape(*lead, ch, cell, cw, cell)
    high = (cells > ini_th).any(-1).any(-3)
    high = high.repeat_interleave(cell, -2).repeat_interleave(cell, -1)[..., :h, :w]
    passed = score > torch.where(high, float(ini_th), float(min_th))
    peak = F.max_pool2d(score.reshape(-1, 1, h, w), 3, stride=1, padding=1).reshape(score.shape)
    return torch.where(passed & (score >= peak), score, torch.zeros_like(score))


def _topk_stable(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def grid_topk(score: torch.Tensor, n_out: int, cell: int, k_per_cell: int):
    """Top k_per_cell per cell, then the global top n_out (ties: lowest
    index first): (xy, response, valid)."""
    lead, (h, w) = score.shape[:-2], score.shape[-2:]
    ch, cw = -(-h // cell), -(-w // cell)
    sp = F.pad(score, (0, cw * cell - w, 0, ch * cell - h))
    cells = sp.reshape(*lead, ch, cell, cw, cell).transpose(-3, -2).reshape(*lead, ch * cw, -1)
    vals, idx = _topk_stable(cells, k_per_cell)
    cid = torch.arange(ch * cw, device=score.device)[:, None]
    ys = ((cid // cw) * cell + idx // cell).reshape(*lead, -1)
    xs = ((cid % cw) * cell + idx % cell).reshape(*lead, -1)
    flat_v = vals.reshape(*lead, -1)
    pad = max(n_out - flat_v.shape[-1], 0)
    flat_v, ys, xs = (F.pad(t, (0, pad)) for t in (flat_v, ys, xs))
    top_v, top_i = _topk_stable(flat_v, n_out)
    xy = torch.stack([xs.gather(-1, top_i), ys.gather(-1, top_i)], -1).to(torch.float32)
    return xy, top_v, top_v > 0.0


# ------------------------------------------------------------ angle, BRIEF
def gather_pixels(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    lead = img.shape[:-2]
    return img.reshape(*lead, -1).gather(-1, idx.reshape(*lead, -1)).reshape(idx.shape)


def ic_angle(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle of the radius-15 disc, moments in float64,
    the angle rounded to float32."""
    h, w = img.shape[-2:]
    r = HALF_PATCH
    x0 = torch.clamp(xy[..., 0].to(torch.int32), r, w - r - 1).long()
    y0 = torch.clamp(xy[..., 1].to(torch.int32), r, h - r - 1).long()
    d = torch.arange(-r, r + 1, device=xy.device)
    idx = (y0[..., None, None] + d[:, None]) * w + (x0[..., None, None] + d[None, :])
    patch = gather_pixels(img, idx).to(torch.float64)
    mask = torch.from_numpy(CIRC_MASK).to(img.device)
    vals = torch.where(mask, patch, torch.zeros((), dtype=torch.float64, device=img.device))
    df = d.to(torch.float64)
    m01 = (vals * df[:, None]).sum((-2, -1))
    m10 = (vals * df[None, :]).sum((-2, -1))
    return torch.atan2(m01, m10).to(torch.float32)


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    lanes = bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    words = (lanes * weights).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def brief(level: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF on the integer-rounded blur of a raw level."""
    h, w = level.shape[-2:]
    blurred = torch.round(gaussian_blur(level))
    pat = torch.from_numpy(PATTERN).to(level.device).to(torch.float32)
    py, px = pat[..., 0], pat[..., 1]
    c, s = torch.cos(angle)[..., None, None], torch.sin(angle)[..., None, None]
    sx = torch.clamp(torch.round(xy[..., 0, None, None] + (px * c - py * s)), 0, w - 1).long()
    sy = torch.clamp(torch.round(xy[..., 1, None, None] + (px * s + py * c)), 0, h - 1).long()
    vals = gather_pixels(blurred, sy * w + sx)
    return _pack_words(vals[..., 0] < vals[..., 1])


# ---------------------------------------------------------------- extractor
def unpack_descriptor_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 256) float32 in {0, 1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (256,)).to(torch.float32)


def features_per_level(n_features: int, scale: float, n_levels: int) -> list[int]:
    inv = 1.0 / scale
    n_desired = n_features * (1 - inv) / (1 - inv**n_levels)
    per, total = [], 0
    for _ in range(n_levels - 1):
        k = int(round(n_desired))
        per.append(k)
        total += k
        n_desired *= inv
    per.append(max(n_features - total, 0))
    return per


def extract(gray: torch.Tensor, orb: dict, cap: int, active: list | None = None) -> dict:
    """gray (..., H, W) float32 [0, 255] -> per-slot features (..., cap):
    xy, level, response, valid, angle, desc, in the program's slot order
    (levels in order, each level's grid top-K, padded to `cap`).  `orb`:
    n_features, scale_factor, n_levels, ini_th_fast, min_th_fast.  A list
    passed as `active` receives (level image, keypoints in level pixels,
    angles) of each level the kernels read."""
    n_levels, scale = orb["n_levels"], orb["scale_factor"]
    budgets = features_per_level(orb["n_features"], scale, n_levels)
    lead = gray.shape[:-2]
    parts = []
    for li, lv in enumerate(build_pyramid(gray, n_levels, scale)):
        n = budgets[li]
        h, w = lv.shape[-2:]
        if min(h, w) < 2 * EDGE_THRESHOLD + 3:
            z = torch.zeros(lead + (n,), device=gray.device)
            part = {"xy": torch.zeros(lead + (n, 2), device=gray.device), "response": z,
                    "valid": z > 0, "angle": z,
                    "desc": torch.zeros(lead + (n, 8), dtype=torch.int32, device=gray.device)}
        else:
            corners = threshold_nms(fast_score(lv), 30, orb["ini_th_fast"], orb["min_th_fast"])
            b = EDGE_THRESHOLD
            inner = torch.zeros_like(corners)
            inner[..., b: h - b, b: w - b] = corners[..., b: h - b, b: w - b]
            k_cell = max(2, min(8, (4 * n) // max((h // 32) * (w // 32), 1) + 1))
            xy, resp, valid = grid_topk(inner, n, 32, k_cell)
            angle = ic_angle(lv, xy)
            part = {"xy": xy, "response": resp, "valid": valid, "angle": angle,
                    "desc": brief(lv, xy, angle)}
            if active is not None:
                active.append((lv, xy, angle))
        part["xy"] = part["xy"] * float(scale**li)
        part["level"] = torch.full(lead + (n,), li, dtype=torch.int32, device=gray.device)
        parts.append(part)
    ax = len(lead)
    feats = {k: torch.cat([p[k] for p in parts], ax) for k in parts[0]}
    n = feats["xy"].shape[ax]
    if n < cap:
        feats = {k: torch.cat([v, v.new_zeros(lead + (cap - n,) + v.shape[ax + 1:])], ax)
                 for k, v in feats.items()}
    return {k: v.narrow(ax, 0, cap) for k, v in feats.items()}
