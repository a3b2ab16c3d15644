"""Image primitives: pyramid, separable Gaussian blur, Sobel gradients,
2x2 box downsample, 3x3 max filter (counterpart of
manhattanslam_tpu/ops/image.py).

Every function takes images (..., H, W): one image, or a stack of B
streams' images (the batched replay), computed image by image with the
same arithmetic.  The bilinear resize is two constant banded-matrix
products, ``R_y @ img @ R_x^T``, with the same operators as the
reference; the blur keeps the reference's shifted-add order term by term,
because the integer-rounded blur that BRIEF samples follows that rounding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    """Per-level (H, W) like the reference (round(H/scale^i))."""
    return [
        (int(round(h / scale**i)), int(round(w / scale**i))) for i in range(n_levels)
    ]


def resize_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) linear-interpolation operator with triangle
    antialiasing (jax.image.resize "linear" semantics, half-pixel
    centres; the kernel widens by 1/scale when downsampling)."""
    scale = out_size / in_size
    out_coords = (np.arange(out_size) + 0.5) / scale - 0.5
    kscale = min(scale, 1.0)
    k = np.arange(in_size)[None, :]
    x = (k - out_coords[:, None]) * kscale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


def avgpool2_matrix_np(in_size: int) -> np.ndarray:
    """(in_size//2, in_size) operator of the 2x2 box downsample along one
    axis (each output the mean of two neighbours)."""
    out = in_size // 2
    m = np.zeros((out, in_size), np.float32)
    idx = np.arange(out)
    m[idx, 2 * idx] = 0.5
    m[idx, 2 * idx + 1] = 0.5
    return m


def stride_select_matrix_np(in_size: int, stride: int) -> np.ndarray:
    """(ceil(in/stride), in) operator picking every stride-th element
    (x[::stride] as a product)."""
    out = -(-in_size // stride)
    m = np.zeros((out, in_size), np.float32)
    idx = np.arange(out)
    m[idx, stride * idx] = 1.0
    return m


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Linear resize with triangle antialiasing (jax.image.resize
    "linear") as two constant products, R_y @ img @ R_x^T."""
    h, w = img.shape[-2:]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return img
    ry = torch.from_numpy(resize_matrix_np(h, oh)).to(img.device)
    rx = torch.from_numpy(resize_matrix_np(w, ow)).to(img.device)
    return _resize(img, ry, rx)


def pyramid_operators(
    h: int, w: int, n_levels: int, scale: float, device
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(R_y, R_x) for each level transition 0->1, 1->2, ... on `device`."""
    shapes = pyramid_shapes(h, w, n_levels, scale)
    ops = []
    for (ih, iw), (oh, ow) in zip(shapes[:-1], shapes[1:]):
        ops.append(
            (
                torch.from_numpy(resize_matrix_np(ih, oh)).to(device),
                torch.from_numpy(resize_matrix_np(iw, ow)).to(device),
            )
        )
    return ops


def _resize(x: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """ry @ img @ rx^T for every image of x (..., h, w), one image or a
    stack, as two plain matrix products: the images side by side in the
    row product ((h', h) @ (h, B*w)) and on top of each other in the
    column product ((B*h', w) @ (w, w')), so each output element is a dot
    product over one image's pixels, as it is for a single image."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    xb = x.reshape(-1, h, w)
    b, oh = xb.shape[0], ry.shape[0]
    rows = ry @ xb.transpose(0, 1).reshape(h, b * w)
    out = rows.reshape(oh, b, w).transpose(0, 1).reshape(b * oh, w) @ rx.T
    return out.reshape(*lead, oh, rx.shape[0])


def build_pyramid(
    img: torch.Tensor, operators: list[tuple[torch.Tensor, torch.Tensor]]
) -> list[torch.Tensor]:
    """Level 0 = img (..., H, W); each further level resizes the previous one."""
    levels = [img]
    for ry, rx in operators:
        levels.append(_resize(levels[-1], ry, rx))
    return levels


def gauss_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _conv1d_shifts(img: torch.Tensor, k: np.ndarray, axis: int, pad_mode: str) -> torch.Tensor:
    """1-D stencil along `axis` (0 = rows, 1 = columns of each (H, W)
    image) as shifted adds, summed in tap order."""
    r = len(k) // 2
    h, w = img.shape[-2:]
    pad = (0, 0, r, r) if axis == 0 else (r, r, 0, 0)
    x = F.pad(img.reshape(-1, 1, h, w), pad, mode=pad_mode)
    x = x.reshape(img.shape[:-2] + x.shape[-2:])
    n = img.shape[-2 + axis]
    out = None
    for i, wt in enumerate(k):
        term = float(wt) * (x[..., i : i + n, :] if axis == 0 else x[..., i : i + n])
        out = term if out is None else out + term
    return out


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian with reflect padding (BORDER_REFLECT_101-like)."""
    k = gauss_kernel1d(ksize, sigma)
    x = _conv1d_shifts(img, k, axis=0, pad_mode="reflect")
    return _conv1d_shifts(x, k, axis=1, pad_mode="reflect")


def sobel(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel gradients (gx, gy), edge-padded, as the reference's two
    separable passes: [1, 2, 1] across, then [-1, 0, 1] along."""
    smooth = np.array([1.0, 2.0, 1.0], np.float32)
    diff = np.array([-1.0, 0.0, 1.0], np.float32)
    sy = _conv1d_shifts(img, smooth, axis=0, pad_mode="replicate")
    gx = _conv1d_shifts(sy, diff, axis=1, pad_mode="replicate")
    sx = _conv1d_shifts(img, smooth, axis=1, pad_mode="replicate")
    gy = _conv1d_shifts(sx, diff, axis=0, pad_mode="replicate")
    return gx, gy


def avgpool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample (..., H, W) -> (..., H//2, W//2), an odd last row
    or column dropped.  The reference multiplies by two 0.5-banded
    operators (``avgpool2_matrix_np``, rows then columns); this takes the
    same two halves per output in the same order, and on integer-valued
    images, as the tracker's u8 gray is, every sum is exact in any order."""
    h, w = img.shape[-2:]
    x = img[..., : h // 2 * 2, : w // 2 * 2]
    rows = 0.5 * x[..., 0::2, :] + 0.5 * x[..., 1::2, :]
    return 0.5 * rows[..., 0::2] + 0.5 * rows[..., 1::2]


def shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = img[..., y+dy, x+dx], zero-padded."""
    h, w = img.shape[-2:]
    out = torch.zeros_like(img)
    ys0, ys1 = max(dy, 0), min(h + dy, h)
    xs0, xs1 = max(dx, 0), min(w + dx, w)
    if ys0 >= ys1 or xs0 >= xs1:
        return out
    out[..., ys0 - dy : ys1 - dy, xs0 - dx : xs1 - dx] = img[..., ys0:ys1, xs0:xs1]
    return out


def maxpool3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max filter with -inf outside the image (for NMS)."""
    h, w = x.shape[-2:]
    return F.max_pool2d(x.reshape(-1, 1, h, w), 3, stride=1, padding=1).reshape(x.shape)
