"""PNG reading and writing in numpy and zlib, for the TUM RGB-D formats.

The card's machine has no image library, so the TUM loader reads its
8-bit colour and 16-bit depth PNGs here.  ``read_png`` takes
non-interlaced images of 8-bit gray, RGB and RGBA, and 16-bit gray, with
any of the five row filters; anything else raises.  ``write_png`` writes
the same formats with filter 0 (none).

The None, Sub and Up filters undo in numpy; Average and Paeth depend on
the byte before in the same row, so their rows undo byte by byte in
Python, which is slow for a 640x480 frame an encoder filtered that way
(PERF.md gives the time; loading is outside the runner's timed
tracking, as in the reference).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (gray, RGB, RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    off = len(_SIGNATURE)
    while off + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[off: off + 8])
        yield kind, data[off + 8: off + 8 + n]
        off += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG: truncated (no IEND chunk)")


def _unfilter_sequential(kind: int, row: bytearray, prior: bytes, bpp: int) -> None:
    """Undo the Average (3) or Paeth (4) filter of one row, in place."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            row[i] = (row[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """(height, 1 + stride) filtered scanlines -> (height, stride) bytes."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub: a running sum per byte lane, mod 256
            lanes = np.zeros(-(-stride // bpp) * bpp, np.uint8)
            lanes[:stride] = line
            out[y] = np.cumsum(lanes.reshape(-1, bpp), 0, dtype=np.uint8).reshape(-1)[:stride]
        elif kind == 2:  # Up
            out[y] = line + prior
        elif kind in (3, 4):
            row = bytearray(line.tobytes())
            _unfilter_sequential(kind, row, prior.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W) uint8 or uint16 for gray, (H, W, 3) or (H, W, 4) uint8 for
    RGB and RGBA, channels in the file's order."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _comp, _filt, interlace = header
    ch = _CHANNELS.get(ctype)
    if ch is None or interlace != 0 or depth not in (8, 16) or (depth == 16 and ch != 1):
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}); read_png takes non-interlaced 8-bit gray, RGB, RGBA and 16-bit gray")
    bpp = ch * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: PNG image data has {raw.size} bytes, "
                         f"{height * (stride + 1)} expected")
    img = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp)
    if depth == 16:
        return img.view(">u2").astype(np.uint16).reshape(height, width)
    return img.reshape((height, width) if ch == 1 else (height, width, ch))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) uint8 / uint16 gray or (H, W, 3|4) uint8 RGB / RGBA,
    every row with filter 0, the data deflated at zlib level 1 (fast)."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, body = 16, 0, img.astype(">u2").view(np.uint8)
    elif img.dtype == np.uint8 and (img.ndim == 2 or img.shape[-1] in (3, 4)):
        depth, ctype, body = 8, 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[-1]], img
    else:
        raise ValueError(f"write_png: unsupported image {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(body).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)))
        f.write(_chunk(b"IEND", b""))
