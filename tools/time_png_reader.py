#!/usr/bin/env python3
"""Time manhattanslam_tpu_torch.io.png.read_png on TUM-format frames written
by cv2 (which picks each row's filter itself), by write_png (filter 0)
and with every row Paeth-filtered (the reader's slowest case).

Usage: python3 tools/time_png_reader.py   (needs cv2; runs on the CPU)

A 640x480 frame of the synthetic box room (the TUM1 camera, the "walk"
view): its RGB (the gray replicated) and its 16-bit depth at
DepthMapFactor 5000.  Prints, for each file, the row filters it holds and
the median of 5 reads in ms, beside cv2.imread's.
"""

from __future__ import annotations

import os
import statistics
import sys
import tempfile
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from manhattanslam_tpu_torch.config import load_config  # noqa: E402
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence  # noqa: E402
from manhattanslam_tpu_torch.io.png import read_png, write_png  # noqa: E402


def _filters(path: str) -> dict:
    """How many rows use each filter type (0 none .. 4 Paeth)."""
    data = open(path, "rb").read()
    off, idat, hdr = 8, [], None
    while off < len(data):
        n = int.from_bytes(data[off: off + 4], "big")
        kind = data[off + 4: off + 8]
        if kind == b"IHDR":
            hdr = data[off + 8: off + 8 + n]
        elif kind == b"IDAT":
            idat.append(data[off + 8: off + 8 + n])
        off += 12 + n
    w, h = int.from_bytes(hdr[:4], "big"), int.from_bytes(hdr[4:8], "big")
    bpp = {(8, 0): 1, (8, 2): 3, (8, 6): 4, (16, 0): 2}[(hdr[8], hdr[9])]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    kinds, counts = np.unique(raw[:, 0], return_counts=True)
    return {int(k): int(c) for k, c in zip(kinds, counts)}


def _write_paeth(path: str, img: np.ndarray) -> None:
    """img with every row Paeth-filtered (type 4): the reader's slowest
    case, each byte undone in Python."""
    depth = 16 if img.dtype == np.uint16 else 8
    rows = (img.astype(">u2").view(np.uint8) if depth == 16 else img).reshape(img.shape[0], -1)
    bpp = (2 if depth == 16 else 1) * (1 if img.ndim == 2 else img.shape[-1])
    x = rows.astype(np.int32)
    a = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]
    c = np.pad(b, ((0, 0), (bpp, 0)))[:, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    filt = np.concatenate([np.full((len(x), 1), 4), (x - pred) % 256], 1).astype(np.uint8)
    ctype = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[-1]]

    def chunk(kind, body):
        return (len(body).to_bytes(4, "big") + kind + body
                + (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, "big"))

    hdr = (img.shape[1].to_bytes(4, "big") + img.shape[0].to_bytes(4, "big")
           + bytes([depth, ctype, 0, 0, 0]))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
                + chunk(b"IDAT", zlib.compress(filt.tobytes())) + chunk(b"IEND", b""))


def _median_ms(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def main() -> int:
    import cv2

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "TUM1.yaml"))
    _, gray, depth = SyntheticSequence(n_frames=2, cam=cfg.camera, view="walk").frame(1)
    g8 = np.clip(np.round(gray), 0, 255).astype(np.uint8)
    images = {"rgb": np.stack([g8, g8, g8], -1),
              "depth": np.clip(np.round(depth * 5000), 0, 65535).astype(np.uint16)}
    with tempfile.TemporaryDirectory() as tmp:
        for name, img in images.items():
            for writer in ("cv2", "write_png", "paeth"):
                path = os.path.join(tmp, f"{name}_{writer}.png")
                if writer == "cv2":
                    cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img)
                elif writer == "paeth":
                    _write_paeth(path, img)
                else:
                    write_png(path, img)
                ours = _median_ms(lambda: read_png(path))
                theirs = _median_ms(lambda: cv2.imread(path, cv2.IMREAD_UNCHANGED))
                print(f"{name} {img.shape} written by {writer}: row filters {_filters(path)}, "
                      f"read_png {ours:.1f} ms, cv2.imread {theirs:.1f} ms (median of 5)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
