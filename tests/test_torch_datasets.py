"""Data sources and the runner in the port, on the CPU at small size.

- ``io/png.read_png`` on PNGs this test encodes with each of the five row
  filters (8-bit gray, RGB and RGBA, and 16-bit gray), and on files cv2
  wrote (8-bit gray, RGB, 16-bit): equal to the pixels and to cv2's
  reading; unsupported formats raise.  ``write_png`` read back by cv2.
- ``datasets/tum.TumSequence`` against the reference's on a TUM-format
  sequence written under tmp_path by cv2 (an RGB and a gray colour frame,
  16-bit depth): timestamps, RGB and depth equal.
- ``datasets/phototex.PhotoSequence`` frames equal to the reference's.
- ``run_slam.main`` with ``--synthetic 8`` and with the TUM sequence and a
  settings file, at 192x144, ``--device cpu``, writing under tmp_path:
  the report lines, N/N tracked, the files written (8 fields on each
  trajectory line), the ATE line of the synthetic run under 0.05 m.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from manhattanslam_tpu.datasets import phototex as jphototex
from manhattanslam_tpu.datasets import tum as jtum
from manhattanslam_tpu_torch import run_slam
from manhattanslam_tpu_torch.config import CameraConfig
from manhattanslam_tpu_torch.datasets import phototex, tum
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu_torch.io.png import read_png, write_png

W, H = 192, 144


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _encode(img: np.ndarray, kinds) -> bytes:
    """A PNG of img with row y filtered by kinds[y % len(kinds)] (the
    filters of the PNG specification, section 9)."""
    depth = 16 if img.dtype == np.uint16 else 8
    ch = 1 if img.ndim == 2 else img.shape[-1]
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    bpp = ch * depth // 8
    rows = (img.astype(">u2").view(np.uint8) if depth == 16 else img).reshape(img.shape[0], -1)
    out, prior = bytearray(), np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = kinds[y % len(kinds)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prior
        elif kind == 3:
            f = row - (left + prior) // 2
        else:
            f = row - np.array([_paeth(a, b, c) for a, b, c in zip(left, prior, upleft)])
        out += bytes([kind]) + (f % 256).astype(np.uint8).tobytes()
        prior = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


def _images():
    rng = np.random.default_rng(4)
    return {
        "gray8": rng.integers(0, 256, (9, 13), dtype=np.uint8),
        "rgb": rng.integers(0, 256, (9, 13, 3), dtype=np.uint8),
        "rgba": rng.integers(0, 256, (9, 13, 4), dtype=np.uint8),
        "gray16": rng.integers(0, 65536, (9, 13), dtype=np.uint16),
    }


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, (0, 1, 2, 3, 4)])
def test_read_png_filters(tmp_path, kind):
    for name, img in _images().items():
        p = tmp_path / f"{name}.png"
        p.write_bytes(_encode(img, kind if isinstance(kind, tuple) else (kind,)))
        out = read_png(str(p))
        assert out.dtype == img.dtype and out.shape == img.shape, name
        np.testing.assert_array_equal(out, img, err_msg=name)
        cv = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)  # cv2 agrees with the encoding
        np.testing.assert_array_equal(cv[..., ::-1] if img.ndim == 3 and img.shape[-1] == 3 else
                                      (cv[..., [2, 1, 0, 3]] if img.ndim == 3 else cv), img)


def test_read_png_of_cv2_files_and_write_png(tmp_path):
    seq = SyntheticSequence(n_frames=2, cam=_cam(), view="corner")
    _, gray, depth = seq.frame(1)
    g8 = np.round(gray).astype(np.uint8)
    imgs = {"gray8": g8, "rgb": np.stack([g8, g8[::-1], 255 - g8], -1),
            "d16": np.round(depth * 5000).astype(np.uint16)}
    for name, img in imgs.items():
        p = str(tmp_path / f"{name}_cv2.png")
        cv2.imwrite(p, img[..., ::-1] if img.ndim == 3 else img)
        cv = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(read_png(p), cv[..., ::-1] if cv.ndim == 3 else cv)
        q = str(tmp_path / f"{name}_ours.png")
        write_png(q, img)
        back = cv2.imread(q, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(back[..., ::-1] if back.ndim == 3 else back, img)
        np.testing.assert_array_equal(read_png(q), img)
    bad = str(tmp_path / "interlaced.png")
    raw = bytearray(_encode(imgs["gray8"][:4, :4], (0,)))
    raw[28] = 1  # IHDR interlace byte
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="unsupported"):
        read_png(bad)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))


def _cam() -> CameraConfig:
    return CameraConfig(fx=160.0, fy=160.0, cx=95.5, cy=71.5, k1=0, k2=0, p1=0, p2=0, k3=0,
                        width=W, height=H, bf=12.0)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """A TUM-format sequence of 6 corner frames written by cv2 (frame 2's
    colour image in gray), its associations and a settings file."""
    root = tmp_path_factory.mktemp("tum")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    seq = SyntheticSequence(n_frames=6, cam=_cam(), view="corner")
    lines = ["# timestamp rgb timestamp depth"]
    for i in range(len(seq)):
        t, gray, depth = seq.frame(i)
        g8 = np.round(gray).astype(np.uint8)
        rgb = g8 if i == 2 else np.stack([g8, g8, g8], -1)
        cv2.imwrite(str(root / "rgb" / f"{i}.png"), rgb)
        cv2.imwrite(str(root / "depth" / f"{i}.png"), np.round(depth * 5000).astype(np.uint16))
        lines.append(f"{t:.6f} rgb/{i}.png {t + 0.001:.6f} depth/{i}.png")
    (root / "assoc.txt").write_text("\n".join(lines) + "\n")
    settings = root / "small.yaml"
    settings.write_text("%YAML:1.0\n" + "".join(
        f"{k}: {v}\n" for k, v in {
            "Camera.fx": 160.0, "Camera.fy": 160.0, "Camera.cx": 95.5, "Camera.cy": 71.5,
            "Camera.width": W, "Camera.height": H, "Camera.bf": 12.0, "Camera.fps": 30.0,
            "Camera.RGB": 1, "DepthMapFactor": 5000.0, "ORBextractor.nFeatures": 250,
        }.items()))
    return root, seq


def test_tum_sequence_matches_reference(tum_dir):
    root, _ = tum_dir
    ref = jtum.TumSequence(str(root), str(root / "assoc.txt"))
    port = tum.TumSequence(str(root), str(root / "assoc.txt"))
    assert len(port) == len(ref) == 6
    assert tum.load_associations(str(root / "assoc.txt")) == ref.rows
    for a, b in zip(port, ref):
        assert a.timestamp == b.timestamp
        assert a.rgb.dtype == b.rgb.dtype == np.uint8 and a.rgb.shape == (H, W, 3)
        np.testing.assert_array_equal(a.rgb, b.rgb)
        assert a.depth.dtype == b.depth.dtype == np.float32
        np.testing.assert_array_equal(a.depth, b.depth)


def test_photo_sequence_matches_reference():
    port = phototex.PhotoSequence(n_frames=3, cam=_cam(), view="corner")
    from manhattanslam_tpu.config import CameraConfig as JaxCameraConfig

    ref = jphototex.PhotoSequence(n_frames=3, cam=JaxCameraConfig(**vars(_cam())),
                                  view="corner")
    np.testing.assert_array_equal(phototex.load_photo(), jphototex.load_photo())
    for i in (0, 2):
        for a, b in zip(port.frame(i), ref.frame(i)):
            np.testing.assert_array_equal(a, b)


def _check_run(out: str, prefix, n: int, surfels: bool) -> None:
    lines = out.splitlines()
    assert lines[0].startswith(f"Tracking {n} frames ({W}x{H}) on cpu")
    assert "-------" in lines
    assert any(ln.startswith("median tracking time: ") for ln in lines)
    assert any(ln.startswith("mean tracking time: ") for ln in lines)
    assert f"tracked: {n}/{n} frames" in lines
    traj = (prefix.parent / (prefix.name + "CameraTrajectory.txt")).read_text().splitlines()
    assert len(traj) == n and all(len(r.split()) == 8 for r in traj)
    kf = (prefix.parent / (prefix.name + "KeyFrameTrajectory.txt")).read_text().splitlines()
    assert len(kf) >= 1 and all(len(r.split()) == 8 for r in kf)
    assert (prefix.parent / (prefix.name + "Surfels.ply")).exists() == surfels


def test_runner_synthetic(tmp_path, capsys):
    prefix = tmp_path / "syn_"
    assert run_slam.main(["--synthetic", "8", "--width", str(W), "--height", str(H),
                          "--device", "cpu", "--out-prefix", str(prefix)]) == 0
    out = capsys.readouterr().out
    _check_run(out, prefix, 8, surfels=True)
    ate = [ln for ln in out.splitlines() if ln.startswith("ATE RMSE vs synthetic ground truth")]
    assert len(ate) == 1 and float(ate[0].split()[-2]) < 0.05


def test_runner_tum(tum_dir, tmp_path, capsys):
    root, _ = tum_dir
    prefix = tmp_path / "tum_"
    assert run_slam.main(["--settings", str(root / "small.yaml"), "--sequence", str(root),
                          "--associations", str(root / "assoc.txt"), "--device", "cpu",
                          "--no-surfels", "--out-prefix", str(prefix)]) == 0
    _check_run(capsys.readouterr().out, prefix, 6, surfels=False)
