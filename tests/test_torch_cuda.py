"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: CUDA kernels have no CPU mode, so without a GPU these
tests skip.  This file imports neither JAX nor the reference package, so
it also runs on a machine with a GPU and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from manhattanslam_tpu_torch.config import CameraConfig, CapacityConfig, OrbConfig, SlamConfig
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu_torch.io import trajectory as traj_io
from manhattanslam_tpu_torch.ops import fast, orb
from manhattanslam_tpu_torch.system import System

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _image(h, w, seed, integer=True):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w)) if integer else rng.uniform(0, 255, (h, w))
    return torch.from_numpy(img.astype(np.float32))


def _keypoints(h, w, n, seed):
    rng = np.random.default_rng(seed)
    b = orb.EDGE_THRESHOLD
    xy = np.stack([rng.uniform(b, w - b - 1, n), rng.uniform(b, h - b - 1, n)], -1)
    return torch.from_numpy(np.round(xy).astype(np.float32))


@pytest.mark.parametrize("hw", [(480, 640), (134, 179), (70, 128), (41, 45)])
def test_fast_kernel_equals_plain(cuda, hw):
    img = _image(*hw, seed=hw[0], integer=False).to(cuda)
    before = fast.fast_score_map.launches
    out = fast.fast_score_map(img)
    torch.cuda.synchronize()
    assert fast.fast_score_map.launches == before + 1
    assert torch.equal(out, fast.fast_score_map_plain(img))


@pytest.mark.parametrize("hw,n", [((480, 640), 217), ((134, 179), 60), ((40, 54), 7)])
def test_ic_angle_kernel_within_tolerance(cuda, hw, n):
    img = _image(*hw, seed=n).to(cuda)
    xy = _keypoints(*hw, n, seed=n).to(cuda)
    out = orb.ic_angle(img, xy)
    ref = orb.ic_angle_plain(img, xy)
    d = torch.remainder(out - ref + math.pi, 2 * math.pi) - math.pi
    assert float(d.abs().max()) < 1e-4


@pytest.mark.parametrize("hw,n", [((480, 640), 217), ((134, 179), 60), ((40, 54), 7)])
def test_brief_kernel_bit_exact(cuda, hw, n):
    img = _image(*hw, seed=hw[1]).to(cuda)
    xy = _keypoints(*hw, n, seed=n + 1).to(cuda)
    angle = torch.from_numpy(
        np.random.default_rng(n).uniform(-math.pi, math.pi, n).astype(np.float32)
    ).to(cuda)
    assert torch.equal(orb.brief_descriptors(img, xy, angle), orb.brief_descriptors_plain(img, xy, angle))


def test_wrapper_checks_inputs(cuda):
    with pytest.raises(ValueError):
        fast.fast_score_map(torch.zeros((8, 8), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        orb.ic_angle(torch.zeros((64, 64), device=cuda), torch.zeros((3, 3), device=cuda))


def test_system_on_cuda_matches_cpu(cuda):
    """The 12 box-room frames of the CPU parity test (tests/test_torch_tracker.py)
    through the System on the card and on the CPU: all frames tracked, the
    card's trajectory within the repo's e2e ATE bound, and the two
    trajectories within 1 cm RMS of each other.  Not closer: the predicted
    scale level ceil(log(maxDist/dist) / log(1.2)) sits on an integer for a
    point seen from its creation distance, so one ulp of log moves a point
    to another level and window; on the CPU alone, taking that log in
    float64 instead of float32 moves frame 1 by 7.3 mm."""
    cfg = SlamConfig(
        camera=CameraConfig(fx=160.0, fy=160.0, cx=95.5, cy=71.5, k1=0, k2=0, p1=0, p2=0, k3=0,
                            width=192, height=144, bf=12.0),
        orb=OrbConfig(n_features=250),
        caps=CapacityConfig(max_keypoints=256, max_lines=32, max_map_points=8192,
                            max_map_lines=512, max_keyframes=64),
    )
    seq = SyntheticSequence(n_frames=12, cam=cfg.camera)
    gpu, cpu = System(cfg), System(cfg, device="cpu")
    for i in range(12):
        ts, gray, depth = seq.frame(i)
        a, b = gpu.track(gray, depth, ts), cpu.track(gray, depth, ts)
        assert a is not None and b is not None, f"frame {i}"
    pos_gpu = np.array([r[1] for r in gpu.tracker.trajectory_rows()])
    pos_cpu = np.array([r[1] for r in cpu.tracker.trajectory_rows()])
    gt = seq.gt_rows()
    ts_all = np.array([r[0] for r in gt])
    assert traj_io.ate_rmse((ts_all, pos_gpu), (ts_all, np.array([r[1] for r in gt]))) < 0.05
    assert np.sqrt(((pos_gpu - pos_cpu) ** 2).sum(1).mean()) < 1e-2
