"""The benchmark's PyTorch box room against the port's numpy renderer
(manhattanslam_tpu_torch.datasets.synthetic.render_frame), at a small
size on the CPU, and its pose generators against synthetic.py's."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from manhattanslam_tpu_torch.config import CameraConfig  # noqa: E402
from manhattanslam_tpu_torch.datasets import synthetic  # noqa: E402
from manhattanslam_tpu_torch.frontend import device_tracker as dt  # noqa: E402
from portbench.scene import poses, render  # noqa: E402

W, H = 160, 120
F = W / 640


def _cams():
    kw = dict(fx=525.0 * F, fy=525.0 * F, cx=(W - 1) / 2, cy=(H - 1) / 2)
    return (render.Camera(width=W, height=H, **kw),
            CameraConfig(k1=0, k2=0, p1=0, p2=0, k3=0, width=W, height=H, **kw))


@pytest.mark.parametrize("path", ["near_corner", "walk"])
@pytest.mark.parametrize("seed", [7, 2**31 + 12345])
def test_render_equals_render_frame(path, seed):
    cam, ccfg = _cams()
    P = poses.POSE_GENERATORS[path](render.ROOM_SIZE)
    idx = [0, 11, 57, len(P) - 1]
    gray, depth = render.render_frames(cam, torch.from_numpy(P[idx]), seed)
    rgb, d16 = render.to_sensor(gray, depth)
    room = synthetic.BoxRoom(seed=seed)
    for j, i in enumerate(idx):
        g_ref, d_ref = synthetic.render_frame(ccfg, P[i], room)
        np.testing.assert_array_equal(gray[j].numpy(), g_ref)
        # the ray directions are summed term by term here, by a product
        # there: the depth agrees to float32 rounding, and so the sensor's
        # units but where a depth sits on a rounding edge (one unit)
        np.testing.assert_allclose(depth[j].numpy(), d_ref, rtol=1e-6, atol=0)
        g8, d16_ref = dt.to_native(g_ref, d_ref)
        for c in range(3):
            np.testing.assert_array_equal(rgb[j, ..., c].numpy(), g8)
        gap = np.abs(d16[j].numpy().astype(np.int64) - d16_ref.astype(np.int64))
        assert gap.max() <= 1 and (gap > 0).mean() < 1e-3


def test_near_corner_equals_synthetic():
    ref = synthetic.near_corner_poses(120, synthetic.BoxRoom())
    np.testing.assert_array_equal(poses.near_corner(render.ROOM_SIZE, period=120), ref)


def test_walk_is_one_closed_lap_of_the_synthetic_walk():
    P = poses.walk(render.ROOM_SIZE)
    n = poses.walk_lap_length(render.ROOM_SIZE)
    assert len(P) == n
    # frame 0 is synthetic.walk_poses' frame 0; the lap closes on it
    np.testing.assert_allclose(P[0], synthetic.walk_poses(5, synthetic.BoxRoom())[0], atol=1e-6)
    step = np.linalg.norm(np.diff(np.concatenate([P[:, :3, 3], P[:1, :3, 3]]), axis=0), axis=1)
    assert abs(step.mean() - 0.02) < 1e-3 and step.max() < 0.03
    # gazing outward from the ellipse's centre, the camera upright
    c = np.array([3.0, 0.0, 4.0])
    out = (P[:, :3, 3] - c) * np.array([1, 0, 1])
    assert (np.einsum("ni,ni->n", out, P[:, :3, 2]) > 0).all()
    np.testing.assert_allclose(P[:, 1, 0], 0.0, atol=1e-6)


def test_relative_cw_is_frame_zero_world():
    P = poses.near_corner(render.ROOM_SIZE)
    T = poses.relative_cw(P, [0, 5])
    np.testing.assert_allclose(T[0], np.eye(4), atol=1e-6)
    np.testing.assert_allclose(T[1], np.linalg.inv(P[5].astype(np.float64)) @ P[0], atol=1e-12)
