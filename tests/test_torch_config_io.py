"""Parity of the port's host foundations with the JAX reference: the
OpenCV-YAML config parser, the TUM trajectory writer (byte-identical),
Horn ATE, the synthetic renderer, and the SE(3) helpers (float32
tolerance: the same formulas, evaluated by another library)."""

import dataclasses
import glob

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.config import load_config as jax_load_config
from manhattanslam_tpu.datasets import synthetic as jsyn
from manhattanslam_tpu.datasets.tum import to_gray as jax_to_gray
from manhattanslam_tpu.geometry import se3 as jse3
from manhattanslam_tpu.io import trajectory as jtraj
from manhattanslam_tpu_torch.config import load_config as port_load_config
from manhattanslam_tpu_torch.datasets import synthetic as psyn
from manhattanslam_tpu_torch.datasets.tum import to_gray as port_to_gray
from manhattanslam_tpu_torch.geometry import se3 as pse3
from manhattanslam_tpu_torch.io import trajectory as ptraj

CONFIGS = sorted(glob.glob("configs/*.yaml"))


def test_all_five_configs_present():
    assert len(CONFIGS) == 5


@pytest.mark.parametrize("path", CONFIGS)
def test_config_parser_matches_reference(path):
    ref = jax_load_config(path)
    out = port_load_config(path)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    assert out.orb.features_per_level() == ref.orb.features_per_level()
    assert out.th_depth_m == ref.th_depth_m
    np.testing.assert_array_equal(out.camera.K, ref.camera.K)


def _rows(rng, n):
    ts = np.cumsum(rng.uniform(0.02, 0.04, n)) + 1305031102.175304
    pos = rng.normal(0, 2, (n, 3)).astype(np.float32)
    q = rng.normal(0, 1, (n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return [(float(t), p, qq) for t, p, qq in zip(ts, pos, q)]


def test_tum_writer_byte_identical(tmp_path):
    rows = _rows(np.random.default_rng(1), 25)
    for writer in ("save_trajectory_tum", "save_keyframe_trajectory_tum"):
        a, b = tmp_path / f"ref_{writer}.txt", tmp_path / f"port_{writer}.txt"
        getattr(jtraj, writer)(str(a), rows)
        getattr(ptraj, writer)(str(b), rows)
        assert a.read_bytes() == b.read_bytes()
        assert len(a.read_bytes()) > 0


def test_horn_ate_matches_reference():
    rng = np.random.default_rng(2)
    ts = np.arange(40) / 30.0
    gt = rng.normal(0, 1, (40, 3))
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = gt @ R.T + [0.5, -1.0, 2.0] + rng.normal(0, 0.01, gt.shape)
    assert ptraj.ate_rmse((ts, est), (ts, gt)) == jtraj.ate_rmse((ts, est), (ts, gt))


def test_renderer_and_gray_identical():
    cam = jsyn.CameraConfig(
        fx=160.0, fy=160.0, cx=95.5, cy=71.5, k1=0, k2=0, p1=0, p2=0, k3=0, width=192, height=144,
    )
    pcam = psyn.CameraConfig(**dataclasses.asdict(cam))
    for view in ("wall", "corner", "walk"):
        a = jsyn.SyntheticSequence(n_frames=5, cam=cam, view=view)
        b = psyn.SyntheticSequence(n_frames=5, cam=pcam, view=view)
        np.testing.assert_array_equal(a.poses, b.poses)
        for x, y in zip(a.frame(3), b.frame(3)):
            np.testing.assert_array_equal(x, y)
        ra, rb = a.gt_rows(), b.gt_rows()
        for (t1, p1, q1), (t2, p2, q2) in zip(ra, rb):
            assert t1 == t2
            np.testing.assert_array_equal(p1, p2)
            np.testing.assert_array_equal(q1, q2)
    rgb = np.random.default_rng(3).integers(0, 256, (8, 9, 3)).astype(np.uint8)
    for order in (0, 1):
        np.testing.assert_array_equal(port_to_gray(rgb, order), jax_to_gray(rgb, order))


def test_se3_helpers_match_reference():
    rng = np.random.default_rng(5)
    xi = (rng.normal(0, 0.3, (16, 6))).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:] = 1e-6
    T_ref = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    T = pse3.exp_se3(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(T, T_ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        pse3.inverse(torch.from_numpy(T)).numpy(), np.asarray(jse3.inverse(jnp.asarray(T))),
        rtol=0, atol=2e-6,
    )
    M = T[:, :3, :3] * np.float32(1.001) + rng.normal(0, 1e-3, (16, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pse3.polar_rotation(torch.from_numpy(M), iters=2).numpy(),
        np.asarray(jse3.polar_rotation(jnp.asarray(M), iters=2)), rtol=0, atol=2e-6,
    )
    np.testing.assert_array_equal(
        pse3.rotmat_to_quat_np(T[:, :3, :3]), jse3.rotmat_to_quat_np(T[:, :3, :3])
    )
