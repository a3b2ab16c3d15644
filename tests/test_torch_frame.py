"""Frame-extraction parity: manhattanslam_tpu_torch.frontend.frame against
the JAX reference (whose CPU path is the jnp formulation).

Given the same level image, one level's keypoints (xy, response, valid) are
exact.  Angles agree within 1e-4 rad (float32 moments in another order; the
reference's CPU path uses prefix sums).  Descriptors are compared bit for
bit from the same angles, because a 1e-6 angle change can move a rotated
sample across a rounding boundary.  The rounded blur and the pyramid are
float32 products and sums in another order: float32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.config import load_config as jax_load_config
from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.frontend import frame as jframe
from manhattanslam_tpu.ops import image as jimage
from manhattanslam_tpu_torch.frontend import frame as pframe
from manhattanslam_tpu_torch.ops import image as pimage
from manhattanslam_tpu_torch.ops import orb as porb
from torch_parity import port_cfg

ANGLE_TOL = 1e-4


def _wrapped(a, b):
    return np.abs(np.remainder(a - b + np.pi, 2 * np.pi) - np.pi)


@pytest.fixture(scope="module")
def frame_pair(small_cfg):
    """One rendered box-room frame (gray rounded like the tracker's u8
    upload, depth in meters) and both extractors' features."""
    seq = SyntheticSequence(n_frames=3, cam=small_cfg.camera)
    _, gray, depth = seq.frame(2)
    g = np.round(gray).astype(np.float32)
    d = depth.astype(np.float32)
    ref = jax.device_get(jframe.build_extractor(small_cfg)(jnp.asarray(g), jnp.asarray(d)))
    ext = pframe.build_extractor(port_cfg(small_cfg), torch.device("cpu"))
    out = {k: v.numpy() for k, v in ext(torch.from_numpy(g), torch.from_numpy(d)).items()}
    return small_cfg, g, d, {k: np.asarray(v) for k, v in ref.items()}, out


@pytest.mark.parametrize("level", [0, 1, 3])
def test_extract_level_exact_keypoints(frame_pair, level):
    cfg, g, _, _, _ = frame_pair
    lv = np.array(jimage.build_pyramid(jnp.asarray(g), cfg.orb.n_levels, cfg.orb.scale_factor)[level])
    n = cfg.orb.features_per_level()[level]
    ref = jax.device_get(jframe._extract_level(jnp.asarray(lv), n, cfg, use_pallas=False))
    out = pframe._extract_level(torch.from_numpy(lv), n, port_cfg(cfg))
    np.testing.assert_array_equal(out["xy"].numpy(), ref["xy"])
    np.testing.assert_array_equal(out["response"].numpy(), ref["response"])
    np.testing.assert_array_equal(out["valid"].numpy(), ref["valid"])
    assert out["valid"].sum() > 0
    v = ref["valid"]
    assert _wrapped(out["angle"].numpy()[v], ref["angle"][v]).max() < ANGLE_TOL
    # descriptors from the reference's angles: bit-exact unless the rounded
    # blur differs (float32 tolerance) exactly at a sampled pixel
    blurred_ref = np.round(np.asarray(jimage.gaussian_blur(jnp.asarray(lv), 7, 2.0)))
    blurred = torch.round(pimage.gaussian_blur(torch.from_numpy(lv), 7, 2.0))
    moved = blurred.numpy() != blurred_ref
    assert np.abs(blurred.numpy() - blurred_ref).max() <= 1.0 and moved.mean() < 1e-3
    desc = porb.brief_descriptors_plain(
        torch.from_numpy(blurred_ref.astype(np.float32)), out["xy"], torch.from_numpy(np.array(ref["angle"]))
    )
    np.testing.assert_array_equal(desc.numpy().view(np.uint32), ref["desc"])


def test_extractor_layout_and_level0_exact(frame_pair):
    cfg, _, d, ref, out = frame_pair
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
    lvl0 = ref["level"] == 0
    np.testing.assert_array_equal(out["level"], ref["level"])
    np.testing.assert_array_equal(out["xy"][lvl0], ref["xy"][lvl0])
    np.testing.assert_array_equal(out["valid"][lvl0], ref["valid"][lvl0])
    # a level's keypoint set may differ where a pyramid value moved by an
    # ulp: require nearly all keypoints to coincide
    same = (out["xy"] == ref["xy"]).all(1)
    assert same.mean() > 0.9
    np.testing.assert_array_equal(out["depth"][same], ref["depth"][same])
    np.testing.assert_allclose(out["u_right"][same], ref["u_right"][same], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(out["inv_sigma2"], ref["inv_sigma2"], rtol=1e-6)


def test_undistort_and_backproject_match_reference():
    """TUM1's radial-tangential model (8 fixed-point iterations, float32)."""
    jcfg = jax_load_config("configs/TUM1.yaml")
    pcfg = port_cfg(jcfg)
    rng = np.random.default_rng(4)
    xy = np.stack([rng.uniform(0, 640, 300), rng.uniform(0, 480, 300)], -1).astype(np.float32)
    ref = np.asarray(jframe.undistort_points(jnp.asarray(xy), jcfg))
    out = pframe.undistort_points(torch.from_numpy(xy), pcfg).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    feats = {
        "depth": rng.uniform(0, 3, 300).astype(np.float32) * (rng.uniform(size=300) > 0.2),
        "xy_und": np.array(ref),
    }
    ref_p = np.asarray(jframe.backproject_keypoints({k: jnp.asarray(v) for k, v in feats.items()}, jcfg))
    out_p = pframe.backproject_keypoints({k: torch.from_numpy(v) for k, v in feats.items()}, pcfg)
    np.testing.assert_allclose(out_p.numpy(), ref_p, rtol=1e-6, atol=1e-6)


def test_pyramid_operators_equal_reference():
    for ins, outs in [(480, 400), (640, 533), (144, 120)]:
        np.testing.assert_array_equal(
            pimage.resize_matrix_np(ins, outs), jimage._resize_matrix_np(ins, outs)
        )
