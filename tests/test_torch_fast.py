"""FAST parity: manhattanslam_tpu_torch.ops.fast against the JAX reference.

Scores are compared exactly: the plain version does the reference's float32
subtractions and exact min/max, so any difference is a fault.  The JAX side
runs as its own tests run it: the jnp formulation and the Pallas kernel in
interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.ops import fast as jfast
from manhattanslam_tpu.ops import image as jimage
from manhattanslam_tpu.ops.fast_pallas import fast_score_map_pallas
from manhattanslam_tpu_torch.ops import fast as pfast
from manhattanslam_tpu_torch.ops import image as pimage


def _images():
    rng = np.random.default_rng(11)
    structured = np.full((64, 96), 50.0, np.float32)
    structured[20:44, 30:60] = 220.0
    return {
        "random": rng.uniform(0, 255, (70, 128)).astype(np.float32),
        "integer": rng.integers(0, 256, (96, 130)).astype(np.float32),
        "structured": structured,
    }


@pytest.fixture(scope="module")
def rendered(small_cfg):
    """A rendered box-room frame and its reference pyramid levels."""
    seq = SyntheticSequence(n_frames=2, cam=small_cfg.camera)
    _, gray, _ = seq.frame(1)
    g = np.round(gray).astype(np.float32)
    levels = jimage.build_pyramid(jnp.asarray(g), 4, 1.2)
    return [np.array(x) for x in levels]


@pytest.mark.parametrize("name", ["random", "integer", "structured"])
def test_score_map_exact_vs_jnp_and_pallas(name):
    img = _images()[name]
    ref = np.asarray(jfast.fast_score_map(jnp.asarray(img)))
    ref_pallas = np.asarray(fast_score_map_pallas(jnp.asarray(img), interpret=True))
    out = pfast.fast_score_map_plain(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, ref_pallas)


def test_score_map_exact_on_pyramid_levels(rendered):
    for level in rendered:
        ref = np.asarray(jfast.fast_score_map(jnp.asarray(level)))
        out = pfast.fast_score_map_plain(torch.from_numpy(level)).numpy()
        np.testing.assert_array_equal(out, ref)


def test_corners_exact_vs_reference(rendered):
    """Per-cell threshold fallback + 3x3 NMS on the same level images."""
    for level in rendered:
        ref = np.asarray(
            jfast.fast_corners(jnp.asarray(level), cell=30, ini_th=20, min_th=7, use_pallas=False)
        )
        out = pfast.fast_corners(torch.from_numpy(level), cell=30, ini_th=20, min_th=7).numpy()
        np.testing.assert_array_equal(out, ref)
        assert (out > 0).sum() > 0


def test_wrapper_runs_plain_version_on_cpu():
    """On a CPU tensor the wrapper is the plain version and counts nothing."""
    img = torch.from_numpy(_images()["random"])
    before = pfast.fast_score_levels.launches
    assert torch.equal(pfast.fast_score_map(img), pfast.fast_score_map_plain(img))
    assert pfast.fast_score_levels.launches == before


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        pfast.fast_score_map(torch.zeros((8, 8), device="meta"))


def test_image_ops_match_reference():
    """Blur: float32 tolerance (same tap order, but XLA's CPU backend may
    fuse a multiply-add where PyTorch rounds twice: one-ulp differences of
    values up to 255).  3x3 max filter and shifts: exact."""
    img = _images()["random"]
    blur_ref = np.asarray(jimage.gaussian_blur(jnp.asarray(img), 7, 2.0))
    blur = pimage.gaussian_blur(torch.from_numpy(img), 7, 2.0).numpy()
    np.testing.assert_allclose(blur, blur_ref, rtol=0, atol=1e-4)
    mp_ref = np.asarray(jimage.maxpool3x3(jnp.asarray(img)))
    np.testing.assert_array_equal(pimage.maxpool3x3(torch.from_numpy(img)).numpy(), mp_ref)
    for dy, dx in [(-3, 1), (2, -2), (0, 3)]:
        np.testing.assert_array_equal(
            pimage.shift2d(torch.from_numpy(img), dy, dx).numpy(),
            np.asarray(jimage.shift2d(jnp.asarray(img), dy, dx)),
        )


def test_pyramid_matches_reference(rendered):
    """Resize products: float32 tolerance (BLAS and XLA sum the banded
    products in different orders; observed differences are a few ulp of
    values up to 255)."""
    h, w = rendered[0].shape
    assert pimage.pyramid_shapes(h, w, 4, 1.2) == jimage.pyramid_shapes(h, w, 4, 1.2)
    ops = pimage.pyramid_operators(h, w, 4, 1.2, "cpu")
    levels = pimage.build_pyramid(torch.from_numpy(rendered[0]), ops)
    for got, ref in zip(levels, rendered):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)
