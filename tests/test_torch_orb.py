"""ORB parity: manhattanslam_tpu_torch.ops.orb against the JAX reference.

Tolerances: the pattern, grid top-K selection and BRIEF words are exact
(the same integer/float32 comparisons); the IC angle agrees within 1e-4
rad (the moments are float32 sums taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.ops import orb as jorb
from manhattanslam_tpu.ops.orb_pallas import brief_descriptors_pallas, ic_angle_pallas
from manhattanslam_tpu_torch import convert
from manhattanslam_tpu_torch.ops import image as pimage
from manhattanslam_tpu_torch.ops import orb as porb

ANGLE_TOL = 1e-4


def _wrapped(a, b):
    return np.abs(np.remainder(a - b + np.pi, 2 * np.pi) - np.pi)


def _keypoints(rng, h, w, n, integer=True):
    b = jorb.EDGE_THRESHOLD
    xy = np.stack([rng.uniform(b, w - b - 1, n), rng.uniform(b, h - b - 1, n)], -1)
    return (np.round(xy) if integer else xy).astype(np.float32)


def test_constants_equal_reference():
    np.testing.assert_array_equal(porb.PATTERN, jorb.PATTERN)
    assert porb.PATTERN.dtype == np.int32 and porb.PATTERN.shape == (256, 2, 2)
    np.testing.assert_array_equal(porb.UMAX, jorb.UMAX)
    np.testing.assert_array_equal(porb.CIRC_MASK, jorb.CIRC_MASK)
    t = convert.pattern_from_numpy(np.asarray(jorb.PATTERN), "cpu")
    np.testing.assert_array_equal(t.numpy(), porb.PATTERN)


@pytest.mark.parametrize("hw,n_out,k", [((120, 160), 60, 4), ((100, 133), 40, 8), ((58, 77), 30, 2)])
def test_grid_topk_exact_with_ties(hw, n_out, k):
    """Score maps full of ties (integer scores, many zeros): the same
    keypoints in the same order as jax.lax.top_k (lowest index first)."""
    rng = np.random.default_rng(hw[0])
    score = rng.integers(0, 6, hw).astype(np.float32) * (rng.uniform(size=hw) < 0.3)
    xy_r, resp_r, valid_r = jorb.select_grid_topk(jnp.asarray(score), n_out, cell=32, k_per_cell=k)
    xy, resp, valid = porb.select_grid_topk(torch.from_numpy(score), n_out, cell=32, k_per_cell=k)
    np.testing.assert_array_equal(xy.numpy(), np.asarray(xy_r))
    np.testing.assert_array_equal(resp.numpy(), np.asarray(resp_r))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_r))


def _ic_angle_f64(img, xy):
    """Exact moments in float64 (direct sum over the circular patch)."""
    r = jorb.HALF_PATCH
    h, w = img.shape
    x0 = np.clip(xy[:, 0].astype(np.int32), r, w - r - 1)
    y0 = np.clip(xy[:, 1].astype(np.int32), r, h - r - 1)
    d = np.arange(-r, r + 1)
    out = []
    for x, y in zip(x0, y0):
        p = img[y - r : y + r + 1, x - r : x + r + 1].astype(np.float64) * jorb.CIRC_MASK
        out.append(np.arctan2((p * d[:, None]).sum(), (p * d[None, :]).sum()))
    return np.float32(out)


@pytest.mark.parametrize("hw", [(120, 320), (96, 214), (60, 80)])
def test_ic_angle_vs_pallas_interpret_and_exact(hw):
    """Against the Pallas kernel (interpret mode, same direct sum) where its
    patch window fits, and against float64 moments.  The reference's jnp
    prefix-sum form is compared only on the narrow image: on wide rows its
    float32 prefix sums cancel (2.7e-4 rad seen at width 320)."""
    rng = np.random.default_rng(hw[1])
    h, w = hw
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    xy = _keypoints(rng, h, w, 37, integer=False)
    out = porb.ic_angle_plain(torch.from_numpy(img), torch.from_numpy(xy)).numpy()
    assert _wrapped(out, _ic_angle_f64(img, xy)).max() < ANGLE_TOL
    if h >= 56 and w >= 128:  # the Pallas kernel's patch window
        ref_pallas = np.asarray(ic_angle_pallas(jnp.asarray(img), jnp.asarray(xy), interpret=True))
        assert _wrapped(out, ref_pallas).max() < ANGLE_TOL
    else:
        ref_jnp = np.asarray(jorb.ic_angle(jnp.asarray(img), jnp.asarray(xy)))
        assert _wrapped(out, ref_jnp).max() < ANGLE_TOL


@pytest.mark.parametrize("hw,integer_xy", [((120, 320), True), ((96, 256), False), ((120, 214), True)])
def test_brief_bit_exact_vs_jnp_and_pallas(hw, integer_xy):
    """Integer-valued image (the extractor feeds the integer-rounded blur)."""
    rng = np.random.default_rng(7 + hw[1])
    h, w = hw
    img = rng.integers(0, 256, (h, w)).astype(np.float32)
    xy = _keypoints(rng, h, w, 41, integer=integer_xy)
    angle = rng.uniform(-np.pi, np.pi, 41).astype(np.float32)
    ref = np.asarray(jorb.brief_descriptors(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(angle)))
    ref_pallas = np.asarray(
        brief_descriptors_pallas(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(angle), interpret=True)
    )
    out = porb.brief_descriptors_plain(
        torch.from_numpy(img), torch.from_numpy(xy), torch.from_numpy(angle)
    )
    assert out.dtype == torch.int32
    words = out.numpy().view(np.uint32)
    np.testing.assert_array_equal(words, ref)
    np.testing.assert_array_equal(words, ref_pallas)


def test_brief_border_keypoints():
    """Keypoints at the EDGE_THRESHOLD border (the clipping path)."""
    rng = np.random.default_rng(3)
    h, w = 96, 256
    img = rng.integers(0, 256, (h, w)).astype(np.float32)
    b = jorb.EDGE_THRESHOLD
    xy = np.float32([[b, b], [w - b - 1, h - b - 1], [b, h - b - 1], [w - b - 1, b], [w / 2, h / 2]])
    angle = np.float32([0.3, -2.0, 1.4, 3.0, -0.7])
    ref = np.asarray(jorb.brief_descriptors(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(angle)))
    out = porb.brief_descriptors_plain(
        torch.from_numpy(img), torch.from_numpy(xy), torch.from_numpy(angle))
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref)


def test_unpack_descriptor_bits_equal():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, (9, 8), dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jorb.unpack_descriptor_bits(jnp.asarray(words)))
    out = porb.unpack_descriptor_bits(convert.tensor_from_numpy(words, "cpu")).numpy()
    np.testing.assert_array_equal(out, ref)


def test_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors the one-level wrappers are their plain versions (BRIEF
    on the integer-rounded blur of the raw level) and count no launch."""
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.integers(0, 256, (80, 120)).astype(np.float32))
    xy = torch.from_numpy(_keypoints(rng, 80, 120, 10))
    before = (porb.ic_angle_levels.launches, porb.brief_levels.launches)
    ang = porb.ic_angle(img, xy)
    assert torch.equal(ang, porb.ic_angle_plain(img, xy))
    blurred = torch.round(pimage.gaussian_blur(img, porb.BLUR_KSIZE, porb.BLUR_SIGMA))
    assert torch.equal(porb.brief_level(img, xy, ang),
                       porb.brief_descriptors_plain(blurred, xy, ang))
    assert (porb.ic_angle_levels.launches, porb.brief_levels.launches) == before
