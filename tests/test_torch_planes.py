"""Plane extraction (ops/planes.py, the device path) and the closed-form 3x3
eigensolver (ops/eig33.py) in the port against the reference, on the CPU
at small_cfg size, on frames of the box room's "corner" view (a floor and
two perpendicular walls), and at 640x480 (the TUM1 camera) on the
"corner" view, where both join floor and walls into one plane, and on the
"near_corner" view, where both find the three perpendicular planes.

Tolerances:
- the cloud, the hash priorities, the block labels of the merge, the
  plane slots and each plane's ``valid`` and ``n_pts``: equal;
- eig33: eigenvalues within 2e-6 and eigenvectors within 2e-5 (float32
  rounding of the same closed form);
- plane coefficients: normals within 1e-4; the offset d within 1e-4 m
  where the plane's pixels are the same in both (the same membership and
  the same count in the refit before the last re-gate), else within 1e-4
  of |d|
  (the fits sum thousands of float32 coordinates in another order, which
  can move one boundary pixel across the distance gate, and one pixel of
  2500 moves d by ~1e-4 m);
- membership: equal on at least 99% of the pixels either assigns to a
  plane; cloud points equal for at least 99% of the slots.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.ops import eig33 as jeig
from manhattanslam_tpu.ops import planes as jplanes
from manhattanslam_tpu_torch.config import load_config
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence as PortSequence
from manhattanslam_tpu_torch.frontend.device_tracker import DEPTH_QUANT
from manhattanslam_tpu_torch.ops import eig33 as peig
from manhattanslam_tpu_torch.ops import planes as pplanes

FRAMES = (0, 4, 9)
P, M = 8, 512
TUM1 = Path(__file__).resolve().parent.parent / "configs" / "TUM1.yaml"
# (view, frame) at 640x480 and the planes both packages find there
FULL_WIDTH = (("corner", 0), ("corner", 15), ("near_corner", 0), ("near_corner", 22))
FULL_WIDTH_PLANES = {"corner": 1, "near_corner": 3}


def _quantized(depth):
    """Depth as the fused step sees it (u16 in DEPTH_QUANT units)."""
    d16 = np.clip(np.round(depth * DEPTH_QUANT), 0, 65535).astype(np.uint16)
    return d16.astype(np.float32) * np.float32(1.0 / DEPTH_QUANT)


@pytest.fixture(scope="module")
def corner(small_cfg):
    """The corner frames' depths, K, the grid and the gates, and the
    reference's extraction of each frame."""
    seq = SyntheticSequence(n_frames=10, cam=small_cfg.camera, view="corner")
    depths = [_quantized(seq.frame(i)[2]) for i in FRAMES]
    K = np.asarray(small_cfg.camera.K)
    h2, w2 = small_cfg.camera.height // 2, small_cfg.camera.width // 2
    grid = (h2 // 10, w2 // 10)
    min_support = float(np.float32(0.04 * h2 * w2))
    ref = [_reference(d, K, grid, min_support) for d in depths]
    return depths, K, grid, min_support, ref


def _port(depth, K, grid, min_support):
    out = pplanes.extract_planes_device(
        torch.from_numpy(depth), torch.from_numpy(K), P, M, grid, min_support, 0.04)
    return {k: v.numpy() for k, v in out.items()}


def _reference(depth, K, grid, min_support):
    return jax.device_get(jplanes.extract_planes_device(
        jnp.asarray(depth), jnp.asarray(K), P, M, grid, jnp.float32(min_support),
        jnp.float32(0.04)))


def _assert_planes_match(ref, out, depth, K):
    """The tolerances of the module docstring."""
    np.testing.assert_array_equal(out["valid"], ref["valid"])
    np.testing.assert_array_equal(out["n_pts"], ref["n_pts"])
    assert np.abs(out["n_support"] - ref["n_support"]).max() <= 2
    v = ref["valid"]
    np.testing.assert_allclose(out["coeffs"][v, :3], ref["coeffs"][v, :3], rtol=0, atol=1e-4)
    pts = np.asarray(pplanes.depth_to_points(torch.from_numpy(depth), torch.from_numpy(K)))
    for j in np.nonzero(v)[0]:
        on = ref["membership"] == j
        if out["n_support"][j] == ref["n_support"][j] and np.array_equal(out["membership"] == j, on):
            # the same pixels: the two planes within 1e-4 m (RMS) where they lie
            gap = pts[on] @ (out["coeffs"][j, :3] - ref["coeffs"][j, :3]) + (
                out["coeffs"][j, 3] - ref["coeffs"][j, 3])
            assert np.sqrt(np.mean(np.square(gap))) <= 1e-4, j
        else:
            d_ref = ref["coeffs"][j, 3]
            assert abs(out["coeffs"][j, 3] - d_ref) <= 1e-4 * abs(d_ref), j
    member = (ref["membership"] >= 0) | (out["membership"] >= 0)
    assert (out["membership"] == ref["membership"])[member].mean() >= 0.99
    same = (out["cloud"] == ref["cloud"]).all(-1)[v]
    assert same.mean() >= 0.99


def test_eig33_smallest_matches_reference():
    """Seeded symmetric matrices: random ones, plane-like scatters (one
    small eigenvalue) and exactly degenerate ones."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(300, 3, 3)).astype(np.float32)
    A = (A + A.transpose(0, 2, 1)) / 2
    pts = rng.normal(size=(300, 50, 3)).astype(np.float32) * np.float32([1.0, 0.7, 0.01])
    S = np.einsum("bni,bnj->bij", pts, pts) / 50
    mats = np.concatenate([A, S.astype(np.float32), np.zeros((2, 3, 3), np.float32)])
    lam_ref, v_ref = (np.asarray(x) for x in jeig.eig33_smallest(jnp.asarray(mats)))
    lam, v = peig.eig33_smallest(torch.from_numpy(mats))
    np.testing.assert_allclose(lam.numpy(), lam_ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(v.numpy()[-2:], np.float32([[0, 0, 1], [0, 0, 1]]))


@pytest.mark.parametrize("hw", [(144, 192), (31, 45)])
def test_depth_to_points_strided_slice_equals_selection_products(hw):
    """The port's strided slice gives the reference's 0/1 selection
    products exactly, holes (0 depth) as nan, odd sizes included."""
    rng = np.random.default_rng(hw[0])
    depth = rng.uniform(0.5, 6.0, hw).astype(np.float32)
    depth[rng.uniform(size=hw) < 0.1] = 0.0
    K = np.float32([[160.0, 0, 95.5], [0, 160.0, 71.5], [0, 0, 1]])
    ref = np.asarray(jplanes.depth_to_points(jnp.asarray(depth), jnp.asarray(K)))
    out = pplanes.depth_to_points(torch.from_numpy(depth), torch.from_numpy(K)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n", [192 // 2 * 144 // 2, 640 // 2 * 480 // 2])
def test_hash_priorities_equal_reference(n):
    """The cloud's Knuth hash (int32 products that wrap, arithmetic
    shift) at the small and the 640x480 cloud sizes."""
    idx = jnp.arange(n, dtype=jnp.int32)
    ref = np.asarray(jnp.abs((idx * jnp.int32(-1640531535)) >> jnp.int32(8)) | jnp.int32(1))
    out = pplanes.hash_priorities(n, torch.device("cpu"))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("frame", range(len(FRAMES)))
def test_extract_planes_matches_reference(corner, frame):
    depths, K, grid, min_support, refs = corner
    ref, out = refs[frame], _port(depths[frame], K, grid, min_support)
    assert int(ref["valid"].sum()) == 3  # floor and two walls
    _assert_planes_match(ref, out, depths[frame], K)


@pytest.fixture(scope="module")
def full_width():
    """Depths of the FULL_WIDTH frames at the TUM1 camera (640x480: a
    24x32 grid of blocks on the 320x240 cloud), K, the grid and the
    gates, and the reference's extraction of each."""
    cam = load_config(str(TUM1)).camera
    seqs = {v: PortSequence(n_frames=30, cam=cam, view=v) for v in FULL_WIDTH_PLANES}
    depths = {(v, i): _quantized(seqs[v].frame(i)[2]) for v, i in FULL_WIDTH}
    K = np.asarray(cam.K, np.float32)
    h2, w2 = cam.height // 2, cam.width // 2
    grid = (h2 // 10, w2 // 10)
    assert grid == (24, 32)
    min_support = float(np.float32(0.04 * h2 * w2))
    ref = {key: _reference(d, K, grid, min_support) for key, d in depths.items()}
    return depths, K, grid, min_support, ref


@pytest.mark.parametrize("view,frame", FULL_WIDTH, ids=[f"{v}-{i}" for v, i in FULL_WIDTH])
def test_extract_planes_640x480_matches_reference(full_width, view, frame):
    """At 640x480 the corner view's floor and walls (3-7 m) are one plane
    in both packages: blocks across the folds pass the planarity gate
    and the depth-widened angle gate, so the label propagation joins the
    surfaces.  The near_corner view's (0.9-2.2 m) are three
    perpendicular planes in both."""
    depths, K, grid, min_support, refs = full_width
    ref, out = refs[(view, frame)], _port(depths[(view, frame)], K, grid, min_support)
    assert int(ref["valid"].sum()) == FULL_WIDTH_PLANES[view]
    _assert_planes_match(ref, out, depths[(view, frame)], K)
    n = out["coeffs"][out["valid"], :3]
    off = np.abs(n @ n.T)[np.triu_indices(len(n), 1)]
    assert (off < 0.02).all()  # the near corner's planes are perpendicular


def test_block_labels_and_slots_equal_reference(corner):
    """Block statistics, the label propagation and the support ranking
    before the pixel stage: the same roots and plane slots."""
    depths, K, grid, min_support, _ = corner
    for d in depths:
        pts = np.asarray(jplanes.depth_to_points(jnp.asarray(d), jnp.asarray(K)))
        st_ref = jax.device_get(jplanes.block_stats(jnp.asarray(pts)))
        lab_ref = np.asarray(jplanes.merge_blocks_device(st_ref, grid, jnp.float32(min_support)))
        slots_ref = np.asarray(jplanes.top_segments(jnp.asarray(lab_ref), st_ref["n"], P))
        st = pplanes.block_stats(torch.from_numpy(np.array(pts)))
        np.testing.assert_array_equal(st["valid"].numpy(), st_ref["valid"])
        lab = pplanes.merge_blocks_device(st, grid, min_support)
        np.testing.assert_array_equal(lab.numpy(), lab_ref)
        slots = pplanes.top_segments(lab, st["n"], P)
        np.testing.assert_array_equal(slots.numpy(), slots_ref)


def test_top_segments_ties_put_the_lower_root_first():
    """Segments of equal support (the same number of full blocks) take
    plane slots in root order, as jax.lax.top_k orders ties; segments past
    the cap get no slot."""
    rng = np.random.default_rng(2)
    B = 40
    roots = np.array([31, 4, 17, 9, 22, 0, 36, 12, 27, 6])
    labels = np.full(B, -1, np.int32)
    for r in roots:
        labels[r] = r
    free = [i for i in range(B) if labels[i] < 0]
    rng.shuffle(free)
    for r, i in zip(np.repeat(roots, 2), free):  # 3 blocks per segment
        labels[i] = r
    n_blocks = np.full(B, 100, np.int32)
    ref = np.asarray(jplanes.top_segments(jnp.asarray(labels), jnp.asarray(n_blocks), P))
    out = pplanes.top_segments(torch.from_numpy(labels), torch.from_numpy(n_blocks), P).numpy()
    np.testing.assert_array_equal(out, ref)
    ranked = np.sort(roots)
    for slot, r in enumerate(ranked[:P]):
        assert (out[labels == r] == slot).all()
    assert (out[np.isin(labels, ranked[P:])] == -1).all()


def test_snake_segment_splits_as_in_the_reference():
    """The merge runs the reference's fixed count of (local step + pointer
    jump) rounds, which is no guaranteed fixpoint (reference
    ops/planes.py:219): a one-block-wide serpentine segment on the 24x32
    grid of a 640x480 frame stays split into several labels.  The port
    copies the count and the split."""
    bh, bw = 24, 32
    valid = np.zeros((bh, bw), bool)
    valid[::2] = True  # rows joined at alternating ends
    valid[1::4, -1] = True
    valid[3::4, 0] = True
    stats = {
        "valid": valid.reshape(-1),
        "normal": np.tile(np.float32([0, 0, -1]), (bh * bw, 1)),
        "mean": np.tile(np.float32([0, 0, 2.0]), (bh * bw, 1)),
        "n": np.full(bh * bw, 100, np.int32),
    }
    ref = np.asarray(jplanes.merge_blocks_device(
        {k: jnp.asarray(v) for k, v in stats.items()}, (bh, bw), jnp.float32(0)))
    out = pplanes.merge_blocks_device(
        {k: torch.from_numpy(v) for k, v in stats.items()}, (bh, bw), 0.0).numpy()
    np.testing.assert_array_equal(out, ref)
    assert pplanes.merge_rounds(bh * bw) == 11
    assert len(np.unique(out[out >= 0])) > 1


def test_batched_extraction_equals_single_calls(corner):
    """Two streams in one call (every reduction, scatter and ordering per
    stream) give exactly each stream's single call."""
    depths, K, grid, min_support, _ = corner
    both = pplanes.extract_planes_device(
        torch.from_numpy(np.stack(depths[:2])), torch.from_numpy(K), P, M, grid,
        min_support, 0.04)
    for b in range(2):
        one = _port(depths[b], K, grid, min_support)
        for k, v in one.items():
            np.testing.assert_array_equal(both[k][b].numpy(), v, err_msg=k)
