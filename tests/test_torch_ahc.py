"""The exact AHC plane merge in the port (``extract_planes(method="ahc")``,
ops/planes.py and the C++ merge of csrc/ahc_merge.cpp) against the
reference, on the CPU at small_cfg size (192x144): the "wall" view's
frame 0 (tests/test_planes.py's frame) and the "corner" view's frames 0
and 9.

- ``plane_stage1``: the valid flags equal; the counts, sums and means
  within float32 rounding of sums in another order (rtol 1e-5); the
  normals within 2e-4 and the MSE within 2e-5 m^2, the closed-form
  eigenpair of E[xx^T] - mean mean^T, which cancels in float32 at a few
  metres (up to 1.3e-4 and 1e-5 on these frames).  The merges below are
  held on the same stats.
- ``merge_blocks_py`` against the reference's on the same pulled stats:
  labels equal (the same float64 heap, popped in the same order).
- The C++ merge, built here with g++, against the Python merge on the
  same stats: the same partition.
- ``extract_planes(method="ahc", device="cpu")`` against the reference's:
  tests/test_torch_planes.py's tolerances for the stage both run after
  the merge (``plane_stage2``): valid and n_pts equal, n_support within
  2 pixels and the coefficients within 1e-4 (float32 sums in another
  order can move a boundary pixel across the distance gate), membership
  and clouds equal on >= 99%.
- The bars of tests/test_planes.py:114-197 on the port: the C++ merge's
  partition is the Python merge's; the device merge finds the exact AHC
  merge's plane count and a device plane within 3 degrees / 3 cm of each
  AHC plane; on the photo-textured corner with depth noise each AHC plane
  has a device plane (5 degrees / 5 cm) at pixel IoU >= 0.9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.ops import planes as jplanes
from manhattanslam_tpu_torch.ops import native, planes
from test_planes import _partition_equal
from test_torch_planes import _assert_planes_match

CPU = torch.device("cpu")
P, M = 8, 256
CASES = (("wall", 0), ("corner", 0), ("corner", 9))


@pytest.fixture(scope="module")
def frames(small_cfg):
    out = {}
    for view in ("wall", "corner"):
        seq = SyntheticSequence(n_frames=10, cam=small_cfg.camera, view=view)
        for v, i in CASES:
            if v == view:
                out[(v, i)] = seq.frame(i)[2].astype(np.float32)
    K = np.asarray(small_cfg.camera.K, np.float32)
    h, w = small_cfg.camera.height // 2, small_cfg.camera.width // 2
    return out, K, (h // planes.BLOCK, w // planes.BLOCK), int(0.04 * h * w)


@pytest.fixture(scope="module")
def stats(frames):
    """Both packages' stage 1 of each case: (port packed, reference packed)."""
    depths, K, _, _ = frames
    out = {}
    for case, d in depths.items():
        _, ref = jplanes.plane_stage1(jnp.asarray(d), jnp.asarray(K), 2)
        _, port = planes.plane_stage1(torch.from_numpy(d), torch.from_numpy(K), 2)
        out[case] = (port.numpy(), np.asarray(ref))
    return out


@pytest.mark.parametrize("case", CASES)
def test_plane_stage1_matches_reference(stats, case):
    port, ref = stats[case]
    np.testing.assert_array_equal(port[:, 17], ref[:, 17])  # valid
    assert port[:, 17].sum() > 20
    sums = np.r_[0:10, 13:16]
    np.testing.assert_allclose(port[:, sums], ref[:, sums], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port[:, 10:13], ref[:, 10:13], rtol=0, atol=2e-4)
    np.testing.assert_allclose(port[:, 16], ref[:, 16], rtol=0, atol=2e-5)


@pytest.mark.parametrize("case", CASES)
def test_merge_blocks_py_matches_reference(frames, stats, case):
    _, _, grid, min_support = frames
    st = planes.unpack_stats(stats[case][0])
    labels = planes.merge_blocks(st, grid, min_support, use_native=False)
    np.testing.assert_array_equal(labels, jplanes.merge_blocks_py(st, grid, min_support))
    assert labels.max() >= 1  # at least two segments


@pytest.mark.parametrize("case", CASES)
def test_native_merge_matches_python(frames, stats, case):
    """tests/test_planes.py:114-128 on the port (the C++ merge built by
    ops/kernel_build.py with g++)."""
    _, _, grid, min_support = frames
    assert native.have_native()
    st = planes.unpack_stats(stats[case][0])
    lab_py = planes.merge_blocks_py(st, grid, min_support)
    lab_cc = planes.merge_blocks(st, grid, min_support)
    assert lab_cc.dtype == np.int32
    assert _partition_equal(lab_py, lab_cc)
    # a fixed normal gate goes through the same C signature
    assert _partition_equal(planes.merge_blocks_py(st, grid, min_support, angle_cos=0.9),
                            native.ahc_merge_native(st, grid, min_support, angle_cos=0.9))


@pytest.mark.parametrize("case", CASES)
def test_extract_planes_ahc_matches_reference(frames, case):
    depths, K, _, _ = frames
    d = depths[case]
    ref = {k: np.asarray(v) for k, v in
           jplanes.extract_planes(d, K, P, M, method="ahc").items()}
    port = planes.extract_planes(d, K, P, M, method="ahc", device=CPU)
    assert port["valid"].sum() >= 2
    _assert_planes_match(ref, {**port, "membership": port["membership"].numpy()}, d, K)


@pytest.mark.parametrize("case", CASES)
def test_device_merge_matches_exact_ahc(frames, case):
    """tests/test_planes.py:131-150 on the port."""
    depths, K, _, _ = frames
    dev = planes.extract_planes(depths[case], K, P, M, method="device", device=CPU)
    ahc = planes.extract_planes(depths[case], K, P, M, method="ahc", device=CPU)
    na, nd = int(ahc["valid"].sum()), int(dev["valid"].sum())
    assert na >= 2
    assert nd == na, f"device {nd} planes vs exact AHC {na}"
    cd = dev["coeffs"][dev["valid"]]
    for c in ahc["coeffs"][ahc["valid"]]:
        cand = (np.abs(cd[:, :3] @ c[:3]) > np.cos(np.radians(3.0))) & (
            np.abs(cd[:, 3] - c[3]) < 0.03)
        assert cand.any(), f"no device match for {c}"


def test_device_membership_iou_vs_ahc_phototex():
    """tests/test_planes.py:153-197 on the port: the photo-textured corner
    with Kinect-like depth noise."""
    from manhattanslam_tpu_torch.config import CameraConfig
    from manhattanslam_tpu_torch.datasets.phototex import PhotoSequence

    cam = CameraConfig(fx=160.0, fy=160.0, cx=95.5, cy=71.5, k1=0, k2=0, p1=0, p2=0, k3=0,
                       width=192, height=144)
    depth = PhotoSequence(n_frames=2, cam=cam, view="corner").frame(0)[2]
    K = np.array([[160.0, 0, 95.5], [0, 160.0, 71.5], [0, 0, 1]], np.float32)
    dev = planes.extract_planes(depth, K, P, M, method="device", device=CPU)
    ahc = planes.extract_planes(depth, K, P, M, method="ahc", device=CPU)
    assert int(ahc["valid"].sum()) >= 2
    ma, md = ahc["membership"].numpy(), dev["membership"].numpy()
    for i in np.nonzero(ahc["valid"])[0]:
        c = ahc["coeffs"][i]
        cand = np.nonzero(dev["valid"] & (np.abs(dev["coeffs"][:, :3] @ c[:3]) > np.cos(
            np.radians(5.0))) & (np.abs(dev["coeffs"][:, 3] - c[3]) < 0.05))[0]
        assert len(cand), f"no device plane matches AHC plane {i}"
        a = ma == i
        iou = max(((a & (md == j)).sum() / max((a | (md == j)).sum(), 1)) for j in cand)
        assert iou >= 0.9, f"plane {i}: IoU {iou:.3f}"
