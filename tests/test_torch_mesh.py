"""The mesh entries of parallel/mesh.py in the port, on the CPU at
small_cfg size (the reference's tests/test_parallel.py on the port).

A port mesh of the CPU named several times stands in for the reference's
virtual CPU devices (tests/conftest.py:25-28): each entry takes its own
shard.

- ``make_mesh``: sizes, the axis, and CUDA by default.
- ``sharded_hamming_argmin`` on an 8-entry mesh against the reference's
  on its 8 virtual devices, with descriptors drawn from four bases with a
  few bits flipped, so that distances tie often: indices and distances
  equal, and equal to the single-bank argmin (ties to the lowest index).
- ``build_batched_track_step`` at B = 2 on 2-entry meshes against the
  reference's, with a bank of frame 0's back-projected keypoints (as
  tests/test_parallel.py:60-111 builds its map, not the empty bank of
  :32-57) on the "corner" view (whose features the two extractors give
  bit for bit; on the walk, coarse-level keypoints swap with the
  pyramid's ulps), each stream seeded at the ground-truth pose of the
  frame before its own: T within 1e-3 m / 1e-3 rad, n_matches and
  n_inliers equal.  The reference's sharded step compiles for ~50 s on
  the CPU, so that comparison is marked slow; the port's B = 2 against
  its B = 1 steps stays in tier-1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from manhattanslam_tpu.parallel import mesh as jmesh
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu_torch.frontend.frame import backproject_keypoints, build_extractor
from manhattanslam_tpu_torch.ops import matching
from manhattanslam_tpu_torch.parallel import mesh
from torch_parity import port_cfg, rot_angle

CPU = torch.device("cpu")
POSE_TOL = 1e-3


def test_make_mesh():
    m = mesh.make_mesh(devices=[CPU] * 8)
    assert m.devices.size == 8 and m.axis_names == ("seq",)
    m = mesh.make_mesh(4, axis="lm", devices=[CPU] * 8)
    assert m.devices.size == 4 and m.axis_names == ("lm",)
    assert all(d == CPU for d in m.devices)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.make_mesh()


def test_sharded_hamming_argmin_matches_reference():
    rng = np.random.default_rng(21)
    base = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)

    def draw(n):
        d = base[rng.integers(0, 4, n)].copy()
        flips = rng.integers(0, 256, (n, 3))
        for j in range(3):  # up to 3 bits flipped per descriptor
            w, b = flips[:, j] // 32, flips[:, j] % 32
            d[np.arange(n), w] ^= (rng.random(n) < 0.5).astype(np.uint32) << b.astype(np.uint32)
        return d

    q, bank = draw(32), draw(64 * 8)
    ref_idx, ref_dist = jmesh.sharded_hamming_argmin(
        jnp.asarray(q), jnp.asarray(bank), jmesh.make_mesh(8, axis="lm"))
    idx, dist = mesh.sharded_hamming_argmin(
        torch.from_numpy(q.view(np.int32)), torch.from_numpy(bank.view(np.int32)),
        mesh.make_mesh(axis="lm", devices=[CPU] * 8))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(ref_dist))
    full = matching.hamming_matrix(torch.from_numpy(q.view(np.int32)),
                                   torch.from_numpy(bank.view(np.int32))).numpy()
    np.testing.assert_array_equal(idx.numpy(), full.argmin(1))
    np.testing.assert_array_equal(dist.numpy(), full.min(1))
    assert (np.sort(full, 1)[:, 0] == np.sort(full, 1)[:, 1]).mean() > 0.5  # ties are common


@pytest.fixture(scope="module")
def traffic(small_cfg):
    """Frames 1..2 of the corner view, their seeds (the ground-truth pose of the
    frame before, in frame 0's camera) and a bank of frame 0's
    back-projected keypoints, repeated per stream."""
    cfg = port_cfg(small_cfg)
    seq = SyntheticSequence(n_frames=3, cam=cfg.camera, view="corner")
    frames = [seq.frame(i) for i in range(3)]
    feats = build_extractor(cfg, CPU)(torch.from_numpy(np.round(frames[0][1])),
                                      torch.from_numpy(frames[0][2]))
    pos = backproject_keypoints(feats, cfg).numpy()
    valid = (feats["valid"] & (feats["depth"] > 0)).numpy()
    B = 2
    bank = {"pos": pos, "desc": feats["desc"].numpy(), "valid": valid,
            "level": feats["level"].numpy()}
    bank = {k: np.stack([v] * B) for k, v in bank.items()}
    # gray rounded as the trackers upload it (tests/test_torch_frame.py)
    gray = np.round(np.stack([frames[1 + i][1] for i in range(B)])).astype(np.float32)
    depth = np.stack([frames[1 + i][2] for i in range(B)]).astype(np.float32)
    seeds = np.stack([np.linalg.inv(seq.poses[i]) @ seq.poses[0] for i in range(B)])
    return cfg, gray, depth, seeds.astype(np.float32), bank


def _port_step(cfg, n_dev, gray, depth, seeds, bank):
    step = mesh.build_batched_track_step(cfg, mesh.make_mesh(devices=[CPU] * n_dev))
    out = step(torch.from_numpy(gray), torch.from_numpy(depth), torch.from_numpy(seeds),
               {k: torch.from_numpy(v) for k, v in bank.items()})
    return {k: v.numpy() for k, v in out.items()}


def _assert_close(a, b, i):
    assert np.abs(a["T"][i][:3, 3] - b["T"][i][:3, 3]).max() < POSE_TOL, i
    assert rot_angle(a["T"][i][:3, :3] @ b["T"][i][:3, :3].T) < POSE_TOL, i
    assert int(a["n_matches"][i]) == int(b["n_matches"][i]), i
    assert int(a["n_inliers"][i]) == int(b["n_inliers"][i]), i


@pytest.mark.slow
def test_batched_track_step_matches_reference(small_cfg, traffic):
    cfg, gray, depth, seeds, bank = traffic
    out = _port_step(cfg, 2, gray, depth, seeds, bank)
    ref_step = jmesh.build_batched_track_step(small_cfg, jmesh.make_mesh(2))
    ref = ref_step(jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(seeds),
                   {k: jnp.asarray(v.view(np.uint32) if k == "desc" else v)
                    for k, v in bank.items()})
    ref = {k: np.asarray(v) for k, v in ref.items()}
    for i in range(gray.shape[0]):
        assert int(ref["n_inliers"][i]) > 50, i
        _assert_close(out, ref, i)


def test_batched_track_step_b2_matches_b1(traffic):
    cfg, gray, depth, seeds, bank = traffic
    out = _port_step(cfg, 2, gray, depth, seeds, bank)
    assert out["T"].shape == (2, 4, 4) and np.isfinite(out["T"]).all()
    for i in range(gray.shape[0]):
        one = _port_step(cfg, 1, gray[i:i + 1], depth[i:i + 1], seeds[i:i + 1],
                         {k: v[i:i + 1] for k, v in bank.items()})
        assert int(one["n_inliers"][0]) > 50
        _assert_close(out, {k: np.concatenate([v] * 2) for k, v in one.items()}, i)
    with pytest.raises(ValueError, match="split"):
        _port_step(cfg, 3, gray, depth, seeds, bank)
