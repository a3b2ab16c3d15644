"""The batched multi-sequence replay (BASELINE config 5) in the port against
the reference, on the CPU at small_cfg size.

Kernels: the plain versions with a leading stream axis B against the
reference's Pallas batched twins, run as the reference's own tests run them
(``jax.vmap`` of the Pallas call in interpret mode, which takes the
batch-gridded kernel through its custom_vmap rule).  FAST scores and BRIEF
words are exact; IC angles agree within 1e-4 rad (float32 moments in
another order).  Each batched plain version equals a loop of single calls.

The slice: the port's ``build_throughput_step`` at B = 2, the full body
(points, planes with the Manhattan pose, and lines), two streams of the
box room's "corner" view at different frame offsets, against the
reference's own ``build_throughput_step(small_cfg, 2)`` (its full fused
body vmapped over the streams with one shared view, as
tests/test_parallel.py builds it), both from the same view (keyframe 0
with its map planes, Manhattan registries and map lines) and the same
carry.  Per stream and step: pose within 1e-3 m and 1e-3 rad (the two
pyramids differ by float32 ulps, which can swap a keypoint at a coarse
level), tracked_ok, n_inliers (points, lines and planes),
manhattan_found and use_manhattan equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manhattanslam_tpu.frontend import device_tracker as jdt
from manhattanslam_tpu.ops import orb as jorb
from manhattanslam_tpu.ops.fast_pallas import fast_score_map_pallas
from manhattanslam_tpu.ops.orb_pallas import brief_descriptors_pallas, ic_angle_pallas
from manhattanslam_tpu.parallel import mesh as jmesh
from manhattanslam_tpu.slam_map import SlamMap as JaxSlamMap
from manhattanslam_tpu_torch import convert
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu_torch.frontend import device_tracker as pdt
from manhattanslam_tpu_torch.frontend import tracking_ops as ptops
from manhattanslam_tpu_torch.frontend.frame import backproject_keypoints, build_extractor
from manhattanslam_tpu_torch.geometry import se3
from manhattanslam_tpu_torch.ops import fast as pfast
from manhattanslam_tpu_torch.ops import image as pimage
from manhattanslam_tpu_torch.ops import matching as pm
from manhattanslam_tpu_torch.ops import orb as porb
from manhattanslam_tpu_torch.parallel import mesh as pmesh
from manhattanslam_tpu_torch.parallel import replay as preplay
from torch_parity import port_cfg, rot_angle

CPU = torch.device("cpu")
ANGLE_TOL = 1e-4
N_FRAMES = 30
OFFSETS = (2, 5)  # the two streams' first frames
N_STEPS = 3


def _wrapped(a, b):
    return np.abs(np.remainder(a - b + np.pi, 2 * np.pi) - np.pi)


def _batched_keypoints(rng, b, h, w, n):
    e = porb.EDGE_THRESHOLD
    xy = np.stack([rng.uniform(e, w - e - 1, (b, n)), rng.uniform(e, h - e - 1, (b, n))], -1)
    return xy.astype(np.float32)


def _fast_case(rng):
    imgs = rng.integers(0, 256, (3, 96, 160)).astype(np.float32)
    ref = jax.vmap(lambda im: fast_score_map_pallas(im, interpret=True))(jnp.asarray(imgs))
    out = pfast.fast_score_map_plain(torch.from_numpy(imgs))
    singles = [pfast.fast_score_map_plain(torch.from_numpy(im)) for im in imgs]
    return np.asarray(ref), out, singles, 0.0


def _ic_angle_case(rng):
    imgs = rng.integers(0, 256, (2, 120, 320)).astype(np.float32)
    xy = _batched_keypoints(rng, 2, 120, 320, 17)
    ref = jax.vmap(lambda im, p: ic_angle_pallas(im, p, interpret=True))(
        jnp.asarray(imgs), jnp.asarray(xy)
    )
    out = porb.ic_angle_plain(torch.from_numpy(imgs), torch.from_numpy(xy))
    singles = [porb.ic_angle_plain(torch.from_numpy(im), torch.from_numpy(p)) for im, p in zip(imgs, xy)]
    return np.asarray(ref), out, singles, ANGLE_TOL


def _brief_case(rng):
    imgs = rng.integers(0, 256, (3, 120, 320)).astype(np.float32)
    xy = _batched_keypoints(rng, 3, 120, 320, 21)
    angle = rng.uniform(-np.pi, np.pi, (3, 21)).astype(np.float32)
    ref = jax.vmap(lambda im, p, a: brief_descriptors_pallas(im, p, a, interpret=True))(
        jnp.asarray(imgs), jnp.asarray(xy), jnp.asarray(angle)
    )
    t = [torch.from_numpy(x) for x in (imgs, xy, angle)]
    out = porb.brief_descriptors_plain(*t)
    singles = [porb.brief_descriptors_plain(*(x[i] for x in t)) for i in range(3)]
    return np.asarray(ref).view(np.int32), out, singles, 0.0


@pytest.mark.parametrize("case", [_fast_case, _ic_angle_case, _brief_case], ids=["fast", "ic_angle", "brief"])
def test_batched_plain_vs_pallas_twin_and_single_calls(case):
    """Each kernel's plain version on a (B, ...) batch against the
    reference's batch-gridded Pallas twin, and against B single calls."""
    ref, out, singles, tol = case(np.random.default_rng(7))
    got = out.numpy()
    assert got.shape == ref.shape
    if tol:
        assert _wrapped(got, ref).max() < tol
    else:
        np.testing.assert_array_equal(got, ref)
    for b, single in enumerate(singles):
        assert torch.equal(out[b], single), f"stream {b}"


def test_batched_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors a batched wrapper call is its plain version (BRIEF on
    the integer-rounded blur of the raw images) and counts no launch."""
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 64, 96)).astype(np.float32))
    xy = torch.from_numpy(_batched_keypoints(rng, 2, 64, 96, 9))
    angle = torch.from_numpy(rng.uniform(-3, 3, (2, 9)).astype(np.float32))
    before = (pfast.fast_score_levels.launches, porb.ic_angle_levels.launches,
              porb.brief_levels.launches)
    assert torch.equal(pfast.fast_score_map(imgs), pfast.fast_score_map_plain(imgs))
    assert torch.equal(porb.ic_angle(imgs, xy), porb.ic_angle_plain(imgs, xy))
    blurred = torch.round(pimage.gaussian_blur(imgs, porb.BLUR_KSIZE, porb.BLUR_SIGMA))
    assert torch.equal(
        porb.brief_level(imgs, xy, angle), porb.brief_descriptors_plain(blurred, xy, angle)
    )
    after = (pfast.fast_score_levels.launches, porb.ic_angle_levels.launches,
             porb.brief_levels.launches)
    assert after == before


def test_batched_grid_topk_with_more_streams_than_candidates():
    """select_grid_topk on B streams pads along the candidate axis: with
    more streams (40) than candidates per map (4 cells x 8 = 32) and
    n_out above both, every stream still gets n_out slots, equal to its
    single call and to the reference vmapped over the streams."""
    rng = np.random.default_rng(11)
    b, n_out = 40, 50
    score = rng.integers(0, 4, (b, 40, 40)).astype(np.float32)  # many ties and zeros
    xy, resp, valid = porb.select_grid_topk(torch.from_numpy(score), n_out)
    assert xy.shape == (b, n_out, 2) and resp.shape == valid.shape == (b, n_out)
    ref = jax.vmap(lambda s: jorb.select_grid_topk(s, n_out, cell=32, k_per_cell=8))(
        jnp.asarray(score))
    for got, want in zip((xy, resp, valid), ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(b):
        single = porb.select_grid_topk(torch.from_numpy(score[i]), n_out)
        for got, want in zip((xy, resp, valid), single):
            assert torch.equal(got[i], want), f"stream {i}"


# ------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def replay(small_cfg):
    """The shared view (keyframe 0 of the port's FastTracker with planes and
    lines on, on the corner view: its depth points with their distance
    bounds and keyframe matches, its planes and Manhattan registries, its
    map lines), the reference map holding the same tables, the frames, and
    each stream's first pose.

    bench.py's replay map (max distance 30 m for every point, no keyframe
    matches) tracks no stream of the points-only body: from the initial
    carry a stream has no velocity and the ref-KF descriptor candidate
    has no matches, so no initial pose is accepted.  The view therefore
    comes from the tracker's keyframe rule, and each stream starts at the
    ground-truth pose of its first frame (parallel/replay.py)."""
    pcfg = port_cfg(small_cfg)
    seq = SyntheticSequence(n_frames=N_FRAMES, cam=pcfg.camera, view="corner")
    frames = [seq.frame(i) for i in range(max(OFFSETS) + N_STEPS)]
    view, tracker = preplay.shared_view(pcfg, frames[0], CPU)
    jmap = JaxSlamMap(small_cfg)
    for k in convert.MAP_TABLES:
        getattr(jmap, k)[...] = getattr(tracker.map, k)
    for k in convert.MAP_SCALARS:
        setattr(jmap, k, getattr(tracker.map, k))
    kf = tracker.ref_kf
    view_ref = jdt.set_ref_kf(
        jdt.build_map_view(small_cfg, jmap, tracker.reg2, tracker.reg3), jmap, kf)
    T0 = preplay.start_poses(seq, OFFSETS)
    native = [pdt.to_native(g, d) for _, g, d in frames]
    return pcfg, frames, native, view_ref, view, T0, int(tracker.map.mp_valid.sum())


@pytest.fixture(scope="module")
def replay_runs(small_cfg, replay):
    pcfg, frames, native, view_ref, view, T0, _ = replay
    B = len(OFFSETS)
    ref_step = jmesh.build_throughput_step(small_cfg, B)
    carry_ref = jax.device_get(jmesh.init_batched_carry(small_cfg, B))
    carry_ref["T_last"] = T0
    carry = convert.batched_carry_from_numpy(carry_ref, CPU)
    step = pmesh.build_throughput_step(pcfg, B, CPU)
    outs_ref, outs = [], []
    for i in range(N_STEPS):
        idx = [o + i for o in OFFSETS]
        packed = np.stack([jdt.pack_frame(frames[j][1], frames[j][2]) for j in idx])
        out_ref, carry_ref = ref_step(jnp.asarray(packed), carry_ref, view_ref)
        outs_ref.append(jax.device_get(out_ref))
        out, carry = step(*preplay.step_frames(native, OFFSETS, i, CPU), carry, view)
        outs.append({k: v.numpy() for k, v in out.items()})
    return outs_ref, outs


@pytest.mark.parametrize("stream", range(len(OFFSETS)))
def test_replay_matches_reference_vmapped_body(replay, replay_runs, stream):
    outs_ref, outs = replay_runs
    assert replay[-1] > 100  # the shared view holds a real map
    assert int(replay[4]["ml_valid"].sum()) >= 1  # and map lines
    for i, (ref, out) in enumerate(zip(outs_ref, outs)):
        where = f"step {i}, stream {stream}"
        assert out["T"].shape == (len(OFFSETS), 4, 4)
        d = np.linalg.inv(ref["T"][stream].astype(np.float64)) @ out["T"][stream].astype(np.float64)
        assert np.linalg.norm(d[:3, 3]) < 1e-3, where
        assert rot_angle(d[:3, :3]) < 1e-3, where
        assert bool(out["tracked_ok"][stream]) == bool(ref["tracked_ok"][stream]), where
        assert int(out["n_inliers"][stream]) == int(ref["n_inliers"][stream]), where
        assert bool(out["tracked_ok"][stream]), where
        for k in ("manhattan_found", "use_manhattan"):
            assert bool(out[k][stream]) == bool(ref[k][stream]), (where, k)
        assert bool(out["manhattan_found"][stream]), where  # the view's registries hold
    # the line branch associated frame lines with the view's map lines
    assert sum(int((out["line_assoc"][stream] >= 0).sum()) for out in outs) >= 1


def test_batched_entry_at_b1_equals_single_body(replay):
    """B = 1 through build_throughput_step is the single-stream step (both
    the full body)."""
    pcfg, _, native, _, view, T0, _ = replay
    carry_b = pmesh.init_batched_carry(pcfg, 1, CPU)
    carry_b["T_last"] = torch.from_numpy(T0[:1])
    carry = {k: v[0].clone() for k, v in carry_b.items()}
    step_b = pmesh.build_throughput_step(pcfg, 1, CPU)
    step = pdt.build_frame_step(pcfg, CPU, enable_planes=True, enable_lines=True)
    for i in range(2):
        g8, d16 = preplay.step_frames(native, OFFSETS[:1], i, CPU)
        out_b, carry_b = step_b(g8, d16, carry_b, view)
        res, carry = step(g8[0], d16[0], carry, view)
        for k in pmesh.RESULT_KEYS:
            assert torch.equal(out_b[k][0], res[k]), (i, k)
        for k in carry:
            assert torch.equal(carry_b[k][0], carry[k]), (i, k)


@pytest.mark.parametrize("batch", [1, 2])
def test_kernel_wrappers_called_once_per_level_per_step(replay, monkeypatch, batch):
    """Whatever the number of streams, the FAST, IC angle and BRIEF
    wrappers are each called once per step for all pyramid levels (that
    are large enough for the patch window)."""
    pcfg, _, native, _, view, T0, _ = replay
    calls = {}

    def spy(module, name):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)

    spy(pfast, "fast_score_levels")
    spy(porb, "ic_angle_levels")
    spy(porb, "brief_levels")
    step = pmesh.build_throughput_step(pcfg, batch, CPU)
    carry = pmesh.init_batched_carry(pcfg, batch, CPU)
    first = [OFFSETS[0] + s for s in range(batch)]
    n_steps = 2
    for i in range(n_steps):
        step(*preplay.step_frames(native, first, i, CPU), carry, view)
    assert calls == {"fast_score_levels": n_steps, "ic_angle_levels": n_steps,
                     "brief_levels": n_steps}


def test_throughput_step_rejects_wrong_frames(small_cfg):
    pcfg = port_cfg(small_cfg)
    h, w = pcfg.camera.height, pcfg.camera.width
    step = pmesh.build_throughput_step(pcfg, 2, CPU)
    with pytest.raises(ValueError):  # one stream's frames for two streams
        step(torch.zeros(1, h, w, dtype=torch.uint8), torch.zeros(1, h, w, dtype=torch.int32), None, None)
    with pytest.raises(ValueError):  # frames on another device
        step(torch.zeros(2, h, w, dtype=torch.uint8, device="meta"),
             torch.zeros(2, h, w, dtype=torch.int32, device="meta"), None, None)


def test_convert_reference_batched_carry(small_cfg):
    ref = jax.device_get(jmesh.init_batched_carry(small_cfg, 3))
    conv = convert.batched_carry_from_numpy(ref, CPU)
    out = pmesh.init_batched_carry(port_cfg(small_cfg), 3, CPU)
    assert set(out) == set(conv)
    for k in out:
        assert torch.equal(out[k], conv[k]), k
        assert out[k].shape[0] == 3, k
    with pytest.raises(ValueError):
        convert.batched_carry_from_numpy(jax.device_get(jdt.init_carry(small_cfg)), CPU)


def test_batched_matching_keeps_streams_apart(replay):
    """Two different streams' features matched in one batch give exactly
    what each stream gives alone: frustum compaction, projection matching
    with its scatters and rotation histogram, and descriptor matching.
    Each stream's bank is the shared map plus a temporal block made of the
    OTHER stream's keypoints, so the streams' banks differ."""
    pcfg, _, native, _, view, T0, _ = replay
    feats = build_extractor(pcfg, CPU)(*pdt.frame_to_float(*preplay.step_frames(native, OFFSETS, 0, CPU)))
    B, n_kp = feats["desc"].shape[:2]
    n_map = view["mp_pos"].shape[0]
    T = torch.from_numpy(T0)
    other = {k: v.flip(0) for k, v in feats.items()}
    Twc = se3.inverse(T).flip(0)
    vo = backproject_keypoints(other, pcfg) @ Twc[:, :3, :3].transpose(-1, -2) + Twc[:, None, :3, 3]
    ray = vo - Twc[:, None, :3, 3]
    dist = torch.linalg.norm(ray, dim=-1).clamp(min=1e-6)

    def bank(key, block):
        return torch.cat([view[key].expand((B,) + view[key].shape), block], 1)

    pts = {
        "pos": bank("mp_pos", vo),
        "desc": bank("mp_desc", other["desc"]),
        "valid": bank("mp_valid", other["valid"] & (other["depth"] > 0)),
        "normal": bank("mp_normal", ray / dist[..., None]),
        "min_dist": bank("mp_min", torch.zeros_like(dist)),
        "max_dist": bank("mp_max", dist * 1.2 ** other["level"].float() * 2.0),
        "angle": torch.cat([torch.zeros(B, n_map), other["angle"]], 1),
        "rot_gate": torch.cat([torch.zeros(B, n_map, dtype=torch.bool), other["valid"]], 1),
    }
    K = torch.from_numpy(pcfg.camera.K)
    hw = (pcfg.camera.height, pcfg.camera.width)
    cand = pm.frustum_candidates(pts, T, K, hw, 512, use_scale_gate=True)
    prob, aux = ptops.projection_problem(pts, T, feats, K, 7.0, hw, cand)
    ref = {"pos": pts["pos"][:, n_map:], "desc": other["desc"], "valid": other["valid"]}
    _, idx_c, ok_c = ptops.descriptor_problem(ref, feats, other["angle"])
    assert int(aux["n_matches"].min()) > 20 and int(ok_c.sum(-1).min()) > 10
    for b in range(B):
        def one(tree):
            return {k: v[b] for k, v in tree.items()}

        cand_b = pm.frustum_candidates(one(pts), T[b], K, hw, 512, use_scale_gate=True)
        for k in cand_b:
            assert torch.equal(cand[k][b], cand_b[k]), k
        prob_b, aux_b = ptops.projection_problem(one(pts), T[b], one(feats), K, 7.0, hw, cand_b)
        for f, g in zip(prob, prob_b):
            assert torch.equal(f[b], g[0])
        for k in aux_b:
            assert torch.equal(aux[k][b], aux_b[k]), k
        _, idx_b, ok_b = ptops.descriptor_problem(one(ref), one(feats), other["angle"][b])
        assert torch.equal(ok_c[b], ok_b) and torch.equal(idx_c[b][ok_b], idx_b[ok_b])
