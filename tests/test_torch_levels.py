"""All-level kernel entry points (``fast_score_levels``, ``ic_angle_levels``,
``brief_levels``) and the stage-ordered extractor, on the CPU at small_cfg
size.

On the CPU the entry points run their plain versions, so FAST is compared
exactly with the JAX reference (the jnp formulation and the Pallas kernel
in interpret mode), IC angle within 1e-4 rad (float32 moments in
another order) and BRIEF words exactly wherever the two integer-rounded
blurs agree at the keypoint's samples (XLA and torch sum the blur's
float32 taps differently by ulps, which can move a pixel across .5).
The level tables that the wrappers hand the CUDA kernels are built here
in Python: each tile and keypoint must fall in exactly one slot; BRIEF's
window radius and border map are checked against the pattern and
``F.pad``.  The extractor must give what one level at a time gave before.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from manhattanslam_tpu.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu.ops import fast as jfast
from manhattanslam_tpu.ops import image as jimage
from manhattanslam_tpu.ops import orb as jorb
from manhattanslam_tpu.ops.fast_pallas import fast_score_map_pallas
from manhattanslam_tpu.ops.orb_pallas import ic_angle_pallas
from manhattanslam_tpu_torch.frontend import frame as pframe
from manhattanslam_tpu_torch.ops import fast as pfast
from manhattanslam_tpu_torch.ops import image as pimage
from manhattanslam_tpu_torch.ops import kernel_build
from manhattanslam_tpu_torch.ops import orb as porb
from torch_parity import port_cfg

ANGLE_TOL = 1e-4
CSRC = Path(pfast.__file__).resolve().parent.parent / "csrc"


def _wrapped(a, b):
    return np.abs(np.remainder(a - b + np.pi, 2 * np.pi) - np.pi)


@pytest.fixture(scope="module")
def rendered(small_cfg):
    """Two rendered box-room frames (gray rounded like the tracker's u8
    upload) and their reference pyramids, with the active levels."""
    seq = SyntheticSequence(n_frames=4, cam=small_cfg.camera)
    frames = [np.round(seq.frame(i)[1]).astype(np.float32) for i in (1, 3)]
    pyramids = [
        [np.array(x) for x in jimage.build_pyramid(jnp.asarray(g), small_cfg.orb.n_levels,
                                                   small_cfg.orb.scale_factor)]
        for g in frames
    ]
    cfg = port_cfg(small_cfg)
    return cfg, frames, pyramids, pframe.active_levels(cfg)


def _stacked_levels(pyramids, active, b):
    """The active levels of the first b pyramids as (b, h, w) tensors, or
    (h, w) for b = 1."""
    if b == 1:
        return [torch.from_numpy(pyramids[0][li]) for li in active]
    return [torch.from_numpy(np.stack([p[li] for p in pyramids[:b]])) for li in active]


def test_small_cfg_drops_the_coarsest_level(rendered):
    cfg, _, pyramids, active = rendered
    assert active == [li for li, lv in enumerate(pyramids[0]) if min(lv.shape) >= 41]
    assert len(active) < cfg.orb.n_levels


@pytest.mark.parametrize("b", [1, 2])
def test_fast_score_levels_exact_vs_jnp_and_pallas(rendered, b):
    """Every active level of the reference pyramid, in one level-major
    buffer: equal to the jnp score and the Pallas kernel (interpret)."""
    _, _, pyramids, active = rendered
    levels = _stacked_levels(pyramids, active, b)
    before = pfast.fast_score_levels.launches
    scores = pfast.fast_score_levels(levels)
    assert pfast.fast_score_levels.launches == before  # the CPU launches nothing
    base = scores[0].data_ptr()
    offset = 0
    for li, lv, sc in zip(active, levels, scores):
        assert sc.shape == lv.shape and sc.is_contiguous()
        assert sc.data_ptr() == base + 4 * offset  # level-major, no gaps
        offset += lv.numel()
        for i in range(b):
            img = jnp.asarray(pyramids[i][li])
            got = sc.numpy() if b == 1 else sc[i].numpy()
            np.testing.assert_array_equal(got, np.asarray(jfast.fast_score_map(img)))
            np.testing.assert_array_equal(
                got, np.asarray(fast_score_map_pallas(img, interpret=True)))


@pytest.mark.parametrize("b", [1, 2])
def test_ic_angle_levels_vs_reference(rendered, b):
    """Every active level's keypoints (as the extractor picks them) in one
    level-major buffer: within 1e-4 rad of the Pallas kernel (interpret)
    where its patch window fits, else of the jnp reference (narrow rows,
    where its prefix sums do not cancel)."""
    cfg, _, pyramids, active = rendered
    levels = _stacked_levels(pyramids, active, b)
    budgets = [cfg.orb.features_per_level()[li] for li in active]
    kps = [pframe.keypoints_from_score(sc, n, cfg)
           for sc, n in zip(pfast.fast_score_levels(levels), budgets)]
    xy_flat = torch.cat([xy.reshape(-1, 2) for xy, _, _ in kps])
    ang = porb.ic_angle_levels(levels, xy_flat, budgets)
    assert ang.shape == (xy_flat.shape[0],)
    lead = (b,) if b > 1 else ()
    views = porb.level_keypoint_views(ang, budgets, lead)
    for li, (xy, _, valid), a in zip(active, kps, views):
        assert a.is_contiguous() and a.shape == lead + (xy.shape[-2],)
        for i in range(b):
            img = jnp.asarray(pyramids[i][li])
            xy_i = jnp.asarray((xy if b == 1 else xy[i]).numpy())
            v = (valid if b == 1 else valid[i]).numpy()
            got = (a if b == 1 else a[i]).numpy()
            h, w = img.shape
            if h >= 56 and w >= 128:  # the Pallas kernel's patch window
                ref = np.asarray(ic_angle_pallas(img, xy_i, interpret=True))
            else:
                ref = np.asarray(jorb.ic_angle(img, xy_i))
            assert v.any()
            assert _wrapped(got[v], ref[v]).max() < ANGLE_TOL, li


def _locate_tile(table, idx):
    """Flat tile idx -> (level, image, tile row, tile column), as
    csrc/fast.cu's kernel finds it."""
    starts = table["tile_start"]
    lvl = max(j for j in range(len(starts) - 1) if idx >= starts[j])
    r = idx - starts[lvl]
    img, q = divmod(r, table["tiles_img"][lvl])
    ty, tx = divmod(q, table["tiles_x"][lvl])
    return lvl, img, ty, tx


TUM1_SHAPES = pimage.pyramid_shapes(480, 640, 8, 1.2)
SMALL_ACTIVE = [s for s in pimage.pyramid_shapes(144, 192, 8, 1.2) if min(s) >= 41]


@pytest.mark.parametrize("shapes,b", [(TUM1_SHAPES, 1), (TUM1_SHAPES, 8), (SMALL_ACTIVE, 2),
                                      ([(41, 45), (33, 70), (64, 64)], 3)])
def test_fast_tile_table_covers_every_pixel_once(shapes, b):
    """Every tile of every level and image exactly once, and the tiles of a
    level cover each of its pixels exactly once."""
    table = pfast.fast_tile_table(shapes, b)
    th, tw = pfast.TILE
    seen = {}
    for idx in range(table["tile_start"][-1]):
        key = _locate_tile(table, idx)
        assert key not in seen
        seen[key] = idx
    for lvl, (h, w) in enumerate(shapes):
        cover = np.zeros((b, h, w), int)
        for (l2, img, ty, tx) in seen:
            if l2 == lvl:
                assert ty * th < h and tx * tw < w
                cover[img, ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] += 1
        assert (cover == 1).all(), lvl


SMALL_BUDGETS = [54, 45, 38, 31, 26, 22, 18]


@pytest.mark.parametrize("budgets,b", [(SMALL_BUDGETS, 1), (SMALL_BUDGETS, 2), ([217, 180, 3], 8),
                                       ([5], 1)])
def test_keypoint_layout_covers_every_keypoint_once(budgets, b):
    """The level-major layout [level][B][n_l]: each level's view is
    contiguous and holds its own keypoints, every slot in exactly one view,
    and the prefix puts flat keypoint k in the right level and image."""
    starts = porb.keypoint_starts(budgets, b)
    flat = torch.arange(starts[-1])
    lead = (b,) if b > 1 else ()
    views = porb.level_keypoint_views(flat, budgets, lead)
    assert torch.equal(torch.sort(torch.cat([v.reshape(-1) for v in views])).values, flat)
    for lvl, (v, n) in enumerate(zip(views, budgets)):
        assert v.is_contiguous() and v.shape == lead + (n,)
        for k in v.reshape(-1).tolist():  # as csrc/ic_angle.cu finds keypoint k
            assert max(j for j in range(len(budgets)) if k >= starts[j]) == lvl
            img = (k - starts[lvl]) // n
            assert (v[img] if b > 1 else v)[(k - starts[lvl]) % n] == k
    xy = torch.stack([flat, -flat], -1).float()
    for v, xv in zip(views, porb.level_keypoint_views(xy, budgets, lead)):
        assert xv.shape == v.shape + (2,) and torch.equal(xv[..., 0], v.float())


def test_kernel_constants_match_the_wrappers():
    """The tile shape of csrc/fast.cu is the one fast_tile_table assumes,
    and IC_ROW_EXTENT is the circular patch by columns."""
    src = (CSRC / "fast.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert pfast.TILE == (const["kTY"] * const["kStrip"], const["kTW"])
    assert const["kMaxLevels"] == kernel_build.MAX_LEVELS
    r = porb.HALF_PATCH
    dy = np.arange(-r, r + 1)
    for dx in range(-r, r + 1):
        col = porb.CIRC_MASK[:, dx + r]
        np.testing.assert_array_equal(col, np.abs(dy) <= porb.IC_ROW_EXTENT[abs(dx)])


@pytest.fixture(scope="module")
def level_keypoints(rendered):
    """For 1 and 2 streams: the active levels, their budgets, and the
    extractor's keypoints (per level) and IC angles, level-major."""
    cfg, _, pyramids, active = rendered
    budgets = [cfg.orb.features_per_level()[li] for li in active]
    out = {}
    for b in (1, 2):
        levels = _stacked_levels(pyramids, active, b)
        kps = [pframe.keypoints_from_score(sc, n, cfg)
               for sc, n in zip(pfast.fast_score_levels(levels), budgets)]
        xy_flat = torch.cat([xy.reshape(-1, 2) for xy, _, _ in kps])
        out[b] = (levels, budgets, [xy for xy, _, _ in kps], xy_flat,
                  porb.ic_angle_levels(levels, xy_flat, budgets))
    return out


@pytest.mark.parametrize("b", [1, 2])
def test_brief_levels_equals_per_level_composition(rendered, level_keypoints, b):
    """One level-major call for every active level on the CPU: per level
    the integer-rounded blur and brief_descriptors_plain, and the same as
    the one-level form, in the (B, n_l, 8) view of each level."""
    active = rendered[3]
    levels, budgets, kps, xy_flat, ang = level_keypoints[b]
    before = porb.brief_levels.launches
    words = porb.brief_levels(levels, xy_flat, ang, budgets)
    assert porb.brief_levels.launches == before  # the CPU launches nothing
    assert words.shape == (xy_flat.shape[0], 8) and words.dtype == torch.int32
    lead = (b,) if b > 1 else ()
    for li, lv, xy, a, d in zip(active, levels, kps,
                                porb.level_keypoint_views(ang, budgets, lead),
                                porb.level_keypoint_views(words, budgets, lead)):
        assert d.is_contiguous() and d.shape == lead + (xy.shape[-2], 8)
        blurred = torch.round(pimage.gaussian_blur(lv, 7, 2.0))
        assert torch.equal(d, porb.brief_descriptors_plain(blurred, xy, a)), li
        assert torch.equal(d, porb.brief_level(lv, xy, a)), li


BLUR_TOL = 1e-3  # share of blurred pixels XLA and torch may round apart (test_torch_frame.py)
_jit_brief = jax.jit(jorb.brief_descriptors)  # one compile per level shape, not one per op


def test_brief_levels_vs_reference(rendered, level_keypoints):
    """Every active level against the JAX reference's rounded blur and
    brief_descriptors at the same keypoints and angles: equal words at
    every keypoint whose sampled blurred pixels agree between the two
    blurs.  The blurs themselves differ by at most 1 at under 1e-3 of the
    pixels (ulps of float32 tap sums); keypoints whose samples touch such
    a pixel are counted in the message, not compared, and are under a
    tenth of them."""
    active = rendered[3]
    levels, budgets, kps, xy_flat, ang = level_keypoints[1]
    words = porb.brief_levels(levels, xy_flat, ang, budgets)
    compared = skipped = 0
    for li, lv, xy, a, d in zip(active, levels, kps,
                                porb.level_keypoint_views(ang, budgets, ()),
                                porb.level_keypoint_views(words, budgets, ())):
        ref_blur = np.round(np.asarray(jimage.gaussian_blur(jnp.asarray(lv.numpy()), 7, 2.0)))
        ref = np.asarray(_jit_brief(jnp.asarray(ref_blur), jnp.asarray(xy.numpy()),
                                    jnp.asarray(a.numpy())))
        blurred = torch.round(pimage.gaussian_blur(lv, 7, 2.0)).numpy()
        moved = blurred != ref_blur
        assert np.abs(blurred - ref_blur).max() <= 1.0 and moved.mean() < BLUR_TOL, li
        h, w = lv.shape
        idx = porb.brief_sample_index(xy, torch.cos(a), torch.sin(a), h, w).numpy()
        touched = moved.reshape(-1)[idx].any(axis=(-2, -1))
        np.testing.assert_array_equal(d.numpy().view(np.uint32)[~touched], ref[~touched],
                                      err_msg=f"level {li}")
        compared += int((~touched).sum())
        skipped += int(touched.sum())
    assert compared >= 0.9 * (compared + skipped), (
        f"{skipped} keypoints sample a pixel the two blurs round apart, {compared} compared")


def _kernel_sample_offsets(xy, angle):
    """Each rotated, rounded sample of PATTERN minus the floor of its
    keypoint, in the arithmetic of brief_sample_index without the clip:
    (N, 256, 2, 2) as (x, y)."""
    pat = torch.from_numpy(porb.PATTERN).float()
    py, px = pat[..., 0], pat[..., 1]
    c, s = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    sx = torch.round(xy[:, 0, None, None] + (px * c - py * s)) - torch.floor(xy[:, 0, None, None])
    sy = torch.round(xy[:, 1, None, None] + (px * s + py * c)) - torch.floor(xy[:, 1, None, None])
    return torch.stack([sx, sy], -1)


def test_brief_samples_lie_within_the_kernel_window():
    """At 4096 angles and sub-pixel keypoints every sample lies within
    BRIEF_SAMPLE_RADIUS (14) of the keypoint's floor, the window that
    csrc/brief.cu blurs; at integer keypoints 13 is reached."""
    n = 4096
    angle = torch.linspace(-np.pi, np.pi, n + 1)[:-1]
    rng = np.random.default_rng(4)
    for frac in (np.zeros((n, 2)), rng.uniform(0, 1, (n, 2)), np.full((n, 2), 0.5),
                 np.full((n, 2), 0.999)):
        xy = torch.from_numpy((np.float32(200.0) + frac).astype(np.float32))
        off = _kernel_sample_offsets(xy, angle).abs().max()
        assert off <= porb.BRIEF_SAMPLE_RADIUS, frac[0]
    assert porb.BRIEF_SAMPLE_RADIUS == 14
    assert _kernel_sample_offsets(torch.full((n, 2), 200.0), angle).abs().max() == 13


def _reflect101(i, n):
    """csrc/brief.cu reflect101, as written there."""
    i = -i if i < 0 else i
    i = 2 * (n - 1) - i if i >= n else i
    return min(max(i, 0), n - 1)


@pytest.mark.parametrize("n", [4, 5, 9, 31])
def test_reflect101_index_map_equals_f_pad(n):
    """The kernel's border map at the blur's radius equals F.pad(mode=
    "reflect") of a row of n pixels, on both sides."""
    r = porb.BLUR_KSIZE // 2
    row = torch.arange(n, dtype=torch.float32).reshape(1, 1, 1, n)
    padded = F.pad(row, (r, r, 0, 0), mode="reflect").reshape(-1).tolist()
    assert [_reflect101(i, n) for i in range(-r, n + r)] == padded


def test_brief_kernel_constants_match_the_wrapper():
    """csrc/brief.cu's window and tap constants are the Python side's, and
    its padded blurred window (bands of rows, runs of columns) covers the
    29x29 pixels within the sample radius."""
    src = (CSRC / "brief.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kSampleR"] == porb.BRIEF_SAMPLE_RADIUS
    for size, part in (("kRows", "kBand"), ("kCols", "kRun")):
        assert const[size] % const[part] == 0
        side = 2 * porb.BRIEF_SAMPLE_RADIUS + 1
        assert side <= const[size] < side + const[part]
    assert const["kTaps"] == porb.BLUR_KSIZE == len(pimage.gauss_kernel1d(7, 2.0))
    assert const["kMaxLevels"] == kernel_build.MAX_LEVELS
    assert {porb.brief_threads(b) for b in (1, 2, 8)} == {32, const["kBlock"]}


def _per_level_composition(level_img, n_out, cfg):
    """One level at a time, as the extractor composed it before the
    all-level launches, from the plain functions: FAST corners, border,
    grid top-K, IC angle, rounded blur and BRIEF."""
    h, w = level_img.shape[-2:]
    lead = level_img.shape[:-2]
    if min(h, w) < 2 * porb.EDGE_THRESHOLD + 3:
        return {"xy": torch.zeros(lead + (n_out, 2)), "response": torch.zeros(lead + (n_out,)),
                "valid": torch.zeros(lead + (n_out,), dtype=torch.bool),
                "angle": torch.zeros(lead + (n_out,)),
                "desc": torch.zeros(lead + (n_out, 8), dtype=torch.int32)}
    score = pfast.fast_corners(level_img, cell=30, ini_th=cfg.orb.ini_th_fast,
                               min_th=cfg.orb.min_th_fast)
    e = porb.EDGE_THRESHOLD
    inner = torch.zeros_like(score)
    inner[..., e:h - e, e:w - e] = score[..., e:h - e, e:w - e]
    k_per_cell = max(2, min(8, (4 * n_out) // max((h // 32) * (w // 32), 1) + 1))
    xy, resp, valid = porb.select_grid_topk(inner, n_out, cell=32, k_per_cell=k_per_cell)
    angle = porb.ic_angle_plain(level_img, xy)
    blurred = torch.round(pimage.gaussian_blur(level_img, 7, 2.0))
    desc = porb.brief_descriptors_plain(blurred, xy, angle)
    return {"xy": xy, "response": resp, "valid": valid, "angle": angle, "desc": desc}


@pytest.mark.parametrize("b", [1, 2])
def test_extractor_equals_per_level_composition(rendered, b):
    """The stage-ordered extractor on the CPU gives, level by level, the
    features of the per-level composition, for one frame and two streams."""
    cfg, frames, _, _ = rendered
    gray = torch.from_numpy(frames[0] if b == 1 else np.stack(frames[:b]))
    depth = torch.ones_like(gray)
    feats = pframe.build_extractor(cfg, torch.device("cpu"))(gray, depth)
    ops = pimage.pyramid_operators(cfg.camera.height, cfg.camera.width, cfg.orb.n_levels,
                                   cfg.orb.scale_factor, "cpu")
    levels = pimage.build_pyramid(gray, ops)
    kp_axis = gray.dim() - 2
    start = 0
    for li, n in enumerate(cfg.orb.features_per_level()):
        ref = _per_level_composition(levels[li], n, cfg)
        ref["xy"] = ref["xy"] * float(cfg.orb.scale_factor ** li)
        for k, v in ref.items():
            assert torch.equal(feats[k].narrow(kp_axis, start, n), v), (li, k)
        start += n
