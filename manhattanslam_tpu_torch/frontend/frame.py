"""Per-frame ORB feature extraction (counterpart of
manhattanslam_tpu/frontend/frame.py).

In stage order: pyramid -> dense FAST (ONE kernel launch for every level)
-> per level the cell threshold fallback, 3x3 NMS and grid top-K -> IC
angle (ONE kernel launch for every level's keypoints, level-major) ->
steered BRIEF (ONE kernel launch for every level's keypoints, the
integer-rounded blur inside it), then keypoint undistortion, per-keypoint
depth and the virtual right-image coordinate uR = u - bf/d
(ComputeStereoFromRGBD).

The output is a dict of (max_keypoints,)-shaped tensors with a validity
mask, exactly the reference's frame-feature layout.  Every function also
takes B streams' frames (B, H, W) and then returns (B, max_keypoints, ...)
features, as the reference's vmapped replay does; every kernel launch
serves all B streams.
"""

from __future__ import annotations

import torch

from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.ops import fast as fast_ops
from manhattanslam_tpu_torch.ops import image as image_ops
from manhattanslam_tpu_torch.ops import orb as orb_ops


def undistort_points(xy: torch.Tensor, cfg: SlamConfig) -> torch.Tensor:
    """Iterative inverse of the radial-tangential model (cv::undistortPoints).

    xy: (..., N, 2) pixel coords in the distorted image -> undistorted pixels.
    """
    cam = cfg.camera
    if not cam.has_distortion:
        return xy
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    k1, k2, k3, p1, p2 = cam.k1, cam.k2, cam.k3, cam.p1, cam.p2
    xd = (xy[..., 0] - cx) / fx
    yd = (xy[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(8):
        r2 = x * x + y * y
        k = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / k
        y = (yd - dy) / k
    return torch.stack([x * fx + cx, y * fy + cy], -1)


def active_levels(cfg: SlamConfig) -> list[int]:
    """The pyramid levels large enough for the 31x31 patch window: the
    others get no keypoints (and no kernel reads them)."""
    shapes = image_ops.pyramid_shapes(
        cfg.camera.height, cfg.camera.width, cfg.orb.n_levels, cfg.orb.scale_factor)
    return [li for li, hw in enumerate(shapes) if min(hw) >= 2 * orb_ops.EDGE_THRESHOLD + 3]


def keypoints_from_score(
    score: torch.Tensor, n_out: int, cfg: SlamConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A level's FAST score map (..., H, W) through the per-cell fallback
    and NMS, kept off the EDGE_THRESHOLD border, then the grid top-K:
    (xy, response, valid)."""
    h, w = score.shape[-2:]
    corners = fast_ops.threshold_nms(
        score, cell=30, ini_th=cfg.orb.ini_th_fast, min_th=cfg.orb.min_th_fast
    )
    # keep-out border so the orientation/descriptor patch reads are valid
    b = orb_ops.EDGE_THRESHOLD
    inner = torch.zeros_like(corners)
    inner[..., b : h - b, b : w - b] = corners[..., b : h - b, b : w - b]
    k_per_cell = max(2, min(8, (4 * n_out) // max((h // 32) * (w // 32), 1) + 1))
    return orb_ops.select_grid_topk(inner, n_out, cell=32, k_per_cell=k_per_cell)


def _extract_levels(level_imgs: list[torch.Tensor], budgets: list[int], cfg: SlamConfig) -> list[dict]:
    """Oriented, described keypoints of pyramid levels (..., H_l, W_l),
    budgets[l] of each, all large enough for the patch window: one FAST
    launch for all levels, per level the fallback, NMS and top-K, then one
    IC angle and one BRIEF launch for all levels' keypoints (level-major;
    BRIEF blurs the raw levels itself)."""
    lead = level_imgs[0].shape[:-2]
    scores = fast_ops.fast_score_levels(level_imgs)
    kps = [keypoints_from_score(sc, n, cfg) for sc, n in zip(scores, budgets)]
    xy_flat = torch.cat([xy.reshape(-1, 2) for xy, _, _ in kps])
    angle_flat = orb_ops.ic_angle_levels(level_imgs, xy_flat, budgets)
    desc_flat = orb_ops.brief_levels(level_imgs, xy_flat, angle_flat, budgets)
    return [
        {"xy": xy, "response": resp, "valid": valid, "angle": angle, "desc": desc}
        for (xy, resp, valid), angle, desc in zip(
            kps, orb_ops.level_keypoint_views(angle_flat, budgets, lead),
            orb_ops.level_keypoint_views(desc_flat, budgets, lead))
    ]


def _empty_level(lead, n_out: int, dev) -> dict:
    """The features of a level too small for the patch window: none."""
    return {
        "xy": torch.zeros(lead + (n_out, 2), device=dev),
        "response": torch.zeros(lead + (n_out,), device=dev),
        "valid": torch.zeros(lead + (n_out,), dtype=torch.bool, device=dev),
        "angle": torch.zeros(lead + (n_out,), device=dev),
        "desc": torch.zeros(lead + (n_out, 8), dtype=torch.int32, device=dev),
    }


def _extract_level(level_img: torch.Tensor, n_out: int, cfg: SlamConfig) -> dict:
    """Extract n_out oriented, described keypoints from one pyramid level
    (..., H, W)."""
    if min(level_img.shape[-2:]) < 2 * orb_ops.EDGE_THRESHOLD + 3:
        return _empty_level(level_img.shape[:-2], n_out, level_img.device)
    return _extract_levels([level_img], [n_out], cfg)[0]


def build_extractor(cfg: SlamConfig, device: torch.device):
    """Returns extract(gray, depth) -> frame-features dict on `device`.

    gray: (H, W) float32 [0,255]; depth: (H, W) float32 meters (0 invalid);
    or (B, H, W) each for B streams, giving (B, max_keypoints, ...) features.
    """
    n_levels = cfg.orb.n_levels
    scale = cfg.orb.scale_factor
    budgets = cfg.orb.features_per_level()
    cap = cfg.caps.max_keypoints
    H, W = cfg.camera.height, cfg.camera.width
    bf = cfg.camera.bf
    operators = image_ops.pyramid_operators(H, W, n_levels, scale, device)
    active = active_levels(cfg)
    level_ids = [
        torch.full((budgets[li],), li, dtype=torch.int32, device=device)
        for li in range(n_levels)
    ]

    def extract(gray: torch.Tensor, depth: torch.Tensor) -> dict:
        lead = gray.shape[:-2]
        kp_axis = len(lead)  # the keypoint axis of every feature
        levels = image_ops.build_pyramid(gray, operators)
        found = dict(zip(active, _extract_levels(
            [levels[li] for li in active], [budgets[li] for li in active], cfg))) if active else {}
        parts = []
        for li in range(n_levels):
            out = found[li] if li in found else _empty_level(lead, budgets[li], device)
            out["xy"] = out["xy"] * float(scale**li)  # level-0 (distorted) pixels
            out["level"] = level_ids[li].expand(lead + (-1,))
            parts.append(out)
        feats = {k: torch.cat([p[k] for p in parts], dim=kp_axis) for k in parts[0]}
        n = feats["xy"].shape[kp_axis]
        if n < cap:  # pad to capacity
            feats = {
                k: torch.cat([v, v.new_zeros(lead + (cap - n,) + v.shape[kp_axis + 1 :])], kp_axis)
                for k, v in feats.items()
            }
        feats = {k: v.narrow(kp_axis, 0, cap) for k, v in feats.items()}

        # depth lookup at the detected (distorted) position
        xi = torch.clamp(torch.round(feats["xy"][..., 0]).to(torch.int64), 0, W - 1)
        yi = torch.clamp(torch.round(feats["xy"][..., 1]).to(torch.int64), 0, H - 1)
        d = orb_ops.gather_pixels(depth, yi * W + xi)
        feats["depth"] = torch.where(feats["valid"], d, torch.zeros_like(d))
        feats["xy_und"] = undistort_points(feats["xy"], cfg)
        # virtual right-image u (ComputeStereoFromRGBD): uR = u - bf/d
        feats["u_right"] = torch.where(
            d > 0,
            feats["xy_und"][..., 0] - bf / torch.clamp(d, min=1e-6),
            torch.full_like(d, -1.0),
        )
        # scale-sigma info per keypoint (LM information weights)
        feats["inv_sigma2"] = 1.0 / torch.pow(scale, 2.0 * feats["level"].to(torch.float32))
        return feats

    return extract


def backproject_keypoints(feats: dict, cfg: SlamConfig) -> torch.Tensor:
    """Camera-frame 3D points for keypoints with valid depth (else zeros)
    (Frame::UnprojectStereo)."""
    cam = cfg.camera
    d = feats["depth"]
    x = (feats["xy_und"][..., 0] - cam.cx) / cam.fx * d
    y = (feats["xy_und"][..., 1] - cam.cy) / cam.fy * d
    pts = torch.stack([x, y, d], -1)
    return torch.where((d > 0)[..., None], pts, torch.zeros_like(pts))
