"""The numbers of the check: what the timed path produced, against the
plain reference and the benchmark's own ground truth.

At the chunks (or frames) of the window that the seed picks, the driver
copies the program's state before the step ran them (the carry and the
map view) and the step's outputs.  After the window, the plain reference
of the step (``reference/track.py``) runs the same sensor frames from
that carry against that view, frame after frame on its own carry, and
each frame's outputs are compared slot by slot:

  ``kp_moved`` (share of keypoint slots whose validity, level or position
  differs), ``score_gap`` (largest FAST score difference), ``angle_gap``
  (largest IC angle difference, rad), ``bits_flipped`` (share of BRIEF
  bits that differ), ``planes_differ`` (plane slots whose validity
  differs), ``plane_gap`` (largest coefficient difference of planes valid
  on both sides), ``lines_differ`` (line slots whose 2D validity or 3D
  lift differs), ``line_gap_m`` (largest endpoint difference of lines
  lifted on both sides, m), ``pose_gap_m`` (largest distance between the
  two camera centres, m), ``rot_gap_rad`` (largest angle between the two
  rotations) and ``flags_differ`` (frames whose tracked, Manhattan-found
  or Manhattan-used flag differs); ``frames_not_compared`` is 1 when no
  frame could be sampled.

Printed beside them, with no limit: ``ate_m``, the absolute trajectory
error of the window's poses against the ground-truth poses the traffic's
generator made (rigid Horn alignment, RMS of the camera centres, as the
TUM benchmark's evaluate_ate without scale).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import counts
from portbench.reference import orb as ref_orb
from portbench.reference import planes as ref_planes
from portbench.reference import track as ref_track

DEPTH_QUANT = 5000.0
FLAGS = ("tracked_ok", "manhattan_found", "use_manhattan")  # compared frame by frame


# ---------------------------------------------------------------- poses
def align_horn(model: np.ndarray, data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rigid R, t minimising |R model + t - data| (evaluate_ate's align
    without scale)."""
    mu_m, mu_d = model.mean(0), data.mean(0)
    U, _, Vt = np.linalg.svd((data - mu_d).T @ (model - mu_m))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_m


def centres(T_cw: np.ndarray) -> np.ndarray:
    """Camera centres (N, 3) of T_cw (N, 4, 4)."""
    T = np.asarray(T_cw, np.float64)
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def ate(pe: np.ndarray, pg: np.ndarray) -> float:
    """RMS of the aligned camera-centre error (N, 3) against the ground
    truth's; nan for fewer than 2 poses."""
    if len(pe) < 2:
        return float("nan")
    R, t = align_horn(pe, pg)
    return float(np.sqrt((((pe @ R.T + t) - pg) ** 2).sum(1).mean()))


# ------------------------------------------------------------ reference
def sensor_to_float(g8: torch.Tensor, d16: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sensor gray and depth units -> float32 gray and metres."""
    return g8.to(torch.float32), d16.to(torch.float32) * float(np.float32(1.0 / DEPTH_QUANT))


def reference_frames(steps: list, carry: dict, view: dict, ref: dict, device,
                     depth_dtype=torch.float32) -> list[dict]:
    """The plain reference of the step over sensor frames, step after
    step: each step (gray8 (B, H, W), depth (B, H, W) in 1/5000 m) for B
    streams, from the program's `carry` (a leading axis of B) before the
    first step and against its map `view`.  Returns each frame's pose,
    flags, features, planes and lines as numpy, step by step and stream
    by stream.  `ref` holds the configuration's numbers
    (``reference_params``); `depth_dtype` is the type the depth in metres
    is held in (the control's bfloat16)."""
    body = ref_track.build_body(ref, device)
    state = {k: v.to(device) for k, v in carry.items()}
    view = {k: v.to(device) for k, v in view.items()}
    out = []
    with torch.no_grad():
        for g8, d16 in steps:
            g = torch.from_numpy(np.ascontiguousarray(g8)).to(device)
            d = torch.from_numpy(np.ascontiguousarray(d16).astype(np.int32)).to(device)
            gray, depth = sensor_to_float(g, d)
            depth = depth.to(depth_dtype).to(torch.float32)
            r = body(gray, depth, state, view)
            state = r.pop("carry")
            host = {k: v.cpu().numpy() for k, v in {**r.pop("feats"), **r}.items()}
            out.extend({k: v[b] for k, v in host.items()} for b in range(g.shape[0]))
    return out


def kernel_least_ms(g8: np.ndarray, ref: dict, device) -> dict:
    """Least ms of one launch of each ORB kernel over the sensor frames g8
    (B, H, W) (one launch serves all B), from the shapes and the
    reference's keypoints on them (portbench/counts.py)."""
    gray = torch.from_numpy(np.ascontiguousarray(g8)).to(device).to(torch.float32)
    active = []
    ref_orb.extract(gray, ref["orb"], ref["max_keypoints"], active)
    pixels = counts.keypoint_pixels(*zip(*active))
    shapes = [tuple(lv.shape[-2:]) for lv, _, _ in active]
    n_kp = g8.shape[0] * sum(xy.shape[-2] for _, xy, _ in active)
    return counts.launch_least_ms(shapes, g8.shape[0], n_kp, pixels)


def mean_least_ms(batches: list, ref: dict, device) -> dict | None:
    """``kernel_least_ms`` of each batch of sensor frames (a launch's
    frames), averaged over the batches: the least ms of the mean launch
    over the frames the traced window handed in; None for no frames."""
    if not batches:
        return None
    each = [kernel_least_ms(g8, ref, device) for g8 in batches]
    return {k: sum(e[k] for e in each) / len(each) for k in each[0]}


def reference_params(cfg_file: dict) -> dict:
    """The reference's numbers, from the configuration file alone."""
    s, d = cfg_file["settings"], cfg_file["defaults"]
    if any(float(s[k]) != 0.0 for k in ("Camera.k1", "Camera.k2", "Camera.p1", "Camera.p2")):
        raise ValueError("the reference of the step takes an undistorted camera")
    w, h = int(s["Camera.width"]), int(s["Camera.height"])
    h2, w2 = h // 2, w // 2
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    info = lambda deg: f32(3282.8 / (float(deg) * float(deg)))  # noqa: E731
    return {
        "orb": {"n_features": int(s["ORBextractor.nFeatures"]),
                "scale_factor": float(s["ORBextractor.scaleFactor"]),
                "n_levels": int(s["ORBextractor.nLevels"]),
                "ini_th_fast": int(s["ORBextractor.iniThFAST"]),
                "min_th_fast": int(s["ORBextractor.minThFAST"])},
        "max_keypoints": int(d["caps.max_keypoints"]),
        "K": [[float(s["Camera.fx"]), 0.0, float(s["Camera.cx"])],
              [0.0, float(s["Camera.fy"]), float(s["Camera.cy"])], [0.0, 0.0, 1.0]],
        "bf": float(s["Camera.bf"]),
        "hw": (h, w),
        "lm": {"angle_info": info(s["Plane.AngleInfo"]),
               "dis_info": f32(float(s["Plane.DistanceInfo"]) ** 2),
               "par_info": info(s["Plane.ParallelInfo"]),
               "ver_info": info(s["Plane.VerticalInfo"]),
               "plane_chi": f32(s["Plane.Chi"]), "vp_chi": f32(s["Plane.VPChi"])},
        "planes": {"max_planes": int(d["caps.max_planes_frame"]),
                   "max_points": int(d["caps.max_plane_points"]),
                   "grid": (h2 // ref_planes.BLOCK, w2 // ref_planes.BLOCK),
                   "min_support": float(np.float32(0.04 * h2 * w2)),
                   "dist_th": float(np.float32(s["Plane.DistanceThreshold"])),
                   "ang_ref": float(s["Plane.AssociationAngRef"]),
                   "dis_ref": float(s["Plane.AssociationDisRef"]),
                   "ver_th": float(s["Plane.VerticalThreshold"]),
                   "par_th": float(s["Plane.ParallelThreshold"]),
                   "mf_ver_th": float(s["Plane.MFVerticalThreshold"])},
        "lines": {"max_lines": int(d["caps.max_lines"]),
                  "mag_th": float(d["line.mag_threshold"]),
                  "min_support": float(d["line.min_support"]),
                  "min_density": float(d["line.min_density"]),
                  "min_length": float(d["line.min_length"]),
                  "assoc_mid_px": float(d["line.assoc_mid_px"]),
                  "assoc_ang_deg": float(d["line.assoc_ang_deg"])},
    }


# ------------------------------------------------------------- compare
class FrameTally:
    """Slot-by-slot differences of sampled frames, summed.  Every frame's
    pose and flags are compared; its features, planes and lines where the
    program's output holds them (a step that returns only poses and
    flags reports only those numbers)."""

    def __init__(self):
        self.frames = 0
        self.parts = set()  # what the program's outputs held: "feats", "planes", "lines"
        self.slots = self.moved = 0
        self.bits = self.flipped = 0
        self.score_gap = self.angle_gap = 0.0
        self.planes_differ = self.lines_differ = 0
        self.plane_gap = self.line_gap = 0.0
        self.pose_gap = self.rot_gap = 0.0
        self.flags_differ = 0

    def add(self, prog: dict, ref: dict) -> None:
        self.frames += 1
        Tp, Tr = np.asarray(prog["T"], np.float64), np.asarray(ref["T"], np.float64)
        self.pose_gap = max(self.pose_gap, float(np.linalg.norm(
            centres(Tp[None])[0] - centres(Tr[None])[0])))
        # the rotation angle between the two, from |Rp - Rr|_F = 2 sqrt(2) sin(angle / 2)
        # (0 for equal matrices, unlike the arccos of the trace)
        chord = np.linalg.norm(Tp[:3, :3] - Tr[:3, :3]) / (2.0 * np.sqrt(2.0))
        self.rot_gap = max(self.rot_gap, float(2.0 * np.arcsin(min(chord, 1.0))))
        self.flags_differ += int(any(bool(prog[k]) != bool(ref[k]) for k in FLAGS))
        if "valid" in prog:
            self._add_feats(prog, ref)
        if "plane_valid" in prog:
            self._add_planes(prog, ref)
        if "line_valid" in prog:
            self._add_lines(prog, ref)

    def _add_feats(self, prog: dict, ref: dict) -> None:
        self.parts.add("feats")
        pv, rv = prog["valid"].astype(bool), ref["valid"].astype(bool)
        same = ((pv == rv) & (prog["level"] == ref["level"])
                & np.all(prog["xy"] == ref["xy"], -1))
        either = pv | rv
        self.slots += int(either.sum())
        self.moved += int((either & ~same).sum())
        both = pv & rv & same
        if both.any():
            self.score_gap = max(self.score_gap, float(
                np.abs(prog["response"][both] - ref["response"][both]).max()))
            dang = np.remainder(prog["angle"][both] - ref["angle"][both] + np.pi, 2 * np.pi) - np.pi
            self.angle_gap = max(self.angle_gap, float(np.abs(dang).max()))
            x = np.bitwise_xor(prog["desc"][both].astype(np.int64) & 0xFFFFFFFF,
                               ref["desc"][both].astype(np.int64) & 0xFFFFFFFF)
            self.flipped += int(sum(bin(int(v)).count("1") for v in x.reshape(-1)))
            self.bits += int(both.sum()) * 256

    def _add_planes(self, prog: dict, ref: dict) -> None:
        self.parts.add("planes")
        ppl, rpl = prog["plane_valid"].astype(bool), ref["plane_valid"].astype(bool)
        self.planes_differ += int((ppl != rpl).sum())
        if (ppl & rpl).any():
            self.plane_gap = max(self.plane_gap, float(np.abs(
                prog["plane_coeffs"][ppl & rpl] - ref["plane_coeffs"][ppl & rpl]).max()))

    def _add_lines(self, prog: dict, ref: dict) -> None:
        self.parts.add("lines")
        plv, rlv = prog["line_valid"].astype(bool), ref["line_valid"].astype(bool)
        p3, r3 = prog["line_has3d"].astype(bool), ref["line_has3d"].astype(bool)
        self.lines_differ += int(((plv != rlv) | (p3 != r3)).sum())
        if (p3 & r3).any():
            gap = max(np.abs(prog[k][p3 & r3] - ref[k][p3 & r3]).max()
                      for k in ("line_sp3", "line_ep3"))
            self.line_gap = max(self.line_gap, float(gap))

    def numbers(self) -> dict:
        out = {"pose_gap_m": self.pose_gap, "rot_gap_rad": self.rot_gap,
               "flags_differ": float(self.flags_differ)}
        if "feats" in self.parts:
            out.update({"kp_moved": self.moved / max(self.slots, 1),
                        "score_gap": self.score_gap, "angle_gap": self.angle_gap,
                        "bits_flipped": self.flipped / max(self.bits, 1)})
        if "planes" in self.parts:
            out.update({"planes_differ": float(self.planes_differ), "plane_gap": self.plane_gap})
        if "lines" in self.parts:
            out.update({"lines_differ": float(self.lines_differ), "line_gap_m": self.line_gap})
        return out


def tally_numbers(tally: FrameTally) -> dict:
    """A tally's numbers with the count of frames compared, and the guard
    ``frames_not_compared`` (1 when there were none)."""
    return {"compared_frames": float(tally.frames),
            "frames_not_compared": 0.0 if tally.frames else 1.0, **tally.numbers()}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """correct when every limited number is a finite number within its
    limit; returns (correct, {name: {"value", "limit"}}) in the limits'
    order."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = float(numbers.get(name, float("nan")))
        finite = bool(np.isfinite(value))
        checks[name] = {"value": value if finite else None, "limit": limit}
        ok = ok and finite and value <= limit
    return ok, checks
