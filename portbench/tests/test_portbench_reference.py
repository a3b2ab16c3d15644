"""The plain reference (portbench/reference) against the port's plain
paths on the CPU, where the port runs its kernels' plain versions: the
same features, planes and lines, bit for bit, on box-room frames."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from manhattanslam_tpu_torch.config import CameraConfig, SlamConfig  # noqa: E402
from manhattanslam_tpu_torch.frontend import frame  # noqa: E402
from manhattanslam_tpu_torch.ops import lines as port_lines  # noqa: E402
from manhattanslam_tpu_torch.ops import planes as port_planes  # noqa: E402
from portbench import common, judge  # noqa: E402
from portbench.reference import lines as ref_lines  # noqa: E402
from portbench.reference import orb as ref_orb  # noqa: E402
from portbench.reference import planes as ref_planes  # noqa: E402
from portbench.scene import poses, render  # noqa: E402


def _frames(w, h, path, idx, seed=2**31 + 5):
    f = w / 640
    cam = render.Camera(fx=525.0 * f, fy=525.0 * f, cx=(w - 1) / 2, cy=(h - 1) / 2,
                        width=w, height=h)
    P = poses.POSE_GENERATORS[path](render.ROOM_SIZE)
    gray, depth = render.render_frames(cam, torch.from_numpy(P[idx]), seed)
    rgb, d = render.to_sensor(gray, depth)
    return cam, judge.sensor_to_float(rgb[..., 0], d)


@pytest.mark.parametrize("path", ["near_corner", "walk"])
def test_orb_equals_port_extractor(path):
    cam, (gray, depth) = _frames(320, 240, path, [4, 90])
    cfg = SlamConfig(camera=CameraConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, k1=0, k2=0,
                                         p1=0, p2=0, k3=0, width=cam.width, height=cam.height))
    port = frame.build_extractor(cfg, "cpu")(gray, depth)
    o = cfg.orb
    ref = ref_orb.extract(gray, dict(n_features=o.n_features, scale_factor=o.scale_factor,
                                     n_levels=o.n_levels, ini_th_fast=o.ini_th_fast,
                                     min_th_fast=o.min_th_fast), cfg.caps.max_keypoints)
    for k, v in ref.items():
        assert torch.equal(port[k], v), k
    assert int(ref["valid"].sum()) > 1000


@pytest.mark.parametrize("path", ["near_corner", "walk"])
def test_planes_and_lines_equal_port_at_tamu_size(path):
    cam, (gray, depth) = _frames(640, 480, path, [3, 60])
    cfg_file = common.load_data("configs", "tamu_slam")
    ref = judge.reference_params(cfg_file)
    K = torch.tensor(ref["K"])
    pl, ln = ref["planes"], ref["lines"]
    args = (depth, K, pl["max_planes"], pl["max_points"], tuple(pl["grid"]), pl["min_support"],
            pl["dist_th"])
    a, b = port_planes.extract_planes_device(*args), ref_planes.extract_planes_device(*args)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(a["valid"].sum()) >= 2
    largs = (ln["max_lines"], ln["mag_th"], ln["min_support"], ln["min_density"],
             ln["min_length"])
    da, db = port_lines.detect_lines(gray, *largs), ref_lines.detect_lines(gray, *largs)
    for k in da:
        assert torch.equal(da[k], db[k]), k
    la = port_lines.lift_lines_3d(depth, K, da["sp"], da["ep"], da["valid"])
    lb = ref_lines.lift_lines_3d(depth, K, db["sp"], db["ep"], db["valid"])
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert int(la["ok"].sum()) >= 20


def test_reference_step_equals_port_step_from_its_state():
    """judge.reference_frames from the port's carry and view after 20
    tracked frames (192x144 near_corner, planes and lines on) against the
    port's own frame step from the same state: the same poses, flags,
    features, planes and lines, bit for bit, over two frames in a row; the
    tally reads every number 0, and a moved pose and a flipped word show."""
    from manhattanslam_tpu_torch.frontend import device_tracker as dt
    from manhattanslam_tpu_torch.system import System
    from portbench.drivers.system import program_config

    torch.set_num_threads(2)
    cfg_file = common.load_data("configs", "tamu_slam")
    w, h = 192, 144
    f = w / 640
    s = dict(cfg_file["settings"], **{"Camera.width": w, "Camera.height": h,
                                      "Camera.fx": 525.0 * f, "Camera.fy": 525.0 * f,
                                      "Camera.cx": (w - 1) / 2, "Camera.cy": (h - 1) / 2})
    cfg_file = dict(cfg_file, settings=s)
    cfg = program_config(cfg_file)
    ref = judge.reference_params(cfg_file)
    cam, _ = _frames(w, h, "near_corner", [0])
    P = poses.near_corner(render.ROOM_SIZE)
    gray, depth = render.render_frames(cam, torch.from_numpy(P[:22]), 9)
    rgb, d16 = render.to_sensor(gray, depth)
    rgb, d16 = rgb.numpy(), d16.numpy().astype(np.uint16)
    system = System(cfg, fast=True, enable_planes=True, enable_lines=True, device="cpu")
    for k in range(20):
        system.track(rgb[k], d16[k], k / 30.0)
    tr = system.tracker
    carry = {k: v.clone() for k, v in tr.carry.items()}
    view = {k: v.clone() for k, v in tr.view.items()}
    frames = [(rgb[k, ..., 0], d16[k]) for k in (20, 21)]
    refs = judge.reference_frames([(g[None], d[None]) for g, d in frames],
                                  {k: v[None] for k, v in carry.items()}, view, ref, "cpu")

    step = dt.build_frame_step(cfg, "cpu", enable_planes=True, enable_lines=True)
    state = carry
    for (g8, d), r in zip(frames, refs):
        out, state = step(torch.from_numpy(g8.copy()),
                          torch.from_numpy(d.astype(np.int32)), state, view)
        port = {**{k: v.numpy() for k, v in out["feats"].items()},
                **{k: v.numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}}
        for k, v in r.items():
            np.testing.assert_array_equal(port[k], v, err_msg=k)
        t = judge.FrameTally()
        t.add(port, r)
        assert all(v == 0 for v in t.numbers().values()), t.numbers()
    assert any(bool(r["use_manhattan"]) for r in refs)
    bad = {k: v.copy() for k, v in refs[1].items()}
    bad["T"][0, 3] += 1e-3
    bad["desc"][int(np.flatnonzero(bad["valid"])[0]), 0] ^= 1
    t = judge.FrameTally()
    t.add(bad, refs[1])
    n = t.numbers()
    assert n["pose_gap_m"] > 0 and n["bits_flipped"] > 0 and n["rot_gap_rad"] == 0
