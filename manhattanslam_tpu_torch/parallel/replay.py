"""The replay traffic over the synthetic box room: the shared map view, each
stream's start, each step's frames.  chip_smoke.py, tools/profile_torch_track.py
and the replay tests all drive ``build_throughput_step`` through these, so
their numbers come from the same traffic.

The shared view is keyframe 0 of the port's tracker with planes and lines
on: frame 0's depth points with their distance bounds, its keypoint
matches for the reference-keyframe bank, its planes as map planes with
the Manhattan registries of their perpendicular pairs and triples, and its
lifted lines as map lines.  Stream s replays the sequence from frame
``first[s]`` and starts at that frame's ground-truth pose (a stream that
starts at the identity would take its whole offset from frame 0 as its
first velocity).

``step_solves`` records the pose solves of one such step, as the solver's
arguments, for holding the solve kernel against its plain version.
"""

from __future__ import annotations

import inspect
from unittest import mock

import numpy as np
import torch

from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend import device_tracker as dt
from manhattanslam_tpu_torch.frontend.fast_tracking import FastTracker
from manhattanslam_tpu_torch.ops import lm
from manhattanslam_tpu_torch.parallel import mesh
from manhattanslam_tpu_torch.slam_map import SlamMap


def shared_view(cfg: SlamConfig, frame0: tuple, device) -> tuple[dict, FastTracker]:
    """The view of keyframe 0 made from frame0 = (timestamp, gray, depth),
    and the tracker whose map and registries hold it."""
    tracker = FastTracker(cfg, SlamMap(cfg), device, enable_planes=True, enable_lines=True)
    tracker.track(*frame0)
    host = dt.build_host_view(cfg, tracker.map, tracker.ref_kf, tracker.reg2, tracker.reg3)
    return dt.upload_view(host, device), tracker


def start_poses(seq, first: list[int]) -> np.ndarray:
    """(B, 4, 4) float32 ground-truth T_cw of each stream's first frame,
    in the frame of frame 0 (the view's world)."""
    return np.stack([np.linalg.inv(seq.poses[f]) @ seq.poses[0] for f in first]).astype(
        np.float32
    )


def start_carry(cfg: SlamConfig, seq, first: list[int], device) -> dict:
    """The batched initial carry with each stream at its start pose."""
    carry = mesh.init_batched_carry(cfg, len(first), device)
    carry["T_last"] = torch.from_numpy(start_poses(seq, first)).to(device)
    return carry


def step_frames(native: list, first: list[int], i: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Step i's frames of the streams from `native` (dt.to_native pairs):
    gray8 (B, H, W) uint8 and d16 (B, H, W) int32, uploaded to device."""
    g8 = torch.from_numpy(np.stack([native[f + i][0] for f in first])).to(device)
    d16 = torch.from_numpy(np.stack([native[f + i][1].astype(np.int32) for f in first]))
    return g8, d16.to(device)


def step_solves(cfg: SlamConfig, seq, native: list, view: dict, first: list[int],
                device) -> list[dict]:
    """The ``lm.solve_pose`` calls of step 0 of the streams `first` through
    the full body, run eagerly: the candidate, the Manhattan and the final
    solve, each as ``lm.solve_pose_plain``'s arguments by name (the plain
    version solves them meanwhile)."""
    sig = inspect.signature(lm.solve_pose_plain)
    calls = []

    def record(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        calls.append(dict(bound.arguments))
        return lm.solve_pose_plain(*args, **kwargs)

    body = dt.build_batched_body(cfg, device, enable_planes=True, enable_lines=True)
    g8, d16 = step_frames(native, first, 0, device)
    with mock.patch.object(lm, "solve_pose", record):
        body(*dt.frame_to_float(g8, d16), start_carry(cfg, seq, first, device), view)
    return calls
