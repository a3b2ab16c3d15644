"""System facade (counterpart of manhattanslam_tpu/system.py): the
reference's ``System(fast=True, enable_surfels=False)`` at one frame per
step, with no pipeline.

Construct from a settings file or a SlamConfig, feed RGB-D frames through
``track``, toggle localization mode, save TUM trajectories.  The fused
tracker runs points and, on request, planes (plane extraction and
residuals, the Manhattan decoupled pose) and lines (detection,
association, residuals, map lines); with both the step is the
reference's full body.  Whatever the flags, every keyframe goes through
the mapping back end (``LocalMapper``: point culling, triangulation,
fusion, keyframe, plane and line culling) and into the relocalization
index (``Relocalizer``), which recovers lost frames; all of it runs
synchronously inside ``track``.  Surfels, chunks, the pipeline and the
modular tracker are not ported yet: asking for them raises
``NotImplementedError`` naming the slice that brings it.

The system runs on CUDA unless ``device`` says otherwise; with no GPU it
raises rather than falling back to the CPU.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

from manhattanslam_tpu_torch import resolve_device
from manhattanslam_tpu_torch.config import SlamConfig, load_config
from manhattanslam_tpu_torch.datasets.tum import to_gray
from manhattanslam_tpu_torch.frontend.fast_tracking import FastTracker
from manhattanslam_tpu_torch.io import trajectory as traj_io
from manhattanslam_tpu_torch.mapping.local_mapping import LocalMapper
from manhattanslam_tpu_torch.reloc.relocalizer import Relocalizer
from manhattanslam_tpu_torch.slam_map import SlamMap


class System:
    def __init__(
        self,
        settings: str | SlamConfig,
        enable_planes: bool = False,
        enable_lines: bool = False,
        enable_surfels: bool = False,
        fast: bool = True,
        pipeline: bool = False,
        chunk: int = 1,
        device=None,
    ):
        later = {
            "fast=False (the modular tracker)": not fast,
            "chunk>1 (chunk mode, keyframes at chunk boundaries)": chunk > 1,
            "pipeline=True (chunk mode slice)": pipeline,
            "enable_surfels=True (surfels slice)": enable_surfels,
        }
        asked = [name for name, on in later.items() if on]
        if asked:
            raise NotImplementedError(
                "not yet ported, comes with a later slice: " + ", ".join(asked)
            )
        self.cfg = settings if isinstance(settings, SlamConfig) else load_config(settings)
        self.device = resolve_device(device)
        self.enable_planes = enable_planes
        self.enable_lines = enable_lines
        self.map = SlamMap(self.cfg)
        self.local_mapper = LocalMapper(self.cfg, self.map, self.device)
        self.reloc_module = Relocalizer(self.cfg, self.map, self.device)
        self.kf_perf = defaultdict(float)  # host seconds of the keyframe hooks
        self.n_resets = 0
        self._new_tracker()

    def _new_tracker(self) -> None:
        self.tracker = FastTracker(
            self.cfg, self.map, self.device, self.enable_planes, self.enable_lines)
        self.tracker.reloc_module = self.reloc_module
        self.tracker.on_keyframe = self._on_keyframe

    def track(self, rgb: np.ndarray, depth: np.ndarray, timestamp: float):
        """Process one frame.  rgb: (H,W,3) uint8 or (H,W) gray; depth:
        (H,W) float32 meters.  Returns Tcw (4,4) or None if tracking failed
        (System::Track, System.cc:115-149)."""
        expected = (self.cfg.camera.height, self.cfg.camera.width)
        if rgb.shape[:2] != expected or depth.shape[:2] != expected:
            raise ValueError(
                f"frame shape mismatch: rgb {rgb.shape[:2]}, depth "
                f"{depth.shape[:2]}, settings expect {expected}"
            )
        gray = rgb.astype(np.float32) if rgb.ndim == 2 else to_gray(rgb, self.cfg.camera.rgb)
        T = self.tracker.track(timestamp, gray, depth)
        if self.tracker.request_reset:
            # lost with <=5 keyframes: automatic full reset (Tracking.cc:517-523)
            self.reset()
        return T

    def activate_localization_mode(self) -> None:
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self) -> None:
        self.tracker.only_tracking = False

    def reset(self) -> None:
        """System reset (Tracking::Reset, Tracking.cc:2057-2087)."""
        self.n_resets += 1
        self.map = SlamMap(self.cfg)
        self.reloc_module.reset(self.map)
        self.local_mapper.map = self.map
        self.local_mapper.recent_points.clear()
        self._new_tracker()

    def _on_keyframe(self, kf_id: int) -> None:
        """A new keyframe: the mapping back end, then the relocalization
        index (System._on_keyframe without the surfels)."""
        t0 = time.perf_counter()
        self.local_mapper.process_keyframe(kf_id)
        t1 = time.perf_counter()
        self.reloc_module.add_keyframe(kf_id)
        self.kf_perf["local_mapper"] += t1 - t0
        self.kf_perf["reloc_add"] += time.perf_counter() - t1

    def shutdown(self) -> None:
        """Nothing is in flight: every track() call finishes its frame."""

    def save_trajectory_tum(self, path: str) -> None:
        traj_io.save_trajectory_tum(path, self.tracker.trajectory_rows())

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        traj_io.save_keyframe_trajectory_tum(path, self.tracker.keyframe_rows())
