"""System facade (counterpart of manhattanslam_tpu/system.py), with the
reference's defaults: the modular tracker with planes, lines and surfels.

Construct from a settings file or a SlamConfig, feed RGB-D frames through
``track``, toggle localization mode, save TUM trajectories and the surfel
PLY.  ``fast=False`` (the default) runs the modular per-stage tracker
(``frontend/tracking.py``) with the plane and line modules as its
toggles; ``fast=True`` runs the fused step (``frontend/fast_tracking.py``)
with planes and lines compiled into it, one frame per step or ``chunk``
frames per dispatch, with or without the pipeline; its step runs from a
CUDA graph on the card (``frontend/graphed_step.py``), and ``warmup``
captures it and warms the keyframe and relocalization paths before a
timed run, ``shutdown`` finishes the frames in flight.  Whatever the
flags, every keyframe goes through the mapping back end (``LocalMapper``:
point culling, triangulation, fusion, keyframe, plane and line culling),
into the relocalization index (``Relocalizer``), which recovers lost
frames, and, with surfels on, into the surfel map (``SurfelMapper``),
built from the keyframe's own gray and depth; all of it runs on the
calling thread.  ``use_viewer`` keeps a headless ``Viewer`` up to date
after every frame; ``save_map`` / ``load_map`` checkpoint the map and
resume from it (``io/map_io.py``).

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
from manhattanslam_tpu_torch.frontend.lines_module import LineModule
from manhattanslam_tpu_torch.frontend.planes_module import PlaneModule
from manhattanslam_tpu_torch.frontend.tracking import KeyframeFrame, Tracker
from manhattanslam_tpu_torch.io import map_io
from manhattanslam_tpu_torch.io import trajectory as traj_io
from manhattanslam_tpu_torch.mapping.local_mapping import LocalMapper
from manhattanslam_tpu_torch.mapping.surfel_mapping import SurfelMapper
from manhattanslam_tpu_torch.reloc.relocalizer import Relocalizer
from manhattanslam_tpu_torch.slam_map import SlamMap
from manhattanslam_tpu_torch.viewer import Viewer


class System:
    def __init__(
        self,
        settings: str | SlamConfig,
        use_viewer: bool = False,
        enable_planes: bool = True,
        enable_lines: bool = True,
        enable_surfels: bool = True,
        fast: bool = False,
        pipeline: bool = False,
        chunk: int = 1,
        device=None,
    ):
        """fast=True: the fused step, planes and lines inside it; pipeline
        and chunk apply to it only.  fast=False: the modular tracker, with
        a PlaneModule and a LineModule as enable_planes / enable_lines
        ask."""
        self.cfg = settings if isinstance(settings, SlamConfig) else load_config(settings)
        self.device = resolve_device(device)
        self.fast = fast
        self.enable_planes = enable_planes
        self.enable_lines = enable_lines
        self.pipeline = pipeline
        self.chunk = chunk
        self.map = SlamMap(self.cfg)
        self.local_mapper = LocalMapper(self.cfg, self.map, self.device)
        self.reloc_module = Relocalizer(self.cfg, self.map, self.device)
        self.surfel_mapper = (SurfelMapper(self.cfg, self.map, self.device)
                              if enable_surfels else None)
        self.kf_perf = defaultdict(float)  # host seconds of the keyframe hooks
        self.n_resets = 0
        self.use_viewer = use_viewer
        self.viewer = None
        self.tracker = None
        self._new_tracker()

    def _new_tracker(self) -> None:
        """A tracker on self.map; the modular tracker takes over the plane
        and line modules of the one before it (Tracking::Reset)."""
        old = self.tracker
        if self.fast:
            tracker = FastTracker(
                self.cfg, self.map, self.device, self.enable_planes, self.enable_lines,
                pipeline=self.pipeline, chunk=self.chunk,
                keep_membership=self.surfel_mapper is not None)
        else:
            tracker = Tracker(self.cfg, self.map, self.device)
            if old is not None:
                tracker.plane_module, tracker.line_module = old.plane_module, old.line_module
            else:
                if self.enable_planes:
                    tracker.plane_module = PlaneModule(self.cfg, self.map, self.device)
                if self.enable_lines:
                    tracker.line_module = LineModule(self.cfg, self.map, self.device)
            for module in (tracker.plane_module, tracker.line_module):
                if module is not None:
                    module.map = self.map
        tracker.reloc_module = self.reloc_module
        tracker.on_keyframe = self._on_keyframe
        self.tracker = tracker
        if self.use_viewer:
            self.viewer = Viewer(self.cfg, self.map, tracker, self.surfel_mapper)

    def track(self, rgb: np.ndarray, depth: np.ndarray, timestamp: float):
        """Process one frame.  rgb: (H,W,3) uint8 or (H,W) gray; depth:
        (H,W) float32 metres, or uint16 in 1/5000 m as TUM stores it.
        Returns Tcw (4,4) or None if tracking failed (System::Track,
        System.cc:115-149)."""
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
        if self.viewer is not None:
            self.viewer.update()
        return T

    # the reference's naming (System::Track)
    Track = track

    def activate_localization_mode(self) -> None:
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self) -> None:
        self.tracker.only_tracking = False

    def warmup(self) -> None:
        """Before a timed run, after a few tracked frames and a flush:
        capture the step's graph and warm the keyframe and relocalization
        paths (the reference compiles its programs here; fused tracker
        only, a no-op for the modular one)."""
        if self.fast:
            self.tracker.warm_programs()

    def reset(self) -> None:
        """System reset (Tracking::Reset, Tracking.cc:2057-2087); the new
        tracker keeps the flags, the chunk, the pipeline and the modules."""
        if self.fast:
            self.tracker.join_mapper()
        self.n_resets += 1
        self.map = SlamMap(self.cfg)
        self.reloc_module.reset(self.map)
        self.local_mapper.map = self.map
        self.local_mapper.recent_points.clear()
        if self.surfel_mapper is not None:
            self.surfel_mapper.reset(self.map)
        self._new_tracker()

    def _on_keyframe(self, kf_id: int, kf_frame: KeyframeFrame) -> None:
        """A new keyframe: the mapping back end, the relocalization index,
        then the surfel map from the keyframe's own frame
        (System._on_keyframe, system.py:231-264)."""
        t0 = time.perf_counter()
        self.local_mapper.process_keyframe(kf_id)
        t1 = time.perf_counter()
        self.reloc_module.add_keyframe(kf_id)
        t2 = time.perf_counter()
        self.kf_perf["local_mapper"] += t1 - t0
        self.kf_perf["reloc_add"] += t2 - t1
        if self.surfel_mapper is not None:
            self.surfel_mapper.insert_keyframe(
                kf_id, kf_frame.gray, kf_frame.depth, plane_membership=kf_frame.membership,
                ref_kf=kf_frame.ref_kf)
            self.kf_perf["surfel_insert"] += time.perf_counter() - t2

    def shutdown(self) -> None:
        """Finish the frames in flight and the deferred back end, then the
        surfel mapper (System::Shutdown, System.cc:167-186)."""
        if self.fast:
            self.tracker.flush()
        if self.surfel_mapper is not None:
            self.surfel_mapper.finish()

    def save_trajectory_tum(self, path: str) -> None:
        traj_io.save_trajectory_tum(path, self.tracker.trajectory_rows())

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        traj_io.save_keyframe_trajectory_tum(path, self.tracker.keyframe_rows())

    def save_surfels(self, path: str) -> None:
        if self.surfel_mapper is not None:
            self.surfel_mapper.save_ply(path)

    def save_map(self, path: str) -> None:
        """Checkpoint the map (the reference's SaveMap TODO, System.h:90-92);
        with chunks or the pipeline, call ``shutdown`` first."""
        map_io.save_map(path, self.map)

    def load_map(self, path: str) -> None:
        """Resume from a checkpoint, into a freshly constructed System: the
        relocalization index is rebuilt in keyframe order, and the fused
        tracker's registries and view follow the loaded map (the view is
        written in place, so the graphed step tracks against it)."""
        map_io.load_map(path, self.map)
        self.reloc_module.reset(self.map)
        for kf in range(self.map.n_kf):
            if self.map.kf_valid[kf]:
                self.reloc_module.add_keyframe(kf)
        if self.fast:
            self.tracker.registries_from_map()
            self.tracker.refresh_view()
