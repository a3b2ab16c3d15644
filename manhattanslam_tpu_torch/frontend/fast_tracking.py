"""Host state machine around the fused device step (counterpart of
manhattanslam_tpu/frontend/fast_tracking.py).

Per frame (``chunk=1``): one upload of the frame (u8 gray + depth, from
pinned memory), one replay of the frame step's CUDA graph
(``graphed_step.GraphedStep``; the first call runs eagerly and the second
captures), one pull of the flat summary.  With ``chunk=C`` the frames are
buffered into a pinned staging ring and run C at a time
(``device_tracker.build_chunk_step``: C replays of the same graph against
one view, the landmark statistics accumulated on the device); the chunk
costs one pull of its per-frame cores and counts, and a frame that
becomes a keyframe fetches its extras and payload lazily from the chunk's
output slot.  ``pipeline=True`` enqueues frame or chunk k before it reads
k-1's summary (two chunks in flight in chunk mode), so ``track`` returns
an earlier frame's pose, or None, as the reference does; ``flush`` (and
``System.shutdown``) finishes the frames in flight, padding a partial
chunk with its last frame.

The map view on the device is refreshed only at keyframe events, where
the host runs the reference's keyframe policy, creates map points from
depth and, with planes on, merges or adds the frame's planes and
registers perpendicular pairs and triples in the Manhattan registries;
with lines on, it refines associated map lines and adds new ones.  Then
the keyframe goes to ``on_keyframe`` (the System's mapping back end and
relocalization index) and the view is refreshed a second time, so that
the back end's triangulated, fused and culled landmarks reach the device.
A retired keyframe re-anchors the trajectory records and the reference
keyframe on its spanning-tree parent.  A lost frame goes to
``reloc_module``; after a relocalization inside a chunk, the chunk's
later frames and the chunks in flight are run again from the reset carry.
In localization mode (``only_tracking``) no keyframe is made and a loss
never asks for a reset.

No threads.  The reference's puller thread becomes a non-blocking copy
into pinned memory behind a CUDA event, read when its frame is finished.
The reference's mapper thread becomes a deferred job: in chunk mode the
keyframe's back end runs on this thread just after the next chunk's
replays are enqueued, so the card computes while the host maps, and its
view refresh is written in place on the same stream, after that chunk
and before the one after it.  So the order of effects is fixed by the
frame order, not by a thread's timing: neither the reference's donated
view under a concurrent dispatch (fast_tracking.py:632) nor its
``_prev_gray`` read from the worker (system.py:258) has a counterpart.
Whatever the graph reads (carry, view, reference-keyframe banks) is
written in place; whatever is read after the next replay is copied out
into a ring of ``pipeline_depth + 1`` output slots first, and the
staging ring has as many slots.  Keyframe payloads are copied on a side
stream, so they do not wait behind the frames in flight.

Host spans go into ``trace`` (a ``tracing.Recorder``, the System's when
a System made the tracker): ``intake`` (the frame to its native planes and
into the pinned staging), ``frame_dispatch`` or ``chunk_dispatch`` (with
the step's ``step.inputs`` and ``step.launch``, and ``stats``,
``copy_out``, ``flat`` and ``pull``), ``summary_pull``, ``mapper_join``
and at a keyframe event ``keyframe_event`` (``kf_payload_pull``,
``kf_bookkeeping``, ``kf_view_diff``), ``mapping_backend`` and
``backend_view_diff``, and ``relocalize``.  ``perf`` (host seconds) and
``perf_n`` (events) read the sections of SECTIONS from it, wherever they
nest; the counter ``manhattan_frames`` counts the frames whose pose the
Manhattan path gave.
"""

from __future__ import annotations

import functools
import itertools
from collections import Counter

import numpy as np
import torch

from manhattanslam_tpu_torch import tracing
from manhattanslam_tpu_torch.config import SlamConfig
from manhattanslam_tpu_torch.frontend import device_tracker as dt
from manhattanslam_tpu_torch.frontend.graphed_step import GraphedStep, copy_tree_
from manhattanslam_tpu_torch.frontend.tracking import (
    LOST, NOT_INITIALIZED, OK, FrameRecord, KeyframeFrame,
)
from manhattanslam_tpu_torch.geometry import se3
from manhattanslam_tpu_torch.ops.planes import transform_plane_np
from manhattanslam_tpu_torch.slam_map import SlamMap

# the host sections of ``FastTracker.perf``
SECTIONS = (
    "frame_dispatch", "chunk_dispatch", "summary_pull", "mapper_join", "keyframe_event",
    "kf_payload_pull", "kf_bookkeeping", "kf_view_diff", "mapping_backend", "backend_view_diff",
    "relocalize",
)


class FastTracker:
    def __init__(
        self,
        cfg: SlamConfig,
        slam_map: SlamMap,
        device: torch.device,
        enable_planes: bool = False,
        enable_lines: bool = False,
        pipeline: bool = False,
        chunk: int = 1,
        keep_membership: bool = False,
        trace: tracing.Recorder | None = None,
    ):
        self.cfg = cfg
        self.trace = trace if trace is not None else tracing.Recorder()
        self.map = slam_map
        self.device = torch.device(device)
        self.enable_planes = enable_planes
        self.enable_lines = enable_lines
        self.chunk = max(1, int(chunk))
        self.pipeline = pipeline
        # two chunks in flight in chunk mode: the wait for chunk k's summary
        # overlaps the card's work on chunk k+1
        self.pipeline_depth = 2 if (pipeline and self.chunk > 1) else 1
        self.step = GraphedStep(dt.build_frame_step(cfg, device, enable_planes, enable_lines),
                                device, self.trace)
        self.chunk_step = (
            dt.build_chunk_step(cfg, device, enable_planes, enable_lines, frame_step=self.step,
                                trace=self.trace)
            if self.chunk > 1 else None)
        # Manhattan registries (host source of truth; the view mirrors them)
        self.reg2, self.reg3 = dt.empty_registries(cfg)
        # the temporal VO bank anchors tracking while map coverage starves
        # (it engages only below 30 map inliers, device_tracker.py); the
        # step's graph reads these tensors, so they are written in place
        self.carry = dt.init_carry(cfg, device, vo_points=True)
        self.view = None  # device map view (written in place once made)
        self.last_result = None  # the device result of the last frame or chunk
        self.layouts = None  # the flat buffers' layouts (dt.flat_layouts)
        self._shadow = None  # host snapshot of what the device view holds
        # view epochs: _view_epoch bumps whenever the map a dispatched frame
        # saw becomes stale (a keyframe); _view_applied_epoch is the epoch
        # of the view on the device.  A frame may mint a keyframe only if
        # its view was current (fast_tracking.py:856-888)
        self._view_epoch = 0
        self._view_applied_epoch = 0
        # rings of pipeline_depth + 1 slots: pinned staging and output slots
        H, W = cfg.camera.height, cfg.camera.width
        lead = (self.chunk,) if self.chunk > 1 else ()
        pin = self.device.type == "cuda"
        n_slots = self.pipeline_depth + 1
        self._stage = [
            (torch.empty(lead + (H, W), dtype=torch.uint8, pin_memory=pin),
             torch.empty(lead + (H, W), dtype=torch.int32, pin_memory=pin))
            for _ in range(n_slots)
        ]
        self._stage_i = 0
        self._out = [None] * n_slots
        self._out_i = 0
        # the surfel arm reads a keyframe's plane membership: only then does
        # a frame's output slot keep it and a keyframe clone it
        self.keep_membership = keep_membership
        self._frame_keep = dt.FRAME_KEEP + (("plane_membership",) if keep_membership else ())
        self._pull_stream = torch.cuda.Stream(self.device) if pin else None
        self._pending = []  # frames or chunks enqueued, not yet finished
        # chunk mode: (timestamp, frame_id, g8, d16, gray, depth) buffered;
        # the caller's gray and depth go to the surfel arm at a keyframe
        self._buf = []
        self._backend_job = None  # chunk mode: the deferred back end
        self._chunk_restart = False
        self.frame_log: list[tuple] = []  # (frame_id, n_inliers, ok, ref_matches, ref_total)

        self.state = NOT_INITIALIZED
        self.request_reset = False
        self.T_cw = np.eye(4, dtype=np.float32)
        self.frame_id = -1
        self.last_kf_frame_id = 0
        self.ref_kf = 0
        self.n_inliers = 0
        self.n_map_inliers = 0
        # the last frame's keypoint -> map point (-1 none), as the host
        # already reads it; chunk mode updates it at keyframes only, as the
        # reference does (the viewer's tracked keypoints)
        self.last_mp_idx = np.full(cfg.caps.max_keypoints, -1, np.int32)
        self.records: list[FrameRecord] = []
        self.max_frames = int(cfg.camera.fps)
        self.min_frames = int(cfg.min_kf_frames)
        self.last_reloc_frame_id = -(10**9)
        self.only_tracking = False  # localization mode
        self._vo_flag = False  # the carry's vo_points as last set by the mode
        self.force_keyframe = False  # the next frame past the capacity check is a keyframe
        self.n_ok_frames = 0
        # keyframes made, of them in reused slots, points made from depth,
        # frames relocalized
        self.counts = Counter()
        self.prev_ref_kf = 0  # the reference keyframe before the last keyframe
        # hooks: System sets these (the back end and relocalization)
        self.on_keyframe = None
        self.reloc_module = None
        slam_map.kf_retire_callbacks.append(self._on_kf_retired)
        self._ref_matches = None  # cache; None = recompute (map/ref-KF changed)
        self._ref_total = 0
        self._new_plane_streak = 0

    @property
    def perf(self) -> dict[str, float]:
        """Host seconds of each section of SECTIONS entered so far."""
        return {k: s for k, (s, _) in tracing.by_leaf(self.trace.snapshot(), SECTIONS).items()}

    @property
    def perf_n(self) -> dict[str, int]:
        """Events of each section of SECTIONS entered so far."""
        return {k: n for k, (_, n) in tracing.by_leaf(self.trace.snapshot(), SECTIONS).items()}

    # ------------------------------------------------------------------ API
    def track(self, timestamp: float, gray: np.ndarray, depth: np.ndarray):
        """Track one frame; returns Tcw (4,4) or None when lost or, with
        chunks or the pipeline, when no earlier frame finished with it."""
        self.frame_id += 1
        if self.only_tracking != self._vo_flag:
            # the mode changed: the temporal VO bank follows it
            # (UpdateLastFrame, Tracking.cc:1052)
            self.carry["vo_points"].fill_(self.only_tracking)
            self._vo_flag = self.only_tracking
        initialized = self.state != NOT_INITIALIZED
        with self.trace.span("intake"):
            g8, d16 = dt.to_native(gray, depth)
            if initialized and self.chunk > 1:
                self._buf_append((timestamp, self.frame_id, g8, d16, gray, depth))
            elif initialized:
                g8s, d16s = self._next_stage()
                g8s.numpy()[...] = g8
                d16s.numpy()[...] = d16
        if not initialized:
            self._initialize(timestamp, g8, d16, (gray, depth))
            self._record(timestamp, lost=False)
            return self.T_cw.copy()
        if self.chunk > 1:
            if len(self._buf) < self.chunk:
                return None
            return self._dispatch_chunk()
        with self.trace.span("frame_dispatch"):
            result, self.carry = self.step(g8s, d16s, self.carry, self.view)
            if self.layouts is None:  # no first frame: a map loaded from a checkpoint
                self.layouts = dt.flat_layouts(result)
            with self.trace.span("copy_out"):
                slot = self._to_slot(result)
            with self.trace.span("pull"):
                pulled = dt.HostPull([slot["summary_flat"]])
        self.last_result = result
        pend = functools.partial(self._finish_frame, timestamp, self.frame_id, (gray, depth),
                                 slot, pulled=pulled)
        if self.pipeline:
            self._pending.append(pend)
            if len(self._pending) >= self.pipeline_depth + 1:
                return self._pending.pop(0)()
            return None
        return pend()

    def flush(self):
        """Finish the frames in flight and the buffered partial chunk
        (padded with its last frame; only the real frames are recorded),
        then the deferred back end.  Returns the last pose finished."""
        out = None
        while self._pending or self._buf:
            if self._pending:
                pend = self._pending.pop(0)
                pose = self._process_chunk(*pend) if self.chunk > 1 else pend()
            else:
                metas, self._buf = self._buf, []
                g8s, d16s = self._stage[self._stage_i]
                for j in range(len(metas), self.chunk):
                    g8s.numpy()[j] = metas[-1][2]
                    d16s.numpy()[j] = metas[-1][3]
                pose = self._process_chunk(metas, *self._enqueue_chunk())
            out = pose if pose is not None else out
        self.join_mapper()
        return out

    # ------------------------------------------------------------ the rings
    def _next_stage(self):
        pair = self._stage[self._stage_i]
        self._stage_i = (self._stage_i + 1) % len(self._stage)
        return pair

    def _to_slot(self, result: dict) -> dict:
        """Copy a frame's FRAME_KEEP outputs (and its plane membership for
        the surfel arm) into the next output slot (the next replay
        overwrites the graph's)."""
        lite = dt.keep(result, self._frame_keep)
        i = self._out_i
        self._out_i = (i + 1) % len(self._out)
        if self._out[i] is None:
            self._out[i] = dt.empty_slot(lite)
        copy_tree_(self._out[i], lite)
        return self._out[i]

    # ------------------------------------------------------------ chunk mode
    def _buf_append(self, meta) -> None:
        """Buffer one frame: its native planes go into the current staging
        pair (row = position in the chunk)."""
        g8s, d16s = self._stage[self._stage_i]
        i = len(self._buf)
        g8s.numpy()[i] = meta[2]
        d16s.numpy()[i] = meta[3]
        self._buf.append(meta)

    def _enqueue_chunk(self):
        """Enqueue the staged chunk: C replays into the next output slot,
        then its one pull (cores and counts) and the keyframe extras, both
        without blocking.  Returns (results, pull, view epoch)."""
        with self.trace.span("chunk_dispatch"):
            g8s, d16s = self._next_stage()
            i = self._out_i
            self._out_i = (i + 1) % len(self._out)
            results, self.carry = self.chunk_step(g8s, d16s, self.carry, self.view,
                                                  out=self._out[i])
            self._out[i] = results
            if self.layouts is None:  # no first frame: a map loaded from a checkpoint
                self.layouts = self.chunk_step.layouts
            with self.trace.span("pull"):
                pulled = dt.HostPull([results["chunk_flat"], results["kfx_flat"]])
        self.last_result = results
        return results, pulled, self._view_applied_epoch

    def _dispatch_chunk(self):
        metas, self._buf = self._buf, []
        pend = (metas, *self._enqueue_chunk())
        # the previous keyframe's back end runs while the card computes
        with self.trace.span("mapper_join"):
            self.join_mapper()
        if self.pipeline:
            self._pending.append(pend)
            if len(self._pending) >= self.pipeline_depth + 1:
                return self._process_chunk(*self._pending.pop(0))
            return None
        return self._process_chunk(*pend)

    def _process_chunk(self, metas, results, pulled, epoch):
        c = self.cfg.caps
        with self.trace.span("summary_pull"):
            flat, kfx = pulled.wait()
            cores, stats = dt.parse_chunk_summary(
                flat, self.chunk, self.layouts["core"], c.max_map_points, c.max_map_lines)
        with self.trace.span("mapper_join"):
            self.join_mapper()
        # the chunk's landmark statistics, counted on the device
        m = self.map
        m.mp_visible += np.where(m.mp_valid, stats["mp_visible"], 0)
        m.mp_found += np.where(m.mp_valid, stats["mp_found"], 0)
        m.ml_visible += np.where(m.ml_valid, stats["ml_visible"], 0)
        m.ml_found += np.where(m.ml_valid, stats["ml_found"], 0)
        out = None
        for i, (ts, fid, _g8, _d16, gray, depth) in enumerate(metas):
            pose = self._finish_frame(ts, fid, (gray, depth), results, cores[i], i, None, epoch,
                                      kfx)
            out = pose if pose is not None else out
            if self._chunk_restart:
                # a relocalization inside the chunk: its later frames and the
                # chunks in flight ran from the carry before it; run them
                # again from the reset carry, so recovery costs one frame as
                # in the reference's per-frame relocalization (Tracking.cc:410)
                self._chunk_restart = False
                stale = list(metas[i + 1:])
                for ms, *_ in self._pending:
                    stale.extend(ms)
                self._pending = []
                if self.device.type == "cuda":
                    # the dropped chunks' staging and output slots are free
                    torch.cuda.current_stream(self.device).synchronize()
                pose = self._replay_frames(stale)
                return pose if pose is not None else out
        return out

    def _replay_frames(self, metas):
        """Track frames again through the chunk path; a partial chunk left
        over stays buffered for the next track() or flush()."""
        out = None
        for meta in metas:
            self._buf_append(meta)
            if len(self._buf) >= self.chunk:
                pose = self._dispatch_chunk()
                out = pose if pose is not None else out
        return out

    def join_mapper(self) -> None:
        """Run the deferred back end of the last keyframe, if any."""
        job, self._backend_job = self._backend_job, None
        if job is not None:
            job()

    # ------------------------------------------------------------ a frame
    def _finish_frame(self, timestamp: float, frame_id: int, frame: tuple, result: dict, s=None,
                      idx=None, pulled=None, epoch=None, kfx=None) -> np.ndarray | None:
        """The host side of one frame (`frame`: the caller's gray and
        depth of it): its summary `s` (pulled from `result` when None;
        chunk mode passes the core of frame `idx`), the relocalization of
        a lost frame, the landmark statistics, the keyframe decision."""
        if s is None:
            with self.trace.span("summary_pull"):
                s = dt.pull_summary(result, self.layouts["summary"], pulled)
        ok = bool(s["tracked_ok"])
        # within one fps window of a relocalization the reference asks for
        # >= 20 inliers (Tracking.cc:1423-1425)
        if ok and frame_id < self.last_reloc_frame_id + self.max_frames:
            ok = int(s["n_inliers"]) >= 20
        self.frame_log.append(
            (frame_id, int(s["n_inliers"]), ok,
             self._ref_matches if self._ref_matches is not None else -1,
             self._ref_total)
        )
        if not ok and self._relocalize(result, idx, frame_id):
            # the failed step's pose and matches are not used: the pose
            # and the carry come from the relocalization
            self.state = OK
            self._chunk_restart = idx is not None
            self._record(timestamp, lost=False)
            return self.T_cw.copy()
        if not ok:
            self.state = LOST
            # barely-started map: request a full system reset
            # (Tracking.cc:517-523)
            if not self.only_tracking and self.map.n_kf <= 5:
                self.request_reset = True
            self._record(timestamp, lost=True)
            return None

        self.state = OK
        self.T_cw = s["T"].astype(np.float32)
        self.n_inliers = int(s["n_inliers"])
        self.n_map_inliers = int(s["n_map_inliers"])
        self.n_ok_frames += 1
        if bool(s.get("use_manhattan", False)):
            self.trace.count("manhattan_frames")
        if idx is None:
            self.last_mp_idx = s["kp_mp"]
            # landmark statistics (MapPoint::IncreaseVisible / IncreaseFound;
            # chunk mode counts them on the device)
            m = self.map
            vis = s["visible"] & m.mp_valid
            m.mp_visible[vis] += 1
            m.mp_found[s["matched"] & vis] += 1
            if self.enable_lines:
                # MapLine::IncreaseVisible / IncreaseFound; np.add.at counts
                # two frame lines on one map line twice
                m.ml_visible[s["ml_visible"] & m.ml_valid] += 1
                matched_ml = s["line_assoc"][s["line_assoc"] >= 0]
                np.add.at(m.ml_found, matched_ml[m.ml_valid[matched_ml]], 1)
        # the view-staleness gate (the reference's "mapper busy" arm,
        # Tracking.cc:1454): a frame computed against a view older than the
        # last keyframe's refresh mints no keyframe, unless the camera is a
        # chunk (at least 8 frames) past the last keyframe
        view_fresh = (epoch is None or epoch >= self._view_epoch
                      or frame_id >= self.last_kf_frame_id + max(self.chunk, 8))
        if not self.only_tracking and view_fresh and self._need_new_keyframe(s, frame_id):
            if idx is not None:  # the keyframe extras of this one frame
                s = {**s, **dt.pull_kfx(kfx, idx, self.layouts["kfx"])}
            self._create_keyframe(timestamp, result, s, frame_id, frame, idx)
        self._record(timestamp, lost=False)
        return self.T_cw.copy()

    # ------------------------------------------------------------- keyframe
    def _need_new_keyframe(self, s: dict, frame_id: int) -> bool:
        """NeedNewKeyFrame (Tracking.cc:1433-1508) as the reference package
        decides it for points and planes: past the min-frames hysteresis, a
        keyframe when map matches fall below a share of the reference
        keyframe's well-observed points (or close points go untracked), or
        when a new plane persists, while the pose still has more than 15
        inliers.  ``force_keyframe`` makes the next frame one."""
        m = self.map
        c = self.cfg.caps
        free_kf = (c.max_keyframes - m.n_kf) + len(m.kf_free)
        if free_kf <= 1:
            self.force_keyframe = False
            return False
        if self.force_keyframe:  # a warm-up hook (bench.py)
            self.force_keyframe = False
            return True
        n_kfs = m.n_kf - len(m.kf_free)  # live keyframes
        # no keyframe right after a relocalization once the map is mature
        # (Tracking.cc:1443-1444)
        if frame_id < self.last_reloc_frame_id + self.max_frames and n_kfs > self.max_frames:
            return False
        since_kf = frame_id - self.last_kf_frame_id
        # a frame plane with no map association, seen on >= 2 consecutive
        # frames (Tracking.cc:1494; a one-frame flicker mints nothing)
        new_plane = bool(s.get("new_plane", False))
        self._new_plane_streak = self._new_plane_streak + 1 if new_plane else 0
        if since_kf < self.min_frames:
            return False
        # TrackedMapPoints(nMinObs): ref-KF matches with >= nMinObs
        # observations; changes only at keyframe events, so cached
        if self._ref_matches is None:
            nmin = 3 if n_kfs > 2 else 2
            ref_ids = m.kf_mp_idx[self.ref_kf]
            ref_ids = ref_ids[ref_ids >= 0]
            if len(ref_ids):
                flat = m.kf_mp_idx[: m.n_kf][m.kf_valid[: m.n_kf]]
                flat = flat[flat >= 0]
                obs = np.bincount(flat, minlength=c.max_map_points)
                self._ref_matches = int((obs[ref_ids] >= nmin).sum())
                self._ref_total = len(ref_ids)
            else:
                self._ref_matches = 0
                self._ref_total = 0
        th_ref = 0.75 if n_kfs > 2 else 0.4
        need_close = int(s["tracked_close"]) < 100 and int(s["nontracked_close"]) > 70
        c2 = (
            self.n_map_inliers < self._ref_matches * th_ref or need_close
        ) and self.n_inliers > 15
        decision = c2 or (self._new_plane_streak >= 2 and self.n_inliers > 15)
        if decision:
            self._new_plane_streak = 0
        return decision

    def _create_keyframe(self, timestamp, result, s, frame_id, frame, idx=None) -> None:
        with self.trace.span("keyframe_event"):
            m = self.map
            with self.trace.span("kf_payload_pull"):
                payload = dt.pull_payload(result, idx, self.layouts["payload"],
                                          self._pull_stream)
            with self.trace.span("kf_bookkeeping"):
                feats_np = payload["feats"]
                self.counts["slots_reused"] += bool(m.kf_free)
                kf_id = m.add_keyframe(self.T_cw, timestamp, frame_id, feats_np)
                self.counts["keyframes"] += 1
                # new map points from depth (close-first, cap 100)
                mp_idx = self._create_points_from_depth(feats_np, kf_id, s["kp_mp"])
                self.counts["depth_points"] += int(((mp_idx >= 0) & (s["kp_mp"] < 0)).sum())
                m.set_kf_matches(kf_id, mp_idx)
                self.last_mp_idx = mp_idx
                if self.enable_planes:
                    self._kf_planes(kf_id, payload, s["plane_assoc"])
                if self.enable_lines:
                    self._kf_lines(kf_id, payload)
                self.prev_ref_kf = self.ref_kf
                self.ref_kf = kf_id
                self.last_kf_frame_id = frame_id
                self._ref_matches = None
                kf_frame = self._keyframe_frame(result, idx, frame)
            # the new keyframe's points enter the device view now, so the
            # next frame or chunk enqueued tracks against them; frames
            # already in flight keep their older epoch and mint nothing
            self._view_epoch += 1
            with self.trace.span("kf_view_diff"):
                self._refresh_view_apply()
        job = functools.partial(self._backend, kf_id, kf_frame)
        if self.chunk > 1:
            self._backend_job = job  # runs after the next chunk is enqueued
        else:
            job()

    def _keyframe_frame(self, result: dict, idx, frame: tuple) -> KeyframeFrame:
        """What the surfel arm reads of a keyframe: the caller's gray and
        depth of its own frame, a device copy of its plane membership
        when the arm asked for it (a clone on the compute stream, not a
        pull: the output slot is reused by a later frame or chunk before
        a deferred back end runs), and the reference keyframe before it."""
        memb = result.get("plane_membership") if self.keep_membership else None
        if memb is not None:
            memb = (memb if idx is None else memb[idx]).clone()
        return KeyframeFrame(*frame, memb, self.prev_ref_kf)

    def _backend(self, kf_id: int, kf_frame: KeyframeFrame) -> None:
        """The keyframe's back end, relocalization index and surfels, then
        the view refresh that carries their landmarks to the device."""
        if self.on_keyframe is None:
            return
        with self.trace.span("mapping_backend"):
            self.on_keyframe(kf_id, kf_frame)
        with self.trace.span("backend_view_diff"):
            self._refresh_view_apply()

    def _create_points_from_depth(self, feats_np, kf_id, existing, max_new=100):
        """All close points + nearest far points up to max_new total
        (CreateNewKeyFrame depth-sorted rule, Tracking.cc:1554-1580)."""
        cfg = self.cfg
        m = self.map
        depth = feats_np["depth"]
        valid = feats_np["valid"] & (depth > 0) & (existing < 0)
        close_th = cfg.th_depth_m
        idx_close = np.nonzero(valid & (depth <= close_th))[0]
        chosen = idx_close
        if len(idx_close) < max_new:
            far = np.nonzero(valid & (depth > close_th))[0]
            far = far[np.argsort(depth[far])][: max_new - len(idx_close)]
            chosen = np.concatenate([idx_close, far])
        out = existing.copy()
        n_free = int((~m.mp_valid).sum())
        chosen = chosen[:n_free]
        if len(chosen) == 0:
            return out
        cam = cfg.camera
        d = depth[chosen]
        x = (feats_np["xy_und"][chosen, 0] - cam.cx) / cam.fx * d
        y = (feats_np["xy_und"][chosen, 1] - cam.cy) / cam.fy * d
        pts_c = np.stack([x, y, d], -1)
        T_wc = np.linalg.inv(self.T_cw)
        pts_w = pts_c @ T_wc[:3, :3].T + T_wc[:3, 3]
        dvec = pts_w - T_wc[:3, 3]
        dist = np.linalg.norm(dvec, axis=1).clip(1e-9)
        lvl = feats_np["level"][chosen]
        sf = cfg.orb.scale_factor
        max_d = dist * sf**lvl
        min_d = max_d / sf ** (cfg.orb.n_levels - 1)
        ids = m.add_points(
            pts_w, feats_np["desc"][chosen], dvec / dist[:, None], min_d, max_d, lvl, kf_id
        )
        out[chosen] = ids
        return out

    def _kf_planes(self, kf_id: int, planes: dict, assoc: np.ndarray) -> None:
        """The keyframe's planes: an associated one merges its world-frame
        cloud into its map plane, a new one becomes a map plane; then every
        perpendicular pair and triple of them is registered with this
        keyframe (LocalMapping.cc:172-218)."""
        m = self.map
        T_wc = np.linalg.inv(self.T_cw)
        P = self.cfg.caps.max_planes_frame
        assoc = assoc.copy()
        for i in range(P):
            if not planes["plane_valid"][i]:
                continue
            cloud_c = planes["plane_cloud"][i][: planes["plane_npts"][i]]
            cloud_w = cloud_c @ T_wc[:3, :3].T + T_wc[:3, 3]
            j = int(assoc[i])
            if j >= 0 and m.pl_valid[j]:
                m.merge_plane_points(j, cloud_w)
                m.pl_n_obs[j] += 1
            else:
                if (~m.pl_valid).sum() == 0:
                    continue
                pi_w = transform_plane_np(T_wc, planes["plane_coeffs"][i])
                j = m.add_plane(pi_w, cloud_w, kf_id)
                assoc[i] = j
            m.kf_pl_idx[kf_id, i] = j
            m.kf_plane_coeffs[kf_id, i] = planes["plane_coeffs"][i]
            m.kf_plane_npts[kf_id, i] = planes["plane_support"][i]

        # Manhattan registration of the associated planes
        th = self.cfg.plane.mf_vertical_threshold
        ids = [i for i in range(P) if planes["plane_valid"][i] and assoc[i] >= 0]
        normal = planes["plane_coeffs"][:, :3]
        for a, i in enumerate(ids):
            for b in range(a + 1, len(ids)):
                j = ids[b]
                if abs(float(normal[i] @ normal[j])) > th:
                    continue
                pa, pb = int(assoc[i]), int(assoc[j])
                if self.reg2[pa, pb] < 0:
                    self.reg2[pa, pb] = self.reg2[pb, pa] = kf_id
                    m.add_manhattan_pair(pa, pb, kf_id)
                for k in ids[b + 1:]:
                    if abs(float(normal[i] @ normal[k])) > th or abs(float(normal[j] @ normal[k])) > th:
                        continue
                    trip = (pa, pb, int(assoc[k]))
                    if self.reg3[trip] < 0:
                        for perm in itertools.permutations(trip):
                            self.reg3[perm] = kf_id
                        m.add_manhattan_triple(*trip, kf_id)

    def _kf_lines(self, kf_id: int, lines: dict, max_new: int = 30) -> None:
        """The keyframe's lines (the reference's _kf_lines): an associated
        line refines its map line with its world-frame 3D segment, when it
        has one; an unassociated line with a 3D segment becomes a map line
        in the lowest free slot, at most max_new per keyframe."""
        m = self.map
        T_wc = np.linalg.inv(self.T_cw)

        def world(p):
            return p @ T_wc[:3, :3].T + T_wc[:3, 3]

        n_new = 0
        for i in range(self.cfg.caps.max_lines):
            if not lines["line_valid"][i]:
                continue
            j = int(lines["line_assoc"][i])
            if j >= 0 and m.ml_valid[j]:
                if lines["line_has3d"][i]:
                    m.observe_line(j, world(lines["line_sp3"][i]), world(lines["line_ep3"][i]),
                                   lines["line_desc"][i])
                m.ml_n_obs[j] += 1
            elif lines["line_has3d"][i] and n_new < max_new:
                free = np.nonzero(~m.ml_valid)[0]
                if len(free) == 0:
                    break
                j = int(free[0])
                m.ml_sp[j] = world(lines["line_sp3"][i])
                m.ml_ep[j] = world(lines["line_ep3"][i])
                m.ml_desc[j, : lines["line_desc"].shape[1]] = lines["line_desc"][i]
                m.ml_valid[j] = True
                m.ml_n_obs[j] = 1
                m.ml_first_kf[j] = kf_id
                n_new += 1
            else:
                continue
            m.kf_ml_idx[kf_id, i] = j

    # ------------------------------------------------------- initialization
    def _initialize(self, timestamp, g8, d16, frame: tuple) -> None:
        """First frame: its features become keyframe 0 with every depth
        point as a landmark.  Its step is the graphed step's eager first
        call (chunk mode too), and the carry starts afresh after it.
        `frame`: the caller's (gray, depth) of it."""
        self.T_cw = np.eye(4, dtype=np.float32)
        self.refresh_view()  # bootstrap view (empty map) so the step can run
        g8s, d16s = self._next_stage()
        g8s.numpy().reshape((-1,) + g8.shape)[0] = g8
        d16s.numpy().reshape((-1,) + d16.shape)[0] = d16
        lead = (0,) if self.chunk > 1 else ()
        result, self.carry = self.step(g8s[lead], d16s[lead], self.carry, self.view)
        self.last_result = result
        self.layouts = dt.flat_layouts(result)
        payload = dt.pull_payload(result, None, self.layouts["payload"])
        dt.reset_carry_(self.carry, self.cfg, vo_points=True)
        feats_np = payload["feats"]
        m = self.map
        kf_id = m.add_keyframe(self.T_cw, timestamp, self.frame_id, feats_np)
        mp_idx = self._create_points_from_depth(
            feats_np, kf_id, np.full(self.cfg.caps.max_keypoints, -1, np.int32),
            max_new=10**9,
        )
        self.counts.update(keyframes=1, depth_points=int((mp_idx >= 0).sum()))
        m.set_kf_matches(kf_id, mp_idx)
        self.last_mp_idx = mp_idx
        if self.enable_planes:
            P = self.cfg.caps.max_planes_frame
            self._kf_planes(kf_id, payload, np.full(P, -1, np.int32))
        if self.enable_lines:
            self._kf_lines(kf_id, payload)
        self.prev_ref_kf = self.ref_kf
        self.ref_kf = kf_id
        self.last_kf_frame_id = self.frame_id
        self.state = OK
        if self.on_keyframe is not None:
            self.on_keyframe(kf_id, self._keyframe_frame(result, None, frame))
        self.refresh_view()
        self._ref_matches = None

    def registries_from_map(self) -> None:
        """The dense Manhattan registries rebuilt from the map's own (a map
        loaded from a checkpoint); the next view refresh carries them."""
        self.reg2, self.reg3 = dt.empty_registries(self.cfg)
        for (a, b), kf in self.map.manhattan_pairs.items():
            self.reg2[a, b] = self.reg2[b, a] = kf
        for trip, kf in self.map.manhattan_triples.items():
            for perm in itertools.permutations(trip):
                self.reg3[perm] = kf

    def refresh_view(self) -> None:
        """Bring the device map view up to the host map (a new epoch)."""
        self._view_epoch += 1
        self._refresh_view_apply()

    def _refresh_view_apply(self) -> None:
        """Upload the view once, then write each row diff into it in place."""
        host = dt.build_host_view(self.cfg, self.map, self.ref_kf, self.reg2, self.reg3)
        if self.view is None:
            self.view = dt.upload_view(host, self.device)
        else:
            dt.apply_view_update(self.view, dt.diff_host_views(self._shadow, host))
        self._shadow = host
        self._view_applied_epoch = self._view_epoch

    def warm_programs(self) -> None:
        """The reference's warm-up of every program the steady state and its
        keyframe and relocalization events reach, for a timed run that
        follows: capture the step's graph if no call has yet, and run the
        keyframe pulls and one relocalization of the last frame (its result
        and random stream discarded), so that their kernels are loaded and
        their pinned buffers made.  Call after at
        least one tracked frame or chunk and a ``flush``."""
        r = self.last_result
        if r is None or self.view is None:
            return
        self.step.capture(self.view)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        idx = 0 if self.chunk > 1 else None
        if idx is not None:
            dt.pull_kfx(dt.HostPull([r["kfx_flat"]]).wait()[0], 0, self.layouts["kfx"])
        dt.pull_payload(r, idx, self.layouts["payload"], self._pull_stream)
        rm = self.reloc_module
        if rm is not None:
            saved = (rm.last_kf, rm.last_path, rm.generator.get_state())
            rm.relocalize(r["feats"] if idx is None else dt.slot_row(r["feats"], idx))
            rm.last_kf, rm.last_path = saved[:2]
            rm.generator.set_state(saved[2])

    # --------------------------------------------------------------- reloc
    def _relocalize(self, result: dict, idx: int | None, frame_id: int) -> bool:
        """Relocalize the lost frame from its features (frame idx of a
        chunk's slot): on success the pose, the carry reset to it in place,
        and the reference keyframe moved to the keyframe that matched."""
        if self.reloc_module is None:
            return False
        self.join_mapper()  # the relocalizer reads the whole map
        with self.trace.span("relocalize"):
            feats = result["feats"] if idx is None else dt.slot_row(result["feats"], idx)
            T = self.reloc_module.relocalize(feats)
            if T is None:
                return False
            self.T_cw = T.astype(np.float32)
            dt.reset_carry_(self.carry, self.cfg, self.T_cw, vo_points=True)
            self.n_inliers = 50
            self.last_reloc_frame_id = frame_id
            self._ref_matches = None
            self.counts["relocalized"] += 1
            kf = self.reloc_module.last_kf
            if kf >= 0 and self.map.kf_valid[kf]:
                self._set_ref_kf(int(kf))
        return True

    def _set_ref_kf(self, kf: int) -> None:
        """Make kf the reference keyframe, in the view (in place) and its
        shadow."""
        m = self.map
        self.ref_kf = kf
        if self.view is not None:
            dt.set_ref_kf(self.view, m, kf)
            self._shadow["ref_desc"] = m.kf_desc[kf].copy()
            self._shadow["ref_angle"] = m.kf_angle[kf].copy()
            self._shadow["ref_mp"] = m.kf_mp_idx[kf].copy()

    # ---------------------------------------------------------- export etc.
    def _on_kf_retired(self, kf: int, parent: int) -> None:
        """Re-anchor the records of a retired keyframe on its spanning-tree
        parent, T_cr' = T_cr T_kf inv(T_parent) (the eager form of the
        reference's replay chain, System.cc:221-224), and the reference
        keyframe with them; the slot can then be reused."""
        m = self.map
        self._ref_matches = None
        M = (m.kf_pose[kf] @ np.linalg.inv(m.kf_pose[parent])).astype(np.float32)
        for r in self.records:
            if r.ref_kf == kf:
                r.T_cr = r.T_cr @ M
                r.ref_kf = parent
        if self.ref_kf == kf:
            self._set_ref_kf(parent)

    def _record(self, timestamp: float, lost: bool) -> None:
        T_ref = self.map.kf_pose[self.ref_kf]
        if lost:
            T_cr = self.records[-1].T_cr if self.records else np.eye(4, dtype=np.float32)
        else:
            T_cr = (self.T_cw @ np.linalg.inv(T_ref)).astype(np.float32)
        self.records.append(FrameRecord(timestamp, self.ref_kf, T_cr, lost))

    def trajectory_rows(self):
        rows = []
        Two = np.linalg.inv(self.map.kf_pose[0])
        for rec in self.records:
            if rec.lost:
                continue
            T_cw = rec.T_cr @ (self.map.kf_pose[rec.ref_kf] @ Two)
            R_wc = T_cw[:3, :3].T
            t_wc = -R_wc @ T_cw[:3, 3]
            rows.append((rec.timestamp, t_wc, se3.rotmat_to_quat_np(R_wc)))
        return rows

    def keyframe_rows(self):
        rows = []
        m = self.map
        for i in range(m.n_kf):
            if not m.kf_valid[i]:
                continue
            T = m.kf_pose[i]
            R_wc = T[:3, :3].T
            t_wc = -R_wc @ T[:3, 3]
            rows.append((m.kf_time[i], t_wc, se3.rotmat_to_quat_np(R_wc)))
        return rows
