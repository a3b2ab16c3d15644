"""The ``system`` entry: the port's ``System`` fed one sensor frame per
``track`` call, closed loop, as the configuration and the traffic say.

Set-up renders one period of the traffic's path, makes the System, and
runs bench.py's warm-up (``warmup_frames`` frames with a keyframe forced
at ``force_keyframe_at``, ``flush`` and ``warmup``).  The window feeds the
period cyclically from where the warm-up stopped, timing every call, and
ends with ``shutdown``; frames in flight are flushed inside it.  At the
chunks or frames the seed picks, the step's carry and map view before
them and its features, planes, lines, poses and flags are copied out on
the card (a few megabytes) for the check; the trajectory after the
window gives the ATE.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from manhattanslam_tpu_torch.config import config_from_dict
from manhattanslam_tpu_torch.frontend import device_tracker as dt
from manhattanslam_tpu_torch.system import System
from portbench import judge
from portbench.scene.poses import relative_cw
from portbench.scene.traffic import camera_of, period_poses, render_period, sample_events

FPS = 30.0
# FastTracker.perf sections that wait for the card's results
PULL_SECTIONS = ("summary_pull",)


def program_config(cfg_file: dict):
    """The port's SlamConfig from the settings, checked against the
    numbers the file states for the port's defaults (each key
    ``group.field`` of the file's ``defaults``)."""
    cfg = config_from_dict(dict(cfg_file["settings"]))
    for key, want in cfg_file["defaults"].items():
        group, field = key.split(".")
        have = getattr(getattr(cfg, group), field)
        if float(have) != float(want):
            raise ValueError(f"the port runs {key} = {have}, the configuration file states "
                             f"{want}")
    return cfg


class SystemDriver:
    def __init__(self, cfg_file: dict, traffic: dict, seed: int, device):
        self.traffic = traffic
        self.device = torch.device(device)
        self.cfg = program_config(cfg_file)
        self.poses = period_poses(traffic)
        t0 = time.perf_counter()
        self.rgb, self.d16 = render_period(camera_of(cfg_file["settings"]), self.poses, seed,
                                           self.device)
        self.setup_parts = {"render_s": time.perf_counter() - t0}
        flags = cfg_file["system"]
        self.system = System(self.cfg, fast=flags["fast"], enable_planes=flags["enable_planes"],
                             enable_lines=flags["enable_lines"],
                             enable_surfels=flags["enable_surfels"],
                             pipeline=traffic["pipeline"], chunk=traffic["chunk"],
                             device=self.device)
        self.k = 0  # frames handed in so far
        self.samples = {}  # window event -> (frames, state before them, copied outputs)
        self.events = sample_events(seed, traffic["sample_span"], traffic["samples"])
        t1 = time.perf_counter()
        self._warm_up()
        self.setup_parts["system_s"] = t1 - t0 - self.setup_parts["render_s"]
        self.setup_parts["warmup_s"] = time.perf_counter() - t1

    def _feed(self, k: int):
        i = k % len(self.poses)
        return self.system.track(self.rgb[i], self.d16[i], k / FPS)

    def _warm_up(self) -> None:
        for k in range(self.traffic["warmup_frames"]):
            if k == self.traffic["force_keyframe_at"]:
                self.system.tracker.force_keyframe = True
            self._feed(k)
        self.k = self.traffic["warmup_frames"]
        self.system.tracker.flush()
        self.system.warmup()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def feed_for(self, seconds: float, sample: bool = False, span=contextlib.nullcontext,
                 frames: int | None = None) -> tuple[int, list]:
        """Hand in frames for `seconds` (or `frames` of them), each call
        inside ``span()``, sampling the seed's events when asked.  Returns
        (the first frame's number, each call's ms)."""
        chunk = self.traffic["chunk"]
        tr = self.system.tracker
        reloc0, resets0 = tr.counts["relocalized"], self.system.n_resets
        first, call_ms = self.k, []
        t0 = time.perf_counter()
        while (self.k - first < frames) if frames is not None else (
                time.perf_counter() - t0 < seconds):
            j = self.k - first
            event = j // chunk if sample and (j + 1) % chunk == 0 else None
            state = self._state() if event in self.events else None
            c0 = time.perf_counter()
            with span():
                self._feed(self.k)
            call_ms.append((time.perf_counter() - c0) * 1e3)
            self.k += 1
            if state is not None:
                self._sample(event, first + j - chunk + 1, state, reloc0, resets0)
        return first, call_ms

    def finish(self) -> None:
        """``shutdown``: the frames in flight and the deferred back end."""
        self.system.shutdown()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        """The timed window: frames for `seconds`, then ``shutdown``;
        returns what the metrics read."""
        tr = self.system.tracker
        perf0 = dict(tr.perf)
        kf0 = tr.counts["keyframes"]
        resets0 = self.system.n_resets
        t0 = time.perf_counter()
        first, call_ms = self.feed_for(seconds, sample=True)
        self.finish()
        window_s = time.perf_counter() - t0
        tr = self.system.tracker
        sections = {k: v - perf0.get(k, 0.0) for k, v in tr.perf.items()}
        return {
            "frames": self.k - first, "window_s": window_s, "call_ms": call_ms,
            "first_frame": first, "host_sections_s": sections,
            "host_perf_s": sum(v for k, v in sections.items() if k not in PULL_SECTIONS)
            if self.system.n_resets == resets0 else None,
            "keyframes": tr.counts["keyframes"] - kf0,
        }

    def traced_window(self, seconds: float, trace_fn, span) -> dict:
        """The steady state under the profiler: two dispatches' worth of
        frames handed in first (the pipeline full), then `seconds` of
        frames traced, then ``shutdown`` outside the trace."""
        self.feed_for(0.0, frames=2 * self.traffic["chunk"])
        k0 = self.k
        out = trace_fn(lambda: self.feed_for(seconds, span=span))
        out["frames"] = self.k - k0
        out["launch_frames"] = [[i] for i in sorted({k % len(self.poses)
                                                     for k in range(k0, self.k)})]
        self.finish()
        return out

    def _state(self) -> tuple[dict, dict]:
        """A copy of the step's carry and map view as the next dispatch
        will read them (copied on the card, in the order of its work)."""
        tr = self.system.tracker
        return ({k: v[None].clone() for k, v in tr.carry.items()},
                {k: v.clone() for k, v in tr.view.items()})

    def _sample(self, event: int, frame0: int, state: tuple, reloc0: int, resets0: int) -> None:
        """Keep the chunk (or frame) just dispatched: the state it started
        from and a copy of its features, payload (planes, lines) and core
        (pose, flags); in chunks, only while no relocalization or reset has
        moved the frames' order in them."""
        tr = self.system.tracker
        moved = tr.counts["relocalized"] != reloc0 or self.system.n_resets != resets0
        if moved and self.traffic["chunk"] > 1:
            return
        r = tr.last_result
        core = r["core_flat"] if "core_flat" in r else r["summary_flat"]
        self.samples[event] = (list(range(frame0, frame0 + self.traffic["chunk"])), state,
                               {k: v.clone() for k, v in r["feats"].items()},
                               r["payload_flat"].clone(), core.clone())

    def trajectory(self, first: int, last: int) -> dict[int, np.ndarray]:
        """Frame number -> the camera centre the tracker returned for it,
        for the frames first..last-1 it tracked."""
        out = {}
        for ts, t_wc, _ in self.system.tracker.trajectory_rows():
            k = int(round(ts * FPS))
            if first <= k < last:
                out[k] = np.asarray(t_wc, np.float64)
        return out

    def step_device_ms(self, reps: int = 20) -> float | None:
        """The step's graph replayed back to back between two CUDA events:
        device ms per frame."""
        graph = getattr(self.system.tracker.step, "graph", None)
        if graph is None or self.device.type != "cuda":
            return None
        graph.replay()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def program_outputs(self) -> list[tuple[list[int], tuple, list[dict]]]:
        """(frame numbers, the state before them (carry with a stream axis,
        view), each frame's features, planes, lines, pose and flags as
        numpy) of each sample."""
        layouts = self.system.tracker.layouts
        lead = self.traffic["chunk"] > 1
        out = []
        for frames, state, feats, payload, core in self.samples.values():
            host = {k: v.cpu().numpy() for k, v in feats.items()}
            flat, core = payload.cpu().numpy(), core.cpu().numpy()
            rows = []
            for n in range(len(frames)):
                f = {key: (v[n] if lead else v) for key, v in host.items()}
                f.update(dt.unpack_flat(flat[n] if lead else flat, layouts["payload"]))
                c = core[n] if lead else core
                f.update(dt.unpack_flat(c[:dt.layout_size(layouts["core"])], layouts["core"]))
                rows.append(f)
            out.append((frames, state, rows))
        return out

    def free(self) -> list:
        """Pull what the check needs, then drop the program's state."""
        outputs = self.program_outputs()
        self.system = None
        self.samples = {}
        return outputs

    def sensor_steps(self, frames: list[int]) -> list[tuple[np.ndarray, np.ndarray]]:
        """The sensor frames handed in as frames `frames`, each as a step of
        one stream: (gray8 (1, H, W), depth (1, H, W))."""
        P = len(self.poses)
        return [(self.rgb[k % P, None, ..., 0], self.d16[k % P, None]) for k in frames]

    def failed(self, ctx: dict) -> int:
        """The window's frames the tracker returned no pose for (lost);
        keeps the trajectory for the ATE."""
        first = ctx["first_frame"]
        self._traj = self.trajectory(first, first + ctx["frames"])
        return ctx["frames"] - len(self._traj)

    def check_numbers(self, outputs: list, ref: dict) -> dict:
        """The numbers of judge.py for this run."""
        traj = self._traj
        ks = sorted(traj)
        est, gt = np.zeros((0, 3)), np.zeros((0, 3))
        if ks:
            est = np.stack([traj[k] for k in ks])
            gt = judge.centres(relative_cw(self.poses, [k % len(self.poses) for k in ks]))
        tally = judge.FrameTally()
        for frames, (carry, view), prog in outputs:
            refs = judge.reference_frames(self.sensor_steps(frames), carry, view, ref,
                                          self.device)
            for p, r in zip(prog, refs):
                tally.add(p, r)
        return {"ate_m": judge.ate(est, gt), **judge.tally_numbers(tally)}


DRIVER = SystemDriver
