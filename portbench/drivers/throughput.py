"""The ``throughput`` entry: the port's batched localization step
(``parallel/mesh.build_throughput_step``) for B streams against one shared
map view, closed loop: each step's B frames are uploaded from the host, as
the sensors deliver them (staged in pinned memory while the card runs the
step before), and each step's poses and flags come back to the host
before the next step goes in.

Set-up renders one period of the traffic's path, makes the shared view
from frame 0 (keyframe 0 of a tracker with planes and lines,
``parallel/replay.shared_view``), puts stream s at frame
``stream_offset * s`` of the period at its ground-truth pose, and runs
``warmup_steps`` steps (the eager first call, the graph's capture, a
replay).  The window runs steps for its seconds; each stream goes on
through the period cyclically.  At the steps the seed picks, the carry
before the step and the step's poses and flags are copied out on the card
for the check.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from manhattanslam_tpu_torch.parallel import mesh, replay
from portbench import judge
from portbench.drivers.system import program_config
from portbench.scene.poses import relative_cw
from portbench.scene.traffic import camera_of, period_poses, render_period, sample_events

FLAG_KEYS = ("tracked_ok", "manhattan_found", "use_manhattan")


class ThroughputDriver:
    def __init__(self, cfg_file: dict, traffic: dict, seed: int, device):
        self.traffic = traffic
        self.device = torch.device(device)
        self.cfg = program_config(cfg_file)
        self.B = int(cfg_file["streams"])
        self.poses = period_poses(traffic)
        t0 = time.perf_counter()
        self.rgb, self.d16 = render_period(camera_of(cfg_file["settings"]), self.poses, seed,
                                           self.device)
        t1 = time.perf_counter()
        self.view, _ = replay.shared_view(self.cfg, (0.0, self.rgb[0, ..., 0], self.d16[0]),
                                          self.device)
        self.step = mesh.build_throughput_step(self.cfg, self.B, self.device)
        self.first = [traffic["stream_offset"] * s for s in range(self.B)]
        self.carry = mesh.init_batched_carry(self.cfg, self.B, self.device)
        self.carry["T_last"] = torch.from_numpy(
            relative_cw(self.poses, self.first).astype(np.float32)).to(self.device)
        pin = self.device.type == "cuda"
        hw = (self.B,) + self.d16.shape[1:]
        self._stage = [(torch.empty(hw, dtype=torch.uint8, pin_memory=pin),
                        torch.empty(hw, dtype=torch.int32, pin_memory=pin)) for _ in range(2)]
        self._staged = None  # the step whose frames were staged last
        self.i = 0  # steps run so far
        self.samples = {}  # window step -> (step number, carry before it, its poses and flags)
        self.events = sample_events(seed, traffic["sample_span"], traffic["samples"])
        t2 = time.perf_counter()
        for _ in range(traffic["warmup_steps"]):
            self._run_step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_parts = {"render_s": t1 - t0, "system_s": t2 - t1,
                            "warmup_s": time.perf_counter() - t2}

    def _idx(self, i: int) -> list[int]:
        """The period index of each stream's frame at step i."""
        return [(f + i) % len(self.poses) for f in self.first]

    def _stage_frames(self, i: int) -> None:
        """Copy step i's frames, as the sensors deliver them, into the
        pinned staging pair i % 2 (the pair step i - 2 read, whose copies
        its pull has drained)."""
        g8, d16 = self._stage[i % 2]
        gh, dh = g8.numpy(), d16.numpy()
        for b, f in enumerate(self._idx(i)):
            gh[b] = self.rgb[f, ..., 0]
            dh[b] = self.d16[f]
        self._staged = i

    def _frames(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Step i's frames uploaded from their staging pair without
        blocking: gray8 and depth (B, H, W) on the card."""
        if self._staged != i:
            self._stage_frames(i)
        g8, d16 = self._stage[i % 2]
        return g8.to(self.device, non_blocking=True), d16.to(self.device, non_blocking=True)

    def _run_step(self, take: bool = False, event: int | None = None) -> np.ndarray:
        """One step; the next step's frames are staged while the card runs
        it, and its poses and flags come back before it returns.  Returns
        each stream's tracked flag (B,), with each stream's pose in
        self.last_T (B, 4, 4)."""
        g8, d16 = self._frames(self.i)
        state = {k: v.clone() for k, v in self.carry.items()} if take else None
        result, self.carry = self.step(g8, d16, self.carry, self.view)
        if take:
            self.samples[event] = (self.i, state, {k: result[k].clone()
                                                   for k in ("T",) + FLAG_KEYS})
        self._stage_frames(self.i + 1)
        back = torch.cat([result["T"].reshape(self.B, 16),
                          result["tracked_ok"].to(torch.float32)[:, None]], 1).cpu().numpy()
        self.last_T = back[:, :16].reshape(self.B, 4, 4)
        self.i += 1
        return back[:, 16] > 0.5

    def feed_for(self, seconds: float, sample: bool = False, span=contextlib.nullcontext,
                 steps: int | None = None) -> tuple[int, list, list]:
        """Run steps for `seconds` (or `steps` of them), each inside
        ``span()``, sampling the seed's events when asked.  Returns (the
        first step's number, each step's ms, each step's (step, poses,
        flags))."""
        first, call_ms, rows = self.i, [], []
        t0 = time.perf_counter()
        while (self.i - first < steps) if steps is not None else (
                time.perf_counter() - t0 < seconds):
            j = self.i - first
            take = sample and j in self.events
            c0 = time.perf_counter()
            with span():
                ok = self._run_step(take, j)
            call_ms.append((time.perf_counter() - c0) * 1e3)
            rows.append((self.i - 1, self.last_T, ok))
        return first, call_ms, rows

    def window(self, seconds: float) -> dict:
        """The timed window: steps for `seconds`; returns what the metrics
        read (frames are stream-frames)."""
        t0 = time.perf_counter()
        first, call_ms, rows = self.feed_for(seconds, sample=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - t0
        self._rows = rows
        return {"frames": len(rows) * self.B, "window_s": window_s, "call_ms": call_ms,
                "first_frame": first, "host_perf_s": None}

    def traced_window(self, seconds: float, trace_fn, span) -> dict:
        """Two steps, then `seconds` of steps under the profiler."""
        self.feed_for(0.0, steps=2)
        i0 = self.i
        out = trace_fn(lambda: self.feed_for(seconds, span=span))
        out["frames"] = (self.i - i0) * self.B
        out["launch_frames"] = [self._idx(i) for i in range(i0, self.i)]
        return out

    def step_device_ms(self, reps: int = 20) -> float | None:
        """The step (its graph, the frames' and the carry's copies in, the
        result's out) run back to back between two CUDA events on one
        step's frames: device ms per stream-frame."""
        if self.device.type != "cuda":
            return None
        g8, d16 = (x.clone() for x in self._frames(self.i))
        carry = {k: v.clone() for k, v in self.carry.items()}
        self.step(g8, d16, carry, self.view)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            self.step(g8, d16, carry, self.view)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps / self.B

    def failed(self, ctx: dict) -> int:
        """The window's stream-frames the step returned as not tracked."""
        return int(sum((~ok).sum() for _, _, ok in self._rows))

    def free(self) -> list:
        """Pull what the check needs, then drop the step (its graph)."""
        out = []
        for i, carry, result in self.samples.values():
            host = {k: v.cpu().numpy() for k, v in result.items()}
            rows = [{k: v[b] for k, v in host.items()} for b in range(self.B)]
            out.append(([i], (carry, self.view), rows))
        self.step = None
        self.samples = {}
        return out

    def sensor_steps(self, steps: list[int]) -> list[tuple[np.ndarray, np.ndarray]]:
        """The sensor frames of steps `steps`: (gray8 (B, H, W), depth (B, H, W))."""
        return [(self.rgb[self._idx(i), ..., 0], self.d16[self._idx(i)]) for i in steps]

    def check_numbers(self, outputs: list, ref: dict) -> dict:
        """The numbers of judge.py for this run."""
        est = [judge.centres(T) for _, T, _ in self._rows]
        gt = [judge.centres(relative_cw(self.poses, self._idx(i))) for i, _, _ in self._rows]
        tally = judge.FrameTally()
        for steps, (carry, view), prog in outputs:
            refs = judge.reference_frames(self.sensor_steps(steps), carry, view, ref,
                                          self.device)
            for p, r in zip(prog, refs):
                tally.add(p, r)
        ate = judge.ate(np.concatenate(est), np.concatenate(gt)) if est else float("nan")
        return {"ate_m": ate, **judge.tally_numbers(tally)}


DRIVER = ThroughputDriver
