"""Host spans, counters and the fused step's branch marks of the port
(manhattanslam_tpu_torch/tracing.py), on the CPU at small_cfg size.

- Spans nest by path; a span's self time is its seconds less its
  children's; snapshots diff; a span is a profiler range only while a
  profiler is active.
- A chunk-mode System keeps ``FastTracker.perf``'s sections and their
  sum; the dispatch's children, the intake and the keyframe hooks are
  spans of the System's recorder.
- ``GraphedStep.branch_times`` on the CPU: the six branches of the full
  body in order, each timed; the step's outputs and carry after it are
  bit-equal to those of a tracker that never ran it.  The same on the
  batched throughput step (``step.graphed``).

The card's timing capture (event nodes, node counts) is in
tests/test_torch_cuda.py.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from manhattanslam_tpu_torch import tracing
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu_torch.frontend.fast_tracking import SECTIONS, FastTracker
from manhattanslam_tpu_torch.parallel import mesh
from manhattanslam_tpu_torch.slam_map import SlamMap
from manhattanslam_tpu_torch.system import System
from torch_parity import port_cfg

CPU = torch.device("cpu")
BRANCHES = ["extract", "candidate_solves", "planes", "manhattan_solve", "lines", "final_solve"]


def _busy(seconds: float) -> None:
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def test_spans_nest_and_self_time_is_the_duration_less_the_children():
    rec = tracing.Recorder()
    with rec.span("a"):
        _busy(0.002)
        with rec.span("b"):
            _busy(0.001)
        with rec.span("c"):
            with rec.span("b"):
                _busy(0.001)
        with rec.span("b"):
            pass
    rec.count("frames", 3)
    first = rec.snapshot()
    sp = first["spans"]
    assert set(sp) == {"a", "a/b", "a/c", "a/c/b"}
    assert [sp[p][1] for p in ("a", "a/b", "a/c", "a/c/b")] == [1, 2, 1, 1]
    s_a, _, own_a = sp["a"]
    assert own_a == pytest.approx(s_a - sp["a/b"][0] - sp["a/c"][0], abs=1e-12)
    assert own_a >= 0.002
    assert sp["a/c"][2] == pytest.approx(sp["a/c"][0] - sp["a/c/b"][0], abs=1e-12)
    assert sp["a/c/b"][2] == sp["a/c/b"][0] >= 0.001  # a leaf is all self
    assert tracing.by_leaf(first, ("b",)) == {"b": (sp["a/b"][0] + sp["a/c/b"][0], 3)}

    with rec.span("a"):
        with rec.span("b"):
            pass
    rec.count("frames")
    d = tracing.diff(first, rec.snapshot())
    assert set(d["spans"]) == {"a", "a/b"} and d["spans"]["a"][1] == d["spans"]["a/b"][1] == 1
    assert d["counters"] == {"frames": 1}
    assert "a/c/b" in tracing.table(first) and rec._stack == []


def test_a_span_is_a_profiler_range_only_under_a_profiler(monkeypatch):
    rec = tracing.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("chunk_dispatch"):
            with rec.span("step.launch"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"mslam.chunk_dispatch", "mslam.chunk_dispatch/step.launch"} <= names

    def entered(*args, **kwargs):
        raise AssertionError("a record_function range with no profiler active")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", entered)
    with rec.span("chunk_dispatch"):
        pass
    assert rec.snapshot()["spans"]["chunk_dispatch"][1] == 2


def test_chunk_mode_keeps_the_tracker_sections_and_their_sum(small_cfg):
    cfg = port_cfg(small_cfg)
    seq = SyntheticSequence(n_frames=13, cam=cfg.camera, view="corner")
    system = System(cfg, fast=True, pipeline=True, chunk=4, enable_planes=False,
                    enable_lines=False, enable_surfels=False, device="cpu")
    tr = system.tracker
    for i in range(13):
        if i == 5:
            tr.force_keyframe = True
        ts, gray, depth = seq.frame(i)
        system.track(gray, depth, ts)
    system.shutdown()
    assert tr.counts["keyframes"] >= 2
    snap = system.trace.snapshot()
    perf, perf_n = tr.perf, tr.perf_n
    # the sections the tracker timed before it had a recorder, and no other
    assert set(perf) == set(perf_n) == {
        "chunk_dispatch", "summary_pull", "mapper_join", "keyframe_event", "kf_payload_pull",
        "kf_bookkeeping", "kf_view_diff", "mapping_backend", "backend_view_diff"}
    assert perf_n["chunk_dispatch"] == perf_n["summary_pull"] == 3  # 12 frames in chunks of 4
    leaves = tracing.by_leaf(snap)
    assert perf == {k: leaves[k][0] for k in SECTIONS if k in leaves}
    assert sum(perf.values()) == pytest.approx(sum(
        s for p, (s, _, _) in snap["spans"].items() if p.rsplit("/", 1)[-1] in SECTIONS))
    # the dispatch's children: per frame of a chunk, then per chunk
    sp = snap["spans"]
    kids = {p.split("/", 1)[1]: v for p, v in sp.items() if p.startswith("chunk_dispatch/")}
    assert set(kids) == {"step.inputs", "step.launch", "stats", "copy_out", "flat", "pull"}
    assert [kids[k][1] for k in ("step.inputs", "step.launch", "stats", "copy_out")] == [12] * 4
    assert kids["flat"][1] == kids["pull"][1] == 3
    s, _, own = sp["chunk_dispatch"]
    assert own == pytest.approx(s - sum(v[0] for v in kids.values()), abs=1e-9) and own > 0
    # the frames' intake (System and tracker), and the keyframe hooks with
    # the back end's stages, outside the sections' sum
    assert sp["intake"][1] == 2 * 13
    hooks = {k: n for k, (_, n) in leaves.items()}
    assert hooks["keyframe.local_mapper"] == hooks["keyframe.reloc_add"] == tr.counts["keyframes"]
    assert hooks["cull_map_points"] == hooks["cull_map_lines"] == tr.counts["keyframes"]
    assert any(p.endswith("mapping_backend/keyframe.local_mapper/create_and_fuse") for p in sp)


@pytest.fixture(scope="module")
def full_body(small_cfg):
    """Two trackers with planes and lines over the same three near_corner
    frames; the first ran branch_times between its second and third."""
    cfg = port_cfg(small_cfg)
    seq = SyntheticSequence(n_frames=3, cam=cfg.camera, view="near_corner")
    timed, plain = (FastTracker(cfg, SlamMap(cfg), CPU, enable_planes=True, enable_lines=True)
                    for _ in range(2))
    times = None
    for i in range(3):
        if i == 2:
            times = timed.step.branch_times(timed.view, reps=2)
        ts, gray, depth = seq.frame(i)
        timed.track(ts, gray, depth)
        plain.track(ts, gray, depth)
    return cfg, seq, timed, plain, times


def test_branch_times_on_the_cpu_give_the_six_branches_in_order(full_body):
    *_, times = full_body
    assert list(times) == BRANCHES
    assert all(t["ms"] > 0 and t["ops"] is None for t in times.values())


def _equal_trees(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


def test_a_timing_run_leaves_the_step_as_it_was(full_body):
    _, _, timed, plain, _ = full_body
    _equal_trees(timed.last_result, plain.last_result)
    _equal_trees(timed.carry, plain.carry)
    np.testing.assert_array_equal(timed.T_cw, plain.T_cw)
    assert timed.step.calls == plain.step.calls == 3


def test_throughput_step_exposes_its_graphed_step(full_body):
    cfg, _, timed, _, _ = full_body
    step = mesh.build_throughput_step(cfg, 1, CPU)
    g8, d16 = (f[None].clone() for f in timed.step._frames)  # the last frame, natively
    result, carry = step(g8, d16, mesh.init_batched_carry(cfg, 1, CPU), timed.view)
    sp = step.graphed.trace.snapshot()["spans"]
    assert {"step.inputs", "step.launch", "clone_out"} <= set(sp)
    times = step.graphed.branch_times(timed.view, reps=1)
    assert list(times) == BRANCHES
    again, carry2 = step(g8, d16, mesh.init_batched_carry(cfg, 1, CPU), timed.view)
    _equal_trees(result, again)
    _equal_trees(carry, carry2)
