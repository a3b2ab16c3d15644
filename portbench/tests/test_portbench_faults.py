"""The check that decides ``correct``, driven through a whole run on the
CPU at a small size (the harness's look for a card skipped): a sound run
comes out correct; the timed path broken underneath comes out not
correct, once for each fault the cell can have; and the control (the
reference in the precision below the port's, put in its place) comes
out not correct.

The faults, in each cell where it can happen: a step that returns its
state unchanged (the first step's result and carry, on every later
call); half of the batch left out (the second half of each chunk's
frames, or of the step's streams, replaced by the first); an answer
altered where it is produced (a BRIEF bit of every keypoint flipped, or
every pose moved by a millimetre, in the step's output); the final pose
solve cut short (one round of one iteration for its four rounds of
five); the Manhattan frame never found.  The cells run on one card, so
there is no exchange between cards to leave out."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from manhattanslam_tpu_torch.frontend import device_tracker, tracking_ops  # noqa: E402
from manhattanslam_tpu_torch.frontend.graphed_step import GraphedStep, clone_tree  # noqa: E402
from manhattanslam_tpu_torch.parallel import mesh  # noqa: E402
from portbench import common, control, judge, run  # noqa: E402

W, H = 192, 144
SEED = 2**31 + 77
CHUNK, LOC = "slam.near_corner.chunk16", "loc8.near_corner"
CELLS = [CHUNK, LOC]


def small(cfg_file):
    f = W / 640
    s = dict(cfg_file["settings"])
    s.update({"Camera.width": W, "Camera.height": H, "Camera.fx": 525.0 * f,
              "Camera.fy": 525.0 * f, "Camera.cx": (W - 1) / 2, "Camera.cy": (H - 1) / 2})
    return dict(cfg_file, settings=s)


def cell_files(cell):
    wl = common.find_workload(common.load_benchmark(), cell)
    cfg = small(common.load_data("configs", wl["config"]))
    traffic = common.load_data("traffic", wl["traffic"])
    return wl, cfg, traffic, common.load_data("cells", cell)["limits"]


def run_small(cell, seconds=8.0):
    torch.set_num_threads(2)
    wl, cfg, traffic, limits = cell_files(cell)
    _, numbers, _ = run.run_cell(wl, cfg, traffic, SEED, seconds, False, "cpu")
    return judge.verdict(numbers, limits), numbers


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    (correct, checks), numbers = run_small(cell)
    assert correct, checks
    assert numbers["compared_frames"] >= 8


@pytest.mark.parametrize("cell", CELLS)
def test_step_returning_its_state_unchanged_is_not_correct(monkeypatch, cell):
    real = GraphedStep.__call__

    def stale(self, *args):
        if not hasattr(self, "_first"):
            result, carry = real(self, *args)
            self._first = (clone_tree(result), clone_tree(carry))
        return self._first

    monkeypatch.setattr(GraphedStep, "__call__", stale)
    (correct, checks), _ = run_small(cell)
    assert not correct, checks


def _second_half_from_first(gray8, d16):
    h = gray8.shape[0] // 2
    g, d = gray8.clone(), d16.clone()
    g[h:], d[h:] = gray8[:h], d16[:h]
    return g, d


def test_half_of_each_chunk_left_out_is_not_correct(monkeypatch):
    real = device_tracker.build_chunk_step

    def build(*args, **kwargs):
        chunk = real(*args, **kwargs)

        def half(gray8, d16, carry, view, out=None):
            return chunk(*_second_half_from_first(gray8, d16), carry, view, out=out)

        half.layouts = chunk.layouts
        return half

    monkeypatch.setattr(device_tracker, "build_chunk_step", build)
    (correct, checks), _ = run_small(CHUNK)
    assert not correct, checks


def test_half_of_the_streams_left_out_is_not_correct(monkeypatch):
    real = mesh.build_throughput_step

    def build(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda gray8, d16, carry, view: step(*_second_half_from_first(gray8, d16),
                                                    carry, view)

    monkeypatch.setattr(mesh, "build_throughput_step", build)
    (correct, checks), _ = run_small(LOC)
    assert not correct, checks


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced_is_not_correct(monkeypatch, cell):
    real = GraphedStep.__call__

    def altered(self, *args):
        result, carry = real(self, *args)
        if "feats" in result:
            result["feats"]["desc"][..., 0] ^= 1
        else:
            result["T"][..., 0, 3] += 1e-3
        return result, carry

    monkeypatch.setattr(GraphedStep, "__call__", altered)
    (correct, checks), _ = run_small(cell)
    assert not correct, checks
    name = "bits_flipped" if cell == CHUNK else "pose_gap_m"
    assert checks[name]["value"] > checks[name]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_final_solve_cut_short_is_not_correct(monkeypatch, cell):
    real = tracking_ops.track_projection

    def short(*args, **kwargs):
        return real(*args, **dict(kwargs, n_rounds=1, n_iters=1))

    monkeypatch.setattr(tracking_ops, "track_projection", short)
    (correct, checks), _ = run_small(cell)
    assert not correct, checks
    assert checks["pose_gap_m"]["value"] > checks["pose_gap_m"]["limit"]


def test_manhattan_frame_never_found_is_not_correct(monkeypatch):
    real = device_tracker.detect_manhattan_device

    def never(*args, **kwargs):
        R, found = real(*args, **kwargs)
        return R, torch.zeros_like(found)

    monkeypatch.setattr(device_tracker, "detect_manhattan_device", never)
    (correct, checks), _ = run_small(CHUNK)
    assert not correct, checks
    assert checks["flags_differ"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """control.readings at the small size: the program's sound numbers
    within their limits, the control's not."""
    torch.set_num_threads(2)
    wl, cfg, traffic, limits = cell_files(cell)
    sound, ctl = control.readings(wl, cfg, traffic, SEED, 8.0, True, "cpu")
    assert judge.verdict(sound, limits)[0], sound
    correct, checks = judge.verdict(ctl, limits)
    assert not correct, checks
