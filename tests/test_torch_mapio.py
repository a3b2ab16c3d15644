"""Map persistence and the viewer in the port, on the CPU at small_cfg size.

- The viewer's two snapshots from ``System(fast=True, enable_surfels=False,
  use_viewer=True, device="cpu")`` over 8 corner frames, each over 10 kB
  (tests/test_viewer_mapio.py's bar), and the viewer following a reset.
- A round trip of that System's map after two clones of keyframe 0 are
  added and one retired, so that ``kf_free`` is not empty and
  ``last_kf_added`` moved: every ``_ARRAYS`` table and every scalar equal.
- A loaded System reuses the retired slot, parents its next keyframe on
  the saved last keyframe, and carries the map's Manhattan registries into
  the fused tracker's view.
- Localizing against the loaded map (tests/test_viewer_mapio.py:46-64),
  at chunk 1 and in chunks (the flat layouts then come from the chunk
  step).
- Cross-loading: a reference ``SlamMap`` filled from a seed (numpy only,
  no JAX program) saved by the reference's ``map_io`` loads in the port,
  and the port's file loads in the reference, every table equal.
- The reference's two faults pinned: its loader leaves ``kf_free == []``
  and ``last_kf_added == -1`` whatever was saved; the port keeps both,
  and reads a reference file (which lacks them) as the reference does.
- ``System.Track`` is ``System.track``; ``System.__init__`` has the
  reference's parameters in the reference's order, then ``device``.
"""

import inspect

import numpy as np
import pytest

from manhattanslam_tpu.io import map_io as jmap_io
from manhattanslam_tpu.slam_map import SlamMap as JaxSlamMap
from manhattanslam_tpu.system import System as JaxSystem
from manhattanslam_tpu_torch.datasets.synthetic import SyntheticSequence
from manhattanslam_tpu_torch.io import map_io
from manhattanslam_tpu_torch.slam_map import SlamMap
from manhattanslam_tpu_torch.system import System
from torch_parity import port_cfg

CPU = "cpu"
SCALARS = ("n_kf", "last_kf_added", "kf_free", "kf_not_erase", "manhattan_pairs",
           "manhattan_triples")


def _scalars(m) -> dict:
    return {"n_kf": int(m.n_kf), "last_kf_added": int(m.last_kf_added),
            "kf_free": [int(k) for k in m.kf_free],
            "kf_not_erase": sorted(int(k) for k in m.kf_not_erase),
            "manhattan_pairs": dict(m.manhattan_pairs),
            "manhattan_triples": dict(m.manhattan_triples)}


def _assert_tables_equal(a, b) -> None:
    for name in map_io._ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.fixture(scope="module")
def run_sys(small_cfg):
    cfg = port_cfg(small_cfg)
    seq = SyntheticSequence(n_frames=8, cam=cfg.camera, view="corner")
    system = System(cfg, fast=True, enable_surfels=False, use_viewer=True, device=CPU)
    for i in range(len(seq)):
        t, gray, depth = seq.frame(i)
        system.track(gray, depth, t)
    return cfg, seq, system


@pytest.fixture(scope="module")
def retired(run_sys, tmp_path_factory):
    """The run's map with two clones of keyframe 0 added and the first
    retired, saved; returns (map, path)."""
    _, _, system = run_sys
    m = system.map
    kf0 = {"xy_und": m.kf_xy[0], "u_right": m.kf_uright[0], "depth": m.kf_depth[0],
           "level": m.kf_level[0], "angle": m.kf_angle[0], "desc": m.kf_desc[0],
           "valid": m.kf_kp_valid[0]}
    clones = []
    for k in range(2):
        kf = m.add_keyframe(m.kf_pose[0], 0.01 * (k + 1), 0, kf0)
        m.set_kf_matches(kf, m.kf_mp_idx[0])
        clones.append(kf)
    m.retire_keyframe(clones[0])
    assert m.kf_free == [clones[0]] and m.last_kf_added == clones[1]
    path = str(tmp_path_factory.mktemp("mapio") / "map.npz")
    system.save_map(path)
    return m, path


def test_viewer_snapshots(run_sys, tmp_path):
    cfg, seq, system = run_sys
    assert system.viewer is not None and system.viewer.tracker is system.tracker
    mp, fp = tmp_path / "map.png", tmp_path / "frame.png"
    system.viewer.save_map_png(str(mp))
    system.viewer.save_frame_png(str(fp), seq.frame(0)[1])
    assert mp.stat().st_size > 10000
    assert fp.stat().st_size > 10000
    # the tracked keypoints the frame render marks: the last frame's matches
    assert (system.tracker.last_mp_idx >= 0).sum() > 30


def test_viewer_follows_a_reset(small_cfg):
    cfg = port_cfg(small_cfg)
    system = System(cfg, fast=True, enable_surfels=False, use_viewer=True, device=CPU)
    system.reset()
    assert system.viewer.tracker is system.tracker and system.viewer.map is system.map
    assert System(cfg, fast=True, enable_surfels=False, device=CPU).viewer is None


def test_map_round_trip_keeps_retired_slots(run_sys, retired):
    cfg, _, _ = run_sys
    m, path = retired
    loaded = map_io.load_map(path, SlamMap(cfg))
    _assert_tables_equal(loaded, m)
    assert _scalars(loaded) == _scalars(m)
    assert loaded.kf_free and loaded.last_kf_added >= 0


def test_system_load_map_resumes(run_sys, retired):
    """A loaded System reuses the retired slot for its next keyframe and
    gives it the saved last keyframe as its parent."""
    cfg, _, first = run_sys
    m, path = retired
    system = System(cfg, fast=True, enable_surfels=False, device=CPU)
    system.load_map(path)
    assert _scalars(system.map) == _scalars(m)
    assert system.tracker.view is not None
    # the fused tracker's dense Manhattan registries follow the loaded map
    assert m.manhattan_pairs
    np.testing.assert_array_equal(system.tracker.reg2, first.tracker.reg2)
    np.testing.assert_array_equal(system.tracker.reg3, first.tracker.reg3)
    np.testing.assert_array_equal(system.tracker.view["reg2"].numpy(), first.tracker.reg2)
    free, parent = m.kf_free[0], m.last_kf_added
    kf0 = {"xy_und": m.kf_xy[0], "u_right": m.kf_uright[0], "depth": m.kf_depth[0],
           "level": m.kf_level[0], "angle": m.kf_angle[0], "desc": m.kf_desc[0],
           "valid": m.kf_kp_valid[0]}
    kf = system.map.add_keyframe(m.kf_pose[0], 1.0, 0, kf0)
    assert kf == free and system.map.kf_parent[kf] == parent


def test_localize_against_loaded_map(run_sys, tmp_path):
    """Relocalize-only against a restored checkpoint (kidnapped robot),
    tests/test_viewer_mapio.py:46-64 on the port."""
    cfg, seq, system = run_sys
    p = str(tmp_path / "map.npz")
    system.save_map(p)
    sys2 = System(cfg, fast=True, enable_surfels=False, device=CPU)
    sys2.load_map(p)
    sys2.activate_localization_mode()
    sys2.tracker.state = "LOST"
    sys2.tracker.frame_id = 100
    recovered = False
    for i in range(3):
        t, gray, depth = seq.frame(i)
        if sys2.track(gray, depth, 100.0 + i) is not None:
            recovered = True
            break
    assert recovered
    assert sys2.map.n_kf == system.map.n_kf  # localization mode adds no keyframe


def _seeded_reference_map(small_cfg) -> JaxSlamMap:
    """A reference SlamMap with every table filled from a seed, in each
    table's own dtype, and its scalars, registries and lifecycle set."""
    rng = np.random.default_rng(13)
    m = JaxSlamMap(small_cfg)
    for name in map_io._ARRAYS:
        a = getattr(m, name)
        if a.dtype == bool:
            a[...] = rng.random(a.shape) < 0.5
        elif a.dtype == np.uint32:
            a[...] = rng.integers(0, 2**32, a.shape, dtype=np.uint32)
        elif np.issubdtype(a.dtype, np.integer):
            a[...] = rng.integers(-1, 1000, a.shape)
        else:
            a[...] = rng.normal(size=a.shape)
    m.n_kf = 9
    m.kf_free = [4, 2]
    m.last_kf_added = 7
    m.manhattan_pairs = {(1, 3): 2, (0, 5): 6}
    m.manhattan_triples = {(0, 1, 3): 2}
    m.kf_not_erase = {2, 6}
    return m


def test_reference_file_loads_in_the_port(small_cfg, tmp_path):
    ref = _seeded_reference_map(small_cfg)
    p = str(tmp_path / "ref.npz")
    jmap_io.save_map(p, ref)
    port = map_io.load_map(p, SlamMap(port_cfg(small_cfg)))
    _assert_tables_equal(port, ref)
    # the file lacks the retired slots and the last keyframe: the port
    # reads it as the reference does
    assert _scalars(port) == {**_scalars(ref), "kf_free": [], "last_kf_added": -1}


def test_port_file_loads_in_the_reference(small_cfg, tmp_path):
    """And the reference's two faults: its loader drops kf_free and
    last_kf_added (map_io.py:56-72 reads neither), the port keeps them."""
    ref = _seeded_reference_map(small_cfg)
    port = SlamMap(port_cfg(small_cfg))
    for name in map_io._ARRAYS:
        getattr(port, name)[...] = getattr(ref, name)
    for k in ("n_kf", "kf_free", "last_kf_added", "manhattan_pairs", "manhattan_triples",
              "kf_not_erase"):
        setattr(port, k, getattr(ref, k))
    p = str(tmp_path / "port.npz")
    map_io.save_map(p, port)
    back = jmap_io.load_map(p, JaxSlamMap(small_cfg))
    _assert_tables_equal(back, port)
    assert back.kf_free == [] and back.last_kf_added == -1  # the reference's faults
    assert _scalars(back) == {**_scalars(port), "kf_free": [], "last_kf_added": -1}
    again = map_io.load_map(p, SlamMap(port_cfg(small_cfg)))
    assert _scalars(again) == _scalars(port)
    assert again.kf_free == [4, 2] and again.last_kf_added == 7


def test_track_alias_and_signature():
    assert System.Track is System.track
    ref = list(inspect.signature(JaxSystem.__init__).parameters)
    port = list(inspect.signature(System.__init__).parameters)
    assert port == ref + ["device"]


def test_chunked_system_tracks_on_a_loaded_map(run_sys, tmp_path):
    """A chunk-mode System that loads a map and starts LOST (no first
    frame of its own) takes the flat layouts from its chunk step, and
    localizes in chunks."""
    cfg, seq, system = run_sys
    p = str(tmp_path / "map.npz")
    system.save_map(p)
    sys2 = System(cfg, fast=True, enable_surfels=False, chunk=4, device=CPU)
    sys2.load_map(p)
    sys2.activate_localization_mode()
    sys2.tracker.state, sys2.tracker.frame_id = "LOST", 100
    for i in range(8):
        t, gray, depth = seq.frame(i)
        sys2.track(gray, depth, 100.0 + i)
    sys2.shutdown()
    assert sys2.tracker.layouts is not None
    assert sum(not r.lost for r in sys2.tracker.records) >= 6
