"""The harness on the CPU: BENCHMARK.json against the contract it is
written to, every file found by its name, no JAX anywhere under
portbench/, the kernels' counts against chip_smoke.py's, and the
arithmetic of the metrics and the check on fixed inputs."""

import ast
import json
import math
import re
import statistics
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import common, counts, judge, trace  # noqa: E402
from portbench.reference import orb as ref_orb  # noqa: E402

BENCH = common.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


# ------------------------------------------------------------ the contract
def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert all(LINE.match(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs_and_workloads():
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    for c in cfgs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in cfgs.values()}) == len(cfgs)
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in BENCH["workloads"]} == set(cfgs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and LINE.match(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", ()):
            moved = e2e[m["moves"]]
            assert w in cells and w in moved.get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        got = common.cell_metrics(BENCH, w, "end_to_end")
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert common.cell_metrics(BENCH, w, "per_layer")


def test_run_seconds_fit_a_full_check_of_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


# ----------------------------------------------------------- found by name
def test_every_file_is_found_by_name():
    for w in BENCH["workloads"]:
        cfg = common.load_data("configs", w["config"])
        assert (ROOT / "portbench" / "drivers" / f"{cfg['entry']}.py").is_file()
        traffic = common.load_data("traffic", w["traffic"])
        assert traffic["path"] in ("near_corner", "walk")
        limits = common.load_data("cells", w["name"])["limits"]
        assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(common.metric_reader(m["name"]))


def test_added_files_are_picked_up_without_an_edit(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    for kind in ("configs", "traffic", "cells"):
        (tmp_path / "portbench" / kind).mkdir(parents=True)
    (tmp_path / "portbench" / "configs" / "new_cfg.json").write_text(json.dumps({"entry": "system"}))
    (tmp_path / "portbench" / "traffic" / "new_mix.json").write_text(json.dumps({"path": "walk"}))
    (tmp_path / "portbench" / "cells" / "new.cell.json").write_text(json.dumps({"limits": {}}))
    bench["workloads"].append({"name": "new.cell", "config": "new_cfg", "traffic": "new_mix",
                               "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                               "source": "program_counter", "layer": "x", "moves": "frames_per_s",
                               "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench2 = common.load_benchmark(tmp_path)
    w = common.find_workload(bench2, "new.cell")
    assert common.load_data("configs", w["config"], tmp_path)["entry"] == "system"
    assert common.load_data("traffic", w["traffic"], tmp_path)["path"] == "walk"
    assert common.load_data("cells", w["name"], tmp_path) == {"limits": {}}
    assert [m["name"] for m in common.cell_metrics(bench2, "new.cell", "per_layer")] == [
        "new_metric"]
    with pytest.raises(FileNotFoundError):
        common.load_data("traffic", "absent", tmp_path)


# --------------------------------------------------------------- no JAX
def _imported_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(str(arg.value).split(".")[0])
    return names


def test_nothing_under_portbench_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert files
    for f in files:
        bad = _imported_names(f) & set(common.FORBIDDEN_MODULES)
        assert not bad, f"{f} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for f in (ROOT / "portbench" / "reference").glob("*.py"):
        assert "manhattanslam_tpu_torch" not in _imported_names(f), f


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "manhattanslam_tpu_torch", sys.modules[__name__])
    assert common.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys.modules[__name__])
    assert common.forbidden_modules() == ["jaxlib"]


# ------------------------------------------------------- kernels' counts
TAMU = (480, 640, 8, 1.2)


def test_constants_equal_chip_smoke():
    cs = pytest.importorskip("chip_smoke")
    for name in ("HBM_BYTES_PER_S", "FP32_OPS_PER_S", "FAST_OPS_PER_PIXEL", "IC_OPS_PER_PIXEL",
                 "BRIEF_OPS_PER_PAIR", "BLUR_OPS_PER_PIXEL"):
        assert getattr(counts, name) == getattr(cs, name), name
    from manhattanslam_tpu_torch.ops import orb as orb_ops

    assert counts.IC_ROW_EXTENT_LEN == len(orb_ops.IC_ROW_EXTENT)
    assert counts.PATTERN_INTS == orb_ops.PATTERN.size
    assert int(ref_orb.CIRC_MASK.sum()) == int(orb_ops.CIRC_MASK.sum())


@pytest.mark.parametrize("batch", [1, 8])
def test_counts_equal_chip_smoke_at_tamu_shapes(batch):
    cs = pytest.importorskip("chip_smoke")
    shapes = counts.active_shapes(*TAMU)
    assert len(shapes) == 8
    # chip_smoke.py's _measure_levels, term for term
    fb = sum(2 * batch * h * w * 4 for h, w in shapes)
    fo = sum(cs.FAST_OPS_PER_PIXEL * batch * (h - 6) * (w - 6) for h, w in shapes)
    assert counts.fast_counts(shapes, batch) == (fb, fo)
    assert counts.least_ms(fb, fo) == cs.bound(fb, fo)[0]
    # the FAST bounds PERF.md records from chip_smoke.py's runs on the card
    want = {1: 0.0022699271641791045, 8: 0.018159417313432836}[batch]
    assert counts.least_ms(*counts.fast_counts(shapes, batch)) == pytest.approx(want, rel=1e-12)
    n_kp, disc, distinct, sampled, blurred = 1000 * batch, 709, 123456, 65432, 98765
    ib = 4 * 16 + 8 * n_kp + 4 * n_kp + 4 * distinct
    assert counts.ic_counts(n_kp, disc, distinct) == (ib, cs.IC_OPS_PER_PIXEL * disc * n_kp)
    bb = 4 * blurred + 12 * n_kp + 4 * 1024 + 32 * n_kp
    bo = cs.BRIEF_OPS_PER_PAIR * 256 * n_kp + cs.BLUR_OPS_PER_PIXEL * sampled
    assert counts.brief_counts(n_kp, sampled, blurred) == (bb, bo)


def test_keypoint_pixels_equal_chip_smoke_arithmetic():
    """The data terms of one launch, counted as chip_smoke.py counts them
    with the port's own index functions, on the same keypoints."""
    from manhattanslam_tpu_torch.ops import orb as orb_ops

    g = torch.Generator().manual_seed(3)
    levels = [torch.rand((2, 90, 120), generator=g) * 255, torch.rand((2, 75, 100), generator=g) * 255]
    xys = [torch.rand((2, 40, 2), generator=g) * torch.tensor([119.0, 89.0]),
           torch.rand((2, 30, 2), generator=g) * torch.tensor([99.0, 74.0])]
    angs = [torch.rand((2, 40), generator=g) * 6.28, torch.rand((2, 30), generator=g) * 6.28]
    got = counts.keypoint_pixels(levels, xys, angs)
    circ = torch.from_numpy(orb_ops.CIRC_MASK)
    distinct = sampled = blurred = 0
    for lv, xy, a in zip(levels, xys, angs):
        b, h, w = lv.shape
        n = xy.shape[-2]
        off = (torch.arange(b) * h * w)[:, None, None]
        disc = orb_ops.ic_patch_index(xy, h, w).reshape(b, n, -1)[..., circ.reshape(-1)]
        distinct += int(torch.unique(disc + off).numel())
        mask = torch.zeros(b * h * w)
        idx = orb_ops.brief_sample_index(xy, torch.cos(a), torch.sin(a), h, w)
        mask[(idx.reshape(b, n, -1) + off).reshape(-1)] = 1.0
        sampled += int(mask.sum())
        r = orb_ops.BLUR_KSIZE // 2
        blurred += int(torch.nn.functional.max_pool2d(mask.view(b, 1, h, w), 2 * r + 1, 1, r).sum())
    assert got == {"disc_pixels": int(circ.sum()), "distinct": distinct, "sampled": sampled,
                   "blurred": blurred}


# ----------------------------------------------------------- arithmetic
def test_percentile_and_rate():
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0]
    for q in (0, 25, 50, 95, 99, 100):
        assert common.percentile(xs, q) == pytest.approx(np.percentile(xs, q), abs=1e-12)
    assert common.percentile([4.0], 99) == 4.0
    vals = list(range(1, 501))
    assert common.percentile(vals, 99) == pytest.approx(495.01)
    assert common.rate(300, 12.0) == 25.0
    with pytest.raises(ValueError):
        common.rate(1, 0.0)
    q1, q2, q3 = statistics.quantiles([10, 11, 12, 13, 14, 15], n=4)
    assert common.spread([10, 11, 12, 13, 14, 15]) == pytest.approx((q3 - q1) / q2)


def test_metric_readers_on_fixed_context():
    ctx = {"frames": 600, "window_s": 20.0, "setup_s": 12.5, "host_perf_s": 3.0,
           "step_device_ms": 30.0,
           "trace": {"window_s": 2.0, "busy_s": 1.5,
                     "kernels": {"void fast_score_levels_kernel(FastTable)": (10, 2e-4),
                                 "ic_angle_levels_kernel": (10, 5e-5),
                                 "brief_levels_kernel(BriefTable)": (10, 5e-5),
                                 "other": (5, 1.0)}},
           "least_ms": {"fast": 0.002, "ic_angle": 0.001, "brief": 0.001}}
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    r = {m: common.metric_reader(m)(ctx) for m in names}
    assert r["frames_per_s"] == 30.0 and r["setup_s"] == 12.5
    assert r["host_ms_per_frame"] == 5.0 and r["step_device_ms"] == 30.0
    assert r["profiled_idle_pct"] == 25.0
    assert r["orb_kernels_roofline"] == pytest.approx(100 * 40e-6 / 3e-4)
    # nothing to read: nothing returned, never 0
    empty = {"frames": 10, "window_s": 1.0}
    for m in ("profiled_idle_pct", "orb_kernels_roofline", "host_ms_per_frame",
              "step_device_ms"):
        assert common.metric_reader(m)(empty) is None, m


def test_per_layer_metric_without_workloads_follows_its_end_to_end_metric():
    """The contract's form without ``workloads``: reported in every cell
    that reports the end-to-end metric it moves."""
    bench = {"end_to_end": [{"name": "e", "workloads": ["a"]}, {"name": "f"}],
             "per_layer": [{"name": "p", "moves": "e"}, {"name": "q", "moves": "f"},
                           {"name": "r", "moves": "f", "workloads": ["b"]}]}
    assert [m["name"] for m in common.cell_metrics(bench, "a", "per_layer")] == ["p", "q"]
    assert [m["name"] for m in common.cell_metrics(bench, "b", "per_layer")] == ["q", "r"]
    assert [m["name"] for m in common.cell_metrics(bench, "b", "end_to_end")] == ["f"]


def test_ate():
    rng = np.random.default_rng(1)
    gt = rng.normal(size=(300, 3))
    c, s = math.cos(0.3), math.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    assert judge.ate(gt @ R.T + 5.0, gt) < 1e-12  # a rigid motion aligns away
    est = gt.copy()
    est[200:] += 0.1
    assert 0.03 < judge.ate(est, gt) < 0.1
    assert math.isnan(judge.ate(est[:1], gt[:1]))
    T = np.tile(np.eye(4), (2, 1, 1))
    T[1, :3, 3] = [1.0, 2.0, 3.0]
    np.testing.assert_allclose(judge.centres(T), [[0, 0, 0], [-1, -2, -3]])


def test_verdict():
    ok, checks = judge.verdict({"a": 0.5, "b": 2.0}, {"a": 1.0, "b": 2.0})
    assert ok and list(checks) == ["a", "b"]
    assert not judge.verdict({"a": 1.5}, {"a": 1.0})[0]
    ok, checks = judge.verdict({"a": float("nan")}, {"a": 1.0})
    assert not ok and checks["a"]["value"] is None
    assert not judge.verdict({}, {"a": 1.0})[0]


class _Evt:
    def __init__(self, name, a, b, dev, ann=False):
        self._n, self._a, self._b, self._d, self._ann = name, a, b, dev, ann

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._ann


def test_trace_reduction():
    ev = [_Evt(trace.WINDOW, 0, 1000, False, True),
          _Evt("portbench.system", 0, 1000, True, True),  # drawn over the kernels: not busy
          _Evt("portbench.system", 100, 900, False, True),
          _Evt("k1", 100, 300, True), _Evt("k2", 250, 400, True), _Evt("k1", 700, 800, True),
          _Evt("cudaEventSynchronize", 450, 650, False), _Evt("k0", -50, 50, True)]
    out = trace.reduce_events(ev)
    assert out["window_s"] == pytest.approx(1e-6)
    assert out["busy_s"] == pytest.approx((50 + 300 + 100) * 1e-9)
    assert out["kernels"]["k1"] == (2, pytest.approx(300e-9))
    gaps = out["breakdown"]["idle_gaps"]
    assert gaps[0] == ["portbench.system / cudaEventSynchronize", pytest.approx(300e-9)]
    assert [g[1] for g in gaps] == sorted([g[1] for g in gaps], reverse=True)
    assert out["breakdown"]["device_ops"][0][0] == "k1"
