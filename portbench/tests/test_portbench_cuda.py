"""On a card: one short run of each cell through the benchmark's command,
its last line a result with every field the contract asks for and
``correct`` true.  Skips where no CUDA card is present (decided inside
the test).  Run on a card with ``python3 -m pytest --noconftest -q
portbench/tests/test_portbench_cuda.py``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402


def _cells():
    return [w["name"] for w in common.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", _cells())
def test_short_run_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**31 + 3),
         "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks" and res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    bench = common.load_benchmark()
    want = {m["name"] for m in common.cell_metrics(bench, cell,
                                                   "per_layer" if trace else "end_to_end")}
    assert set(res["metrics"]) <= want and "setup_s" in res["metrics"] or trace
    if trace:
        assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
        assert len(res["breakdown"]["device_ops"]) <= 10


def test_no_card_means_no_result(monkeypatch):
    """Without a CUDA card the run prints no result and exits non-zero."""
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", _cells()[0], "--seed", "1", "--seconds", "1"]) == 2
