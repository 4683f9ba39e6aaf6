"""On the card: the command's result line for a short window of each cell,
and the traced run's device fields. Run there with
``python -m pytest -m gpu benchmark/tests/test_bench_gpu.py``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "2718281801",
         "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert out["metrics"] and "breakdown" in out
    else:
        assert out["metrics"]["setup_s"]["value"] > 0
