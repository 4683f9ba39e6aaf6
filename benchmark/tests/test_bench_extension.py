"""A later PR adds a configuration, a traffic mix, a cell and a per-layer
metric (with a reader of its own) as files and manifest entries only: in a
copy of the checkout the harness finds and runs them on the CPU dry path,
with no file of the benchmark edited. Without a card the command on the new
cell measures nothing and prints no device number."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _digest(root: Path) -> dict:
    return {
        str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted((root / "benchmark").rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts
    }


def test_data_only_extension(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("furniture_tpu_torch", "furniture_tpu"):
        os.symlink(ROOT / name, tmp_path / name)
    before = _digest(tmp_path)
    b = tmp_path / "benchmark"

    cfg = json.loads((b / "configs" / "cursor-table_lack.json").read_text())
    cfg.update(name="cursor-chair", env=dict(cfg["env"], furniture_name="chair_agne_0007"))
    (b / "configs" / "cursor-chair.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "random-b4096.json").read_text())
    mix.update(batch=3, action_low=-0.5, action_high=0.5)
    (b / "traffic" / "random-b3.json").write_text(json.dumps(mix))
    (b / "readers" / "span_max.py").write_text(
        '"""Longest host milliseconds of a span."""\n\n\n'
        "def read(record, span, **_):\n"
        "    t = record.spans.get(span, [])\n"
        "    return max(t) * 1e3 if t else None\n"
    )
    (b / "metrics" / "enqueue_max_ms.step.json").write_text(
        json.dumps({"reader": "span_max", "args": {"span": "bench.step_batch"}}))
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "cursor-chair", "source": "https://example.org/chair",
                         "file": "benchmark/configs/cursor-chair.json", "reduced": [],
                         "why": "a second furniture model"})
    m["workloads"].append({"name": "cursor-chair.random-b3", "config": "cursor-chair",
                           "traffic": "random-b3", "chips": 1, "why": "tiny"})
    for e in m["end_to_end"]:
        if "env_steps_per_s" == e["name"]:
            e["workloads"].append("cursor-chair.random-b3")
    m["per_layer"].append({"name": "enqueue_max_ms.step", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "env step glue",
                           "moves": "env_steps_per_s", "workloads": ["cursor-chair.random-b3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    code = (
        "import sys, json; sys.path.insert(0, '.')\n"
        "from benchmark import core\n"
        "sh = {'mix': {'warmup_steps': 1, 'compare_steps': 1, 'trace_steps': 2},"
        " 'sim': {'control_freq': 100}}\n"
        "out = [core.run_cell('cursor-chair.random-b3', 5, 0.2, t, 'cpu', shrink=sh)"
        " for t in (False, True)]\n"
        "print(json.dumps(out))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    plain, traced = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(plain["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert plain["correct"] and traced["correct"]
    assert set(traced["metrics"]) == {"enqueue_max_ms.step"}
    assert traced["metrics"]["enqueue_max_ms.step"]["value"] > 0
    assert plain["attempted"] % 3 == 0
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before

    # the measuring path without a card: no result, no device number
    run = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cursor-chair.random-b3",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
    )
    import torch

    if not torch.cuda.is_available():
        assert run.returncode == 3
        assert "memory_peak_bytes" not in run.stdout and "busy_s" not in run.stdout
        assert not [ln for ln in run.stdout.splitlines() if ln.lstrip().startswith("{")]
