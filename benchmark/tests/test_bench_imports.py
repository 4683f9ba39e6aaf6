"""What the benchmark loads, each check in a fresh interpreter: no module
whose top-level name, compared whole, is ``jax``, ``jaxlib``, ``flax`` or
``furniture_tpu`` (``furniture_tpu_torch`` begins with that name and is
allowed); the reference loads nothing of ``furniture_tpu_torch`` either.
And the command without a card, or in a directory that holds only the
benchmark, prints no result."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def _python(code: str, cwd=ROOT):
    r = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


TOP = "sorted({m.split('.')[0] for m in sys.modules})"


def test_harness_loads_no_jax_and_no_jax_package():
    mods = sorted(
        f"benchmark.{d}.{p.stem}" for d in ("traffic", "readers", "roofline")
        for p in (BENCH / d).glob("*.py") if p.stem != "__init__"
    )
    code = (
        "import sys, json, importlib; sys.path.insert(0, '.')\n"
        "import benchmark.core, benchmark.program, benchmark.calibrate\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from benchmark import core\n"
        "sh = {'mix': {'batch': 2, 'warmup_steps': 1, 'compare_steps': 1, 'trace_steps': 1},"
        " 'sim': {'control_freq': 100}}\n"
        "core.run_cell('cursor.random-b4096', 3, 0.1, True, 'cpu', shrink=sh)\n"
        f"print(json.dumps({TOP}))\n"
    )
    top = _python(code)
    assert "furniture_tpu_torch" in top           # the system under test
    for name in ("jax", "jaxlib", "flax", "furniture_tpu"):
        assert name not in top


def test_reference_loads_nothing_of_the_port():
    code = (
        "import sys, json, torch; sys.path.insert(0, '.')\n"
        "import benchmark.reference as R\n"
        "from benchmark.reference.config import EnvConfig, SimConfig\n"
        "from benchmark.reference.planning.mppi import MPPIConfig, make_mppi\n"
        "from benchmark.roofline import kernel1, kernel2, kernel3\n"
        "env = R.make('IKEASawyer-v0', EnvConfig(control_type='impedance',"
        " sim=SimConfig(control_freq=100)), 'cpu')\n"
        "s = env.reset_batch(1, torch.Generator().manual_seed(0))\n"
        "env.step_batch(s, torch.zeros(1, env.dof))\n"
        f"print(json.dumps({TOP}))\n"
    )
    top = _python(code)
    for name in ("jax", "jaxlib", "flax", "furniture_tpu", "furniture_tpu_torch"):
        assert name not in top


def test_forbidden_names_are_compared_whole():
    code = (
        "import sys, json, types; sys.path.insert(0, '.')\n"
        "from benchmark import core\n"
        "sys.modules['furniture_tpu_torch_x'] = types.ModuleType('furniture_tpu_torch_x')\n"
        "a = core.forbidden_modules()\n"
        "sys.modules['furniture_tpu.physics'] = types.ModuleType('furniture_tpu.physics')\n"
        "print(json.dumps([a, core.forbidden_modules()]))\n"
    )
    before, after = _python(code)
    assert before == [] and after == ["furniture_tpu"]


def _run(cwd, workload="cursor.random-b4096"):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "2147483659",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600,
    )


def _no_result(r):
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        assert not line.lstrip().startswith("{"), line


def test_the_command_prints_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        return          # on a card the command measures; see the gpu test below
    r = _run(ROOT)
    _no_result(r)
    assert r.returncode == 3 and "no measurement" in r.stderr


def test_the_command_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    _no_result(_run(tmp_path))
