"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``) and a
traffic mix (``traffic/<traffic>.json``); the mix's ``kind`` names the
module that runs it (``traffic/<kind>.py``), and each per-layer metric of
the manifest names its reader in ``metrics/<name>.json``. Nothing here
knows a cell by name.

A traffic module has ``run(ctx) -> dict`` (set-up, then the window; it calls
``ctx.setup_done()`` before its first timed call and ``ctx.window_closed()``
once the window's work has finished on the device) returning the
end-to-end values (``"e2e"``), ``"attempted"``, ``"failed"``, what it kept
for the comparison (``"kept"``) and its counters; and ``check(ctx, kept,
control=False) -> dict`` of the numbers compared, run after the program's
state is freed (with ``control``, also the control's numbers under
``control.<name>``).
"""

from __future__ import annotations

import gc
import importlib
import json
import subprocess
import sys
import time
import zlib
from pathlib import Path

import torch

from . import checks, tracing

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "furniture_tpu")


class NoCard(RuntimeError):
    """The cell needs more CUDA devices than this machine has."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of the manifest, resolved to its files."""

    def __init__(self, workload: str, root: Path = ROOT):
        manifest = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise ValueError(f"no workload {workload!r} in BENCHMARK.json")
        w = cells[workload]
        entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
        self.name = workload
        self.chips = int(w["chips"])
        self.config = load_json(root / entry["file"])
        self.mix = load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
        self.traffic = importlib.import_module(f"benchmark.traffic.{self.mix['kind']}")
        self.end_to_end = [
            m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])
        ]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)
        ]


class Context:
    """What a traffic module gets: the cell's data, the run's arguments, the
    tracer, and the two marks of the window."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 t0: float, shrink: dict | None):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t0 = t0
        shrink = shrink or {}
        self.config = dict(cell.config)
        self.config["sim"] = {**cell.config["sim"], **shrink.get("sim", {})}
        self.mix = {**cell.mix, **shrink.get("mix", {})}
        self.tracer = tracing.Tracer(trace)
        self.setup_s = None
        self.memory_peak_bytes = None

    def seed_for(self, stream: str) -> int:
        """A seed of its own for each stream of draws (resets, actions,
        noise, the rows compared), all from ``--seed``."""
        return (self.seed * 1_000_003 + zlib.crc32(stream.encode())) % (2**63)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        self.sync()
        self.setup_s = time.time() - self.t0

    def window_closed(self) -> None:
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def log(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)


def smi() -> dict | None:
    """The card's name, power limit, clocks, temperature and power draw as
    ``nvidia-smi`` reads them; None where it cannot."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu,power.draw"
    try:
        r = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0 or not r.stdout.strip():
        return None
    vals = [v.strip() for v in r.stdout.strip().splitlines()[0].split(",")]
    return dict(zip(q.split(","), vals))


def watts(text: str | None) -> float | None:
    try:
        return float(text.split()[0])
    except (AttributeError, IndexError, ValueError):
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float | None = None, shrink: dict | None = None, control: bool = False,
             root: Path = ROOT) -> dict:
    """One run of ``workload``; returns the result object (and, with
    ``control``, the control's numbers under ``"control"``). ``shrink``
    overrides mix and ``sim`` entries for a run at a small size on the CPU
    (the tests' dry path); the command line never passes it."""
    t0 = time.time() if t0 is None else t0
    cell = Cell(workload, root)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell needs {cell.chips}")
    # one process with few threads: PyTorch's CPU pool is not the program's
    # path, and its threads would compete with the host thread that paces it
    torch.set_num_threads(1)
    # the configurations state float32 without TF32, for program and reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(cell, seed, seconds, trace, device, t0, shrink)
    card = smi() if device.type == "cuda" else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        ctx.log(f"card {card}")

    out = cell.traffic.run(ctx)
    ctx.log(f"window: {out['attempted']} attempted, {out['failed']} failed; counters "
            f"{json.dumps(out.get('counters', {}))}; setup {ctx.setup_s:.3f} s; "
            f"peak memory {ctx.memory_peak_bytes} B")
    card_after = smi() if device.type == "cuda" else None
    if card_after:
        ctx.log(f"card after the window {card_after}")
    kept = out.pop("kept")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = cell.traffic.check(ctx, kept, control=control)
    correct, table = checks.judge(numbers, ctx.mix["checks"])

    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    breakdown = None
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips if device.type == "cuda" else 0,
        "memory_peak_bytes": ctx.memory_peak_bytes,
    }
    if not trace:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        rec = ctx.tracer.record
        rec.units = out["traced_units"]
        rec.device_name = dev["kind"]
        rec.power_limit_w = watts((card or {}).get("power.limit"))
        for m in cell.per_layer:
            spec = load_json(root / "benchmark" / "metrics" / f"{m['name']}.json")
            reader = importlib.import_module(f"benchmark.readers.{spec['reader']}")
            v = reader.read(rec, **spec.get("args", {}))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        dev["busy_s"] = rec.busy_s
        dev["window_s"] = rec.window_s
        breakdown = rec.breakdown()
    result = {
        "correct": bool(correct),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["numbers"] = {k: v for k, v in numbers.items() if not k.startswith("control.")}
    if control:
        result["control"] = {k[len("control."):]: v for k, v in numbers.items()
                             if k.startswith("control.")}
    result["checks"] = table
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", t0)
    except NoCard as e:
        print(f"[bench] no measurement: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"[bench] no result: the process loaded {bad}", file=sys.stderr)
        return 4
    for name, row in result["checks"].items():
        print(f"check {name} = {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
