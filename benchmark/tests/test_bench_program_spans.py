"""The readers of the program's own spans (``ft.*``) on synthetic records:
self time, device idle by the innermost span, host synchronisations inside
the spans; and one traced CPU dry run a cell that reads every host-time
metric of the spans in the cell's ``workloads``."""

import json
from pathlib import Path

import pytest

from benchmark import core, measure, spans, tracing
from benchmark.readers import span_idle_ms, span_mean, span_self_ms, sync_count

ROOT = Path(__file__).resolve().parents[2]
ENV_SPANS = ("ft.env.step", "ft.env.control", "ft.env.dynamics", "ft.env.physics",
             "ft.env.connect", "ft.env.finish", "ft.env.observe")


def _record(device=True):
    """Two steps in a window of 0-1000 us: each a VecEnv.step with the env
    step's layers nested in it, aten ops and runtime calls among them, the
    benchmark's own span around the env step, and the window's closing
    synchronisation at its end."""
    host = [("bench.window", 0.0, 1000.0),
            ("cudaDeviceSynchronize", 960.0, 1000.0)]
    for o in (0.0, 470.0):
        host += [(n, o + s, o + e) for n, s, e in (
            ("ft.vec.step", 10, 460),
            ("bench.step_batch", 15, 405),
            ("ft.env.step", 20, 400),
            ("aten::mul", 25, 35),
            ("ft.env.control", 40, 100),
            ("aten::where", 45, 55),
            ("ft.env.connect", 60, 80),
            ("cudaLaunchKernel", 85, 90),
            ("ft.env.dynamics", 100, 150),
            ("ft.env.physics", 160, 220),
            ("cudaLaunchKernel", 200, 210),
            ("ft.env.connect", 230, 300),
            ("ft.env.physics", 240, 260),
            ("ft.env.finish", 310, 390),
            ("ft.env.observe", 350, 380),
            ("ft.vec.sync", 410, 450),
            ("cudaMemcpyAsync", 412, 415),
            ("cudaStreamSynchronize", 415, 448),
        )]
    dev = []
    if device:
        for o in (0.0, 470.0):
            dev += [(o + 90, o + 95, "elementwise_kernel", "kernel"),
                    (o + 210, o + 430, "arm_control_step_kernel", "kernel"),
                    (o + 440, o + 442, "Memcpy DtoH", "gpu_memcpy")]
    rec = tracing.Record(device=sorted(dev), host=[(s, e, n) for n, s, e in host],
                         window=(0.0, 1000.0))
    rec.units = 2
    return rec


def test_self_time_subtracts_nested_program_spans_only():
    rec = _record()
    # us a step: control 60 - connect 20; step 380 - (60 + 50 + 60 + 70 + 80);
    # connect (the snap) 70 - physics 20; aten ops and runtime calls count as self
    want = {"ft.env.step": 60, "ft.env.control": 40, "ft.env.connect": 20 + 50,
            "ft.env.dynamics": 50, "ft.env.physics": 60 + 20, "ft.env.finish": 50,
            "ft.env.observe": 30, "ft.vec.sync": 40, "ft.vec.step": 450 - 380 - 40}
    for name, us in want.items():
        assert span_self_ms.read(rec, span=name) == pytest.approx(us * 1e-3), name
    # the self times of the env step's layers add up to its length
    total = sum(span_self_ms.read(rec, span=n) for n in ENV_SPANS)
    assert total == pytest.approx(380e-3)
    # the benchmark's own span is not a program span; its mean still reads
    assert span_self_ms.read(rec, span="bench.step_batch") is None
    rec.spans = {"bench.step_batch": [390e-6, 390e-6]}
    assert span_mean.read(rec, span="bench.step_batch") == pytest.approx(390e-3)


def test_idle_splits_exactly_over_the_innermost_span():
    rec = _record()
    idle_us = measure.union_length(measure.gaps(rec.device_intervals(), *rec.window))
    by = spans.idle_by_span(rec)
    assert sum(by.values()) == pytest.approx(idle_us)
    env = sum(span_idle_ms.read(rec, span=n) for n in ENV_SPANS)
    outside = sum(v for k, v in by.items() if k not in ENV_SPANS) * 1e-3 / rec.units
    assert env + outside == pytest.approx(idle_us * 1e-3 / rec.units)
    # a step, in us: the device is busy 90-95 and 210-430 (and 440-442);
    # control 40-100 less connect 60-80 and the busy 90-95: 35
    assert span_idle_ms.read(rec, span="ft.env.control") == pytest.approx(35e-3)
    assert span_idle_ms.read(rec, span="ft.env.connect") == pytest.approx(20e-3)
    assert span_idle_ms.read(rec, span="ft.env.dynamics") == pytest.approx(50e-3)
    # physics 160-220 less the snap's nested physics: busy from 210
    assert span_idle_ms.read(rec, span="ft.env.physics") == pytest.approx(50e-3)
    assert span_idle_ms.read(rec, span="ft.env.finish") == pytest.approx(0.0)
    assert span_idle_ms.read(rec, span="ft.vec.sync") == pytest.approx(18e-3)
    # the window's start, the gap between the steps and its end lie outside
    assert by[None] == pytest.approx(10 + 20 + (1000 - 930))


def test_sync_count_only_inside_program_spans():
    rec = _record()
    assert sync_count.read(rec) == pytest.approx(1.0)
    # a synchronisation in the env step's glue counts; one between steps not
    rec.host += [(120.0, 125.0, "cudaStreamSynchronize"), (462.0, 465.0, "cudaMemcpy")]
    assert sync_count.read(rec) == pytest.approx(1.5)


def test_nothing_without_device_events_or_program_spans():
    rec = _record(device=False)
    assert span_idle_ms.read(rec, span="ft.env.step") is None
    assert sync_count.read(rec) is None
    assert span_self_ms.read(rec, span="ft.env.step") == pytest.approx(60e-3)
    # a program without the spans (the benchmark's own spans only)
    rec = _record()
    rec.host = [h for h in rec.host if not h[2].startswith("ft.")]
    assert span_self_ms.read(rec, span="ft.env.step") is None
    assert span_idle_ms.read(rec, span="ft.env.step") is None
    assert sync_count.read(rec) is None


def _host_metrics(cell):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = []
    for m in manifest["per_layer"]:
        spec = json.loads((ROOT / "benchmark" / "metrics" / f"{m['name']}.json").read_text())
        if spec["reader"] == "span_self_ms" and cell in m["workloads"]:
            out.append(m["name"])
    return out


@pytest.mark.parametrize("cell", ["cursor.random-b4096", "sawyer.impedance-b512"])
def test_traced_dry_run_reads_every_span_host_metric(cell):
    names = _host_metrics(cell)
    assert len(names) == {"cursor.random-b4096": 7, "sawyer.impedance-b512": 8}[cell]
    sh = {"mix": {"batch": 2, "warmup_steps": 1, "compare_steps": 1, "trace_steps": 2},
          "sim": {"control_freq": 100}}
    r = core.run_cell(cell, 3000000001, 0.1, True, "cpu", shrink=sh)
    assert r["correct"]
    for name in names:
        assert r["metrics"][name]["value"] > 0, name
    # no device on the CPU: no idle and no synchronisation read
    assert not [k for k in r["metrics"] if "idle" in k or "syncs" in k]
