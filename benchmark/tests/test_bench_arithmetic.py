"""The benchmark's arithmetic on synthetic data: rates over the whole
window, percentiles over every sample, the idle share and the breakdown
of a synthetic profiler timeline, and roofline shares."""

import numpy as np
import pytest
import torch

from benchmark import checks, measure, tracing
from benchmark.readers import idle_share, kernel_count, kernel_time, roofline, span_mean
from benchmark.roofline import bound_s, peaks

H100 = "NVIDIA H100 80GB HBM3"


def test_rate_is_all_work_over_the_whole_window():
    # 850 steps of 4096 envs in a window of 30.5 s
    assert measure.rate(850 * 4096, 30.5) == pytest.approx(850 * 4096 / 30.5)
    with pytest.raises(ValueError):
        measure.rate(1, 0.0)


def test_p95_is_over_every_sample_not_medians_of_chunks():
    rng = np.random.default_rng(0)
    samples = np.concatenate([rng.normal(20.0, 0.5, 940), rng.normal(60.0, 1.0, 60)])
    rng.shuffle(samples)
    want = float(np.percentile(samples, 95))
    assert measure.percentile(list(samples), 95) == pytest.approx(want)
    chunk_medians = [float(np.median(c)) for c in np.array_split(samples, 20)]
    assert abs(float(np.percentile(chunk_medians, 95)) - want) > 30.0


def _trace(events, window=(0.0, 1000.0), tid=7):
    ev = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": window[0],
           "dur": window[1] - window[0], "pid": 1, "tid": tid}]
    for cat, name, s, e in events:
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": s, "dur": e - s,
                   "pid": 0 if cat in tracing.DEVICE_CATS else 1,
                   "tid": 3 if cat in tracing.DEVICE_CATS else tid})
    return {"traceEvents": ev}


def _record():
    rec = tracing.parse_chrome_trace(_trace([
        ("kernel", "mega_substeps_kernel<true>", 100.0, 300.0),
        ("kernel", "elementwise_kernel", 250.0, 400.0),
        ("gpu_memcpy", "Memcpy DtoH", 700.0, 800.0),
        ("kernel", "mega_substeps_kernel<true>", 1200.0, 1300.0),   # after the window
        ("cpu_op", "aten::mul", 400.0, 650.0),
        ("cuda_runtime", "cudaLaunchKernel", 420.0, 430.0),
        ("cpu_op", "aten::item", 800.0, 1000.0),
        ("cuda_runtime", "cudaStreamSynchronize", 820.0, 990.0),
        ("gpu_user_annotation", "bench.step_batch", 0.0, 1000.0),
    ]))
    rec.units = 2
    return rec


def test_idle_share_from_a_synthetic_timeline():
    rec = _record()
    assert rec.window_s == pytest.approx(1e-3)
    assert rec.busy_s == pytest.approx(400e-6)          # [100,400] and [700,800]
    assert idle_share.read(rec) == pytest.approx(60.0)
    assert tracing.Record(window=(0.0, 1.0)).busy_s == 0.0
    assert idle_share.read(tracing.Record(window=(0.0, 1.0))) is None


def test_breakdown_names_device_ops_and_idle_gaps_by_host_op():
    b = _record().breakdown()
    names = [n for n, _ in b["device_ops"]]
    assert names == ["mega_substeps_kernel<true>", "elementwise_kernel", "Memcpy DtoH"]
    assert b["device_ops"][0][1] == pytest.approx(200e-6)
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    # [0,100): nothing on the host; [400,700): aten::mul (mid 550);
    # [800,1000): the innermost op at 900 is the synchronisation
    assert gaps["(host between operations)"] == pytest.approx(100e-6)
    assert gaps["aten::mul"] == pytest.approx(300e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(200e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_kernel_readers_by_name_inside_the_window():
    rec = _record()
    assert kernel_time.read(rec, kernel="kernel1") == pytest.approx(200e-6 / 2 * 1e3)
    assert kernel_count.read(rec) == pytest.approx(2 / 2)
    assert kernel_time.read(rec, kernel="kernel2") is None


def test_roofline_share_is_below_100_for_a_known_time():
    p = peaks(H100, 700.0)
    assert p == (67e12, 3.35e12)
    assert peaks(H100, 350.0) == (33.5e12, 1.675e12)
    assert peaks("some other card") is None
    ops, nbytes = 1.25e-3 * 67e12, 1e6            # 1.25 ms of operations
    assert bound_s(ops, nbytes, p) == pytest.approx(1.25e-3)
    rec = tracing.parse_chrome_trace(_trace([("kernel", "mega_substeps_kernel", 0.0, 12400.0)],
                                            window=(0.0, 20000.0)))
    rec.device_name, rec.power_limit_w = H100, 700.0
    rec.launches = {"kernel1": [(ops, nbytes)]}
    share = roofline.read(rec, kernel="kernel1")
    assert share == pytest.approx(100 * 1.25 / 12.4)
    assert 0 < share < 100
    rec.launches = {"kernel1": [(ops, nbytes)] * 2}        # launches and kernels unpaired
    assert roofline.read(rec, kernel="kernel1") is None


def test_span_mean_and_nothing_to_read():
    rec = tracing.Record(spans={"bench.plan": [1.0, 3.0]})
    assert span_mean.read(rec, span="bench.plan") == pytest.approx(2000.0)
    assert span_mean.read(rec, span="bench.step_batch") is None


def test_share_over_sees_a_few_bad_rows_that_the_p90_passes():
    rows = torch.zeros(4096, dtype=torch.float64)
    rows[:205] = 0.5                                    # 5% of the envs altered
    rows[205:215] = 5e-4
    n = checks.stats("step_err", [rows[:2048], rows[2048:]])
    assert n["step_err_p90"] == 0.0
    assert n["step_err_pct_over_1e-3"] == pytest.approx(100 * 205 / 4096)
    assert n["step_err_pct_over_1e-4"] == pytest.approx(100 * 215 / 4096)
    assert checks.judge(n, {"step_err_p90": 2e-3})[0]
    assert not checks.judge(n, {"step_err_p90": 2e-3, "step_err_pct_over_1e-3": 2.0})[0]


def test_gaps_and_union():
    assert measure.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert measure.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert measure.idle_pct(0.25, 1.0) == 75.0
