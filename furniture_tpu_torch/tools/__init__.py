"""Command-line entry points of the port."""

from __future__ import annotations


def median_ms(fn, device, reps: int = 5) -> float:
    """Median ms of a call of ``fn`` over ``reps`` calls after one warm-up
    call: CUDA events around each call on the card, the host clock on the
    CPU (the profiling tools' timer)."""
    import statistics
    import time

    import torch

    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
