"""The benchmark's arithmetic: rates, percentiles and the reading of a
profiler timeline. Plain Python and numpy, so that the tests can hold
it on synthetic data."""

from __future__ import annotations

import numpy as np


def rate(units: float, seconds: float) -> float:
    """Work completed over the whole window: ``units`` over ``seconds``."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return units / seconds


def percentile(samples, q: float) -> float:
    """The ``q``-th percentile of every sample (linear interpolation between
    the closest ranks), never of medians of chunks."""
    if len(samples) == 0:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(samples, np.float64), q))


def union_length(intervals) -> float:
    """Total length covered by ``[(start, end), ...]``."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def clip(intervals, lo: float, hi: float):
    """The parts of ``intervals`` inside ``[lo, hi]``."""
    out = []
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append((s, e))
    return out


def gaps(intervals, lo: float, hi: float):
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out = []
    t = lo
    for s, e in sorted(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_pct(busy_s: float, window_s: float) -> float:
    """Share of the window, in %, in which no operation ran on the device."""
    return 100.0 * (1.0 - busy_s / window_s)


def top(totals: dict, n: int = 10):
    """``[[name, value], ...]`` of the ``n`` largest values, largest first."""
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]
