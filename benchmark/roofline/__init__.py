"""Frozen work counts of the port's kernels and the table of the card's
peaks: the yardstick of every ``*_roofline`` metric.

Each ``kernel<N>.py`` counts the FP32 operations and the bytes of one launch
from the model as the benchmark's reference compiles it, never from the
port's objects, so that a redesign of a kernel changes its time and not its
yardstick. ``peaks.json`` holds the data-sheet peaks by device name.
"""

from __future__ import annotations

import json
from pathlib import Path


def peaks(device_name: str, power_limit_w: float | None = None):
    """``(fp32 FLOP/s, HBM bytes/s)`` of ``device_name``, scaled by the power
    limit where it is below the data sheet's; None for a card not in the
    table."""
    table = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
    row = table.get(device_name)
    if row is None:
        return None
    scale = 1.0
    if power_limit_w is not None and power_limit_w < row["power_w"]:
        scale = power_limit_w / row["power_w"]
    return row["fp32_flops"] * scale, row["hbm_bytes_per_s"] * scale


def bound_s(ops: float, nbytes: float, peak) -> float:
    """The least time the card could take: the larger of operations over the
    FP32 peak and bytes over the memory peak."""
    return max(ops / peak[0], nbytes / peak[1])
