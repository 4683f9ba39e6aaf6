"""A kernel's share, in %, of its roofline over the traced window: the sum
of each launch's bound (the larger of its frozen FP32 operations over the
card's FP32 peak and its bytes over the memory peak, the peaks scaled by
the power limit where it is below the data sheet's) over the sum of the
launches' device times. Nothing where the launches logged at the wrapper
and the kernels in the trace do not pair one to one, or the card is not in
``roofline/peaks.json``."""

import importlib

from ..roofline import bound_s, peaks


def read(record, kernel: str, **_):
    pattern = importlib.import_module(f"benchmark.roofline.{kernel}").PATTERN
    times = record.kernels(pattern)
    work = record.launches.get(kernel, [])
    peak = peaks(record.device_name, record.power_limit_w)
    if not times or len(times) != len(work) or peak is None:
        return None
    return 100.0 * sum(bound_s(ops, nbytes, peak) for ops, nbytes in work) / sum(times)
