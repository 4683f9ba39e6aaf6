"""Device milliseconds of one kernel per unit of work (a step or a plan),
summed over its launches in the traced window, by the kernel's name
(``roofline/<kernel>.py``'s ``PATTERN``)."""

import importlib


def read(record, kernel: str, **_):
    pattern = importlib.import_module(f"benchmark.roofline.{kernel}").PATTERN
    times = record.kernels(pattern)
    if not times or record.units <= 0:
        return None
    return sum(times) / record.units * 1e3
