"""Share of the traced window, in %, in which no operation ran on the
device (the profiler's kernels, copies and sets)."""

from .. import measure


def read(record, **_):
    if not record.device or record.window_s <= 0:
        return None
    return measure.idle_pct(record.busy_s, record.window_s)
