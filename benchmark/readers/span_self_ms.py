"""Host milliseconds a unit of work (a step) of one of the program's own
spans (``ft.*``), less the program spans nested in it: the layer's self
time. Needs no device; nothing where the span is absent."""

from ..spans import self_times


def read(record, span: str, **_):
    times = self_times(record, span)
    if not times or record.units <= 0:
        return None
    return sum(times) / record.units * 1e-3
