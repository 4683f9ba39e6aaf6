"""Mean host milliseconds of a span the benchmark puts around calls into a
layer, over the traced window."""


def read(record, span: str, **_):
    times = record.spans.get(span, [])
    if not times:
        return None
    return sum(times) / len(times) * 1e3
