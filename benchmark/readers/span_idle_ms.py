"""Milliseconds a unit of work in which the device was idle while one of
the program's own spans (``ft.*``) was the innermost open on the host: the
window's idle time (no kernel, copy or set on the card) split exactly over
the spans. Nothing without device events or where the span is absent."""

from ..spans import idle_by_span, tree


def read(record, span: str, **_):
    if not record.device or record.units <= 0 or all(n != span for _, _, n, _ in tree(record)):
        return None
    return idle_by_span(record).get(span, 0.0) / record.units * 1e-3
