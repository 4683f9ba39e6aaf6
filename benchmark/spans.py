"""The program's own spans in a traced window, read from a
:class:`~benchmark.tracing.Record`.

A program span is a host event of the window's thread whose name starts
with ``ft.``: the port's profiler ranges at its layer boundaries
(``furniture_tpu_torch/utils/trace.py``). No aten op, CUDA runtime call or
span of the benchmark's own (``bench.*``) has such a name. Spans of one
thread nest, so each has one parent: the innermost span around it.
Times are microseconds of the profiler's clock, as in the record.
"""

from __future__ import annotations

from . import measure

PREFIX = "ft."


def tree(record):
    """``[(start, end, name, parent index or None)]`` of the program spans
    that start inside the window, in order of start."""
    lo, hi = record.window
    spans = sorted(
        ((s, e, n) for s, e, n in record.host if n.startswith(PREFIX) and lo <= s < hi),
        key=lambda x: (x[0], -x[1]),
    )
    out, stack = [], []
    for i, (s, e, n) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        out.append((s, e, n, stack[-1] if stack else None))
        stack.append(i)
    return out


def self_times(record, name: str):
    """Each ``name`` span's length less the union of the program spans
    nested in it (their direct children cover it)."""
    t = tree(record)
    child = [0.0] * len(t)
    for s, e, _, p in t:
        if p is not None:
            child[p] += min(e, t[p][1]) - s
    return [e - s - child[i] for i, (s, e, n, _) in enumerate(t) if n == name]


def innermost(record):
    """``[(start, end, name)]``: the window cut into pieces, each named by
    the innermost program span open over it (None where none is)."""
    lo, hi = record.window
    t = tree(record)
    kids = [[] for _ in t]
    top = []
    for i, (_, _, _, p) in enumerate(t):
        (top if p is None else kids[p]).append(i)
    out = []

    def fill(s, e, name, children):
        at = s
        for c in children:
            cs, ce = max(t[c][0], at), min(t[c][1], e)
            if cs > at:
                out.append((at, cs, name))
            if ce > cs:
                fill(cs, ce, t[c][2], kids[c])
            at = max(at, ce)
        if e > at:
            out.append((at, e, name))

    fill(lo, hi, None, top)
    return out


def idle_by_span(record) -> dict:
    """The window's device-idle microseconds, by the innermost program span
    open at each instant (None: outside every one)."""
    gaps = measure.gaps(record.device_intervals(), *record.window)
    out = {}
    pieces = innermost(record)
    j = 0
    for gs, ge in gaps:
        while j < len(pieces) and pieces[j][1] <= gs:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < ge:
            s, e, name = pieces[k]
            d = min(e, ge) - max(s, gs)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
            k += 1
    return out
