"""Spans at the layer boundaries of the env step, for ``torch.profiler``.

A span is a ``torch.profiler.record_function`` range. It is recorded only
while a profiler records the thread (``torch.profiler.profile``, or
``torch.autograd.profiler.profile``); otherwise :func:`span` returns a
shared no-op context, and the check costs a fraction of a microsecond where
an idle ``record_function`` costs ~10 us. The profiler keeps the spans in
memory on the same timeline as the device's kernels and writes them with
its trace (``user_annotation`` events in the Chrome trace), so the device's
idle time can be put down to the span open on the host at that moment.

A span's parent is the span around it on the thread; every span of a
``VecEnv.step`` call lies inside its ``ft.vec.step``:

- ``ft.vec.step``: ``VecEnv.step``; its own time is the auto-reset and the
  bookkeeping.
- ``ft.vec.sync``: ``bool(done.any())``, the one host synchronisation that
  ``VecEnv.step`` makes by design.
- ``ft.env.step``: an env's ``step_batch``; its own time is the glue between
  the parts below.
- ``ft.env.control``: action to commands (the cursor's moves, selection and
  held mask; the arm's IK, direct control or torque-space controller).
- ``ft.env.dynamics``: the arm's joint matrices G1, G2.
- ``ft.env.physics``: the host side of a kernel wrapper's launch.
- ``ft.env.connect``: the connect attempt and the post-connect snap.
- ``ft.env.finish``: the instability guard, reward, done and info.
- ``ft.env.observe``: the observation.
"""

from __future__ import annotations

import contextlib

import torch

SPANS = (
    "ft.vec.step", "ft.vec.sync", "ft.env.step", "ft.env.control", "ft.env.dynamics",
    "ft.env.physics", "ft.env.connect", "ft.env.finish", "ft.env.observe",
)
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records the thread,
    else a no-op context."""
    return torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else _OFF
