"""The traced window of a ``--trace 1`` run: spans the benchmark puts around
calls into the program's layers, the kernel launches it logs at the
wrappers, and the ``torch.profiler`` timeline of the device.

Nothing here is active in a ``--trace 0`` run: :class:`Tracer` with
``enabled=False`` installs no wrapper and starts no profiler. In a traced
run the wrappers are installed on the program's objects (instance
attributes, the classes stay as they are), record only inside
:meth:`Tracer.window`, and the profiler's Chrome trace is written to a
temporary directory under ``TMPDIR``, read back and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import torch

from . import measure

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Record:
    """What one traced window saw. Times are microseconds of the profiler's
    clock; ``spans`` are host seconds of each call; ``launches`` the
    frozen ``(ops, bytes)`` of each logged launch by kernel."""

    device: list = field(default_factory=list)     # (start, end, name, cat)
    host: list = field(default_factory=list)       # (start, end, name) on the window's thread
    window: tuple = (0.0, 0.0)
    units: int = 0
    spans: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)
    device_name: str = ""
    power_limit_w: float | None = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def device_intervals(self):
        lo, hi = self.window
        return measure.clip([(s, e) for s, e, _, _ in self.device], lo, hi)

    @property
    def busy_s(self) -> float:
        return measure.union_length(self.device_intervals()) * 1e-6

    def kernels(self, pattern: str):
        """Seconds of each kernel inside the window whose name holds
        ``pattern``."""
        lo, hi = self.window
        return [
            (e - s) * 1e-6 for s, e, name, cat in self.device
            if cat == "kernel" and pattern in name and lo <= s < hi
        ]

    def n_kernels(self) -> int:
        lo, hi = self.window
        return sum(1 for s, _, _, cat in self.device if cat == "kernel" and lo <= s < hi)

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host operation running at their middle."""
        lo, hi = self.window
        ops = defaultdict(float)
        for s, e, name, _ in self.device:
            if lo <= s < hi:
                ops[name] += (min(e, hi) - s) * 1e-6
        idle = defaultdict(float)
        for gap, host in zip(*self._gap_hosts()):
            idle[host] += (gap[1] - gap[0]) * 1e-6
        return {"device_ops": measure.top(ops, n), "idle_gaps": measure.top(idle, n)}

    def _gap_hosts(self):
        lo, hi = self.window
        gaps = measure.gaps(self.device_intervals(), lo, hi)
        host = sorted(h for h in self.host if h[2] != WINDOW)
        starts = [h[0] for h in host]
        names = []
        stack = []
        i = 0
        for g in gaps:
            mid = 0.5 * (g[0] + g[1])
            # push every host event that starts before the gap's middle
            j = bisect.bisect_right(starts, mid)
            while i < j:
                while stack and stack[-1][1] <= host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            names.append(stack[-1][2] if stack else "(host between operations)")
        return gaps, names


def parse_chrome_trace(trace: dict) -> Record:
    """The device events, the host events of the window's thread and the
    window itself from a Chrome trace as ``torch.profiler`` exports it."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    w = win[0]
    rec = Record(window=(float(w["ts"]), float(w["ts"]) + float(w["dur"])))
    for e in events:
        s = float(e["ts"])
        end = s + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            rec.device.append((s, end, e.get("name", ""), cat))
        elif cat in HOST_CATS and e.get("tid") == w.get("tid"):
            rec.host.append((s, end, e.get("name", "")))
    rec.device.sort()
    return rec


class Tracer:
    """Spans, launch logs and the profiled window of a traced run."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.spans = defaultdict(list)
        self.launches = defaultdict(list)
        self.record: Record | None = None

    @contextmanager
    def _timed(self, name: str):
        t = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.spans[name].append(time.perf_counter() - t)

    def span(self, name: str):
        """A span around a call into a layer; nothing outside the window."""
        return self._timed(name) if self.active else nullcontext()

    def wrap(self, obj, method: str, name: str) -> None:
        """Put a span around every call of ``obj.method``."""
        if not self.enabled:
            return
        inner = getattr(obj, method)

        def spanned(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(obj, method, spanned)

    def watch(self, kernel: str, obj, method: str, work) -> None:
        """Log ``work(args)`` (the frozen ``(ops, bytes)``) of every call of
        the launch method ``obj.method`` under ``kernel``."""
        if not self.enabled:
            return
        inner = getattr(obj, method)

        def logged(*args, **kwargs):
            if self.active:
                self.launches[kernel].append(work(args))
            return inner(*args, **kwargs)

        setattr(obj, method, logged)

    @contextmanager
    def window(self, device: torch.device):
        """Profile the block: CPU and, on the card, CUDA activity, the block
        ending in a synchronisation. Leaves the parsed :class:`Record` in
        ``self.record`` (its ``units`` for the caller to set)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            self.active = True
            try:
                with torch.profiler.record_function(WINDOW):
                    yield
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
            finally:
                self.active = False
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        rec = parse_chrome_trace(trace)
        rec.spans = dict(self.spans)
        rec.launches = dict(self.launches)
        self.record = rec
