"""Logger and named-section stopwatch.

The port's own copy of ``furniture_tpu.utils.logger`` (the reference's
``util/logger.py:8-56``), under the logger name ``furniture_tpu_torch``.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict

logger = logging.getLogger("furniture_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("[%(levelname)s|%(asctime)s] %(message)s", "%H:%M:%S")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


class StopWatch:
    """Accumulates wall time per named section (reference ``StopWatch``,
    ``util/logger.py:37-56``)."""

    def __init__(self):
        self._t: dict[str, float] = {}
        self._acc: dict[str, list[float]] = defaultdict(list)

    def start(self, name: str):
        self._t[name] = time.time()

    def stop(self, name: str):
        self._acc[name].append(time.time() - self._t[name])

    def average(self) -> dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self._acc.items() if v}

    def sum(self) -> dict[str, float]:
        return {k: sum(v) for k, v in self._acc.items()}
