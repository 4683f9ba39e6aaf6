"""Logger.

The port's own copy of ``furniture_tpu.utils.logger``'s logger (the
reference's ``util/logger.py:8-56`` without its ``StopWatch``), under the
logger name ``furniture_tpu_torch``. Section timing of the env step is the profiler's
spans (``utils/trace.py``).
"""

from __future__ import annotations

import logging

logger = logging.getLogger("furniture_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("[%(levelname)s|%(asctime)s] %(message)s", "%H:%M:%S")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
