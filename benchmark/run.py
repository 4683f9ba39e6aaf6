"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result object; the numbers compared for ``correct`` are the last lines of
standard error. Without a CUDA card (or with fewer than the cell asks for)
it prints no result and exits with 3.
"""

import time

_T_IMPORT = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def process_start() -> float:
    """Wall time at which this process started (``/proc``), or the time this
    module was first executed where ``/proc`` cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - age if 0.0 <= age < 60.0 else _T_IMPORT
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


if __name__ == "__main__":
    t0 = process_start()
    root = Path(__file__).resolve().parents[1]
    # every build and kernel cache at a fixed path inside the checkout (the
    # port's own nvcc builds go to furniture_tpu_torch/_build/)
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    # the checkout's root in place of this script's directory
    sys.path[0] = str(root)
    from benchmark import core

    sys.exit(core.main(sys.argv[1:], t0))
