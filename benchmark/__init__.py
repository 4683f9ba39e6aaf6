"""The benchmark of ``furniture_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``calibrate.py`` takes
the readings that the limits of ``correct`` are set from. Everything a cell
needs is found by name: configurations in ``configs/``, traffic mixes and
the modules that run them in ``traffic/``, per-layer metrics in ``metrics/`` with their
readers in ``readers/``, the frozen work counts in ``roofline/`` and the
plain reference in ``reference/``.
"""
