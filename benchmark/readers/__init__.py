"""Readers of the per-layer metrics: ``read(record, **args)`` returns the
metric from a traced window's :class:`~benchmark.tracing.Record`, or None
where the window holds nothing to read (never 0 for a share of a roofline
or a peak). ``metrics/<name>.json`` names each metric's reader and args."""
