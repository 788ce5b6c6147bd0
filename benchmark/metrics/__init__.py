"""One reader a metric, ``<metric name>.py`` with ``read(run) -> float |
None``: ``run`` is the finished :class:`benchmark.harness.CellRun`.  A reader
that finds nothing to read returns ``None`` and the metric is left out of the
result line."""
