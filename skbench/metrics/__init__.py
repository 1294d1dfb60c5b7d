"""Metric readers, one file a metric, named as in ``BENCHMARK.json``.

Each file has ``read(run) -> float | None`` over a ``harness.RunRecord``:
end-to-end metrics from the window's host clock and its jobs, per-layer
metrics from the traced window (``run.trace``, a ``tracing.Trace``).  A
reader that finds nothing to read returns None, and the harness leaves the
metric out of the result; a share of a roofline is never 0.
"""
