"""One reader a per-layer metric, found by the metric's name: ``read(t)``
takes a run's trace (``harness.TraceData``) and returns the metric's value,
or None where the run holds nothing for it to read."""
