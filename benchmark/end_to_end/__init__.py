"""One reader an end-to-end metric, found by the metric's name:
``read(w)`` takes the window's totals (``harness.Totals``) and returns the
metric's value."""
