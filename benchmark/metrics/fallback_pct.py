"""Reads that every device tier overflowed, realigned by the host oracle,
as a share of the reads aligned in the window (``Aligner.stats``)."""


def read(t):
    n = t.stats.get("reads", 0)
    return 100.0 * t.stats.get("fallback_reads", 0) / n if n else None
