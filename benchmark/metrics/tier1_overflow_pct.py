"""Reads that overflowed tier 1's caps and went to tiers 2-3, as a share
of the reads aligned in the window (``Aligner.stats``)."""


def read(t):
    n = t.stats.get("reads", 0)
    return 100.0 * t.stats.get("tier1_ovf", 0) / n if n else None
