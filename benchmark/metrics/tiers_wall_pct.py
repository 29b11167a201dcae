"""Tiers 2-3's share of the window on the host clock: the span around
``Aligner._tiers`` (the big-caps re-runs of tier-1 overflow reads and the
merge), over the window's length."""


def read(t):
    s = t.spans.get("tiers")
    return None if s is None else 100.0 * s / t.window_s
