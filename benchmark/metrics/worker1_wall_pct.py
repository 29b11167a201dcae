"""worker1's share of the window on the host clock: the span around
``Aligner.worker1_packed`` (seeding, chaining and extension of tier 1,
driven from the host), over the window's length."""


def read(t):
    s = t.spans.get("worker1")
    return None if s is None else 100.0 * s / t.window_s
