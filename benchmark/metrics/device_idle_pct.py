"""The card's idle share over the profiled slice: 100 less the union of
its kernel and copy intervals (CUDA activity in the profiler's trace) as a
share of the slice's length."""


def read(t):
    if t.slice is None or t.slice["wall_s"] <= 0 or not t.slice["n_events"]:
        return None
    return 100.0 * (1.0 - t.slice["busy_s"] / t.slice["wall_s"])
