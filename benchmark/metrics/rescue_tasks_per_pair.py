"""Mate-rescue windows aligned a pair: the rescue tasks of the window
(``Aligner.stats["rescue_tasks"]``) over its pairs. Paired-end only."""


def read(t):
    n = t.stats.get("reads", 0)
    if not t.paired or not n or "rescue_tasks" not in t.stats:
        return None
    return t.stats["rescue_tasks"] / (n / 2)
