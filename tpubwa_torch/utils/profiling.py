"""Phase timing + device tracing (SURVEY.md §5.1).

The reference relied on the Spark UI plus a hand-instrumented variant of
its main program (`FastMapProfiling.scala`); here phases are timed on the
host clock with an explicit device synchronize, reported as a table, and
`device_trace` wraps `torch.profiler` for a Chrome trace of host and CUDA
activity.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path


class PhaseTimer:
    """Accumulating wall-clock phase timer with device synchronization."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase; call .sync(x) on the phase's output inside the
        block so queued device work is counted in it. ``sync`` is accepted
        for callers of the reference's signature and not used."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @staticmethod
    def sync(x):
        """Wait for the device of the first CUDA tensor in x (a tensor or a
        nested dict / list / tuple of them); CPU tensors need no wait."""
        import torch

        def first_cuda(v):
            if isinstance(v, torch.Tensor):
                return v if v.is_cuda else None
            items = v.values() if isinstance(v, dict) else \
                v if isinstance(v, (list, tuple)) else ()
            for item in items:
                t = first_cuda(item)
                if t is not None:
                    return t
            return None
        t = first_cuda(x)
        if t is not None:
            torch.cuda.synchronize(t.device)
        return x

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-9
        lines = ["phase                 total_s  calls  share"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:20s} {t:8.3f} {self.counts[name]:6d} "
                         f"{100 * t / total:5.1f}%")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str | Path):
    """torch.profiler over host and CUDA activity; on exit the trace is
    written to ``logdir/trace.json`` (Chrome trace format). The CUDA
    activity is recorded only when a card is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))
