"""Phase timing, the program's recorder, and device tracing (SURVEY.md §5.1).

The reference relied on the Spark UI plus a hand-instrumented variant of
its main program (`FastMapProfiling.scala`); here phases are timed on the
host clock with an explicit device synchronize, reported as a table, and
`device_trace` wraps `torch.profiler` for a Chrome trace of host and CUDA
activity.

The recorder: ``tracing()`` installs a fresh ``PhaseTimer`` as the
process's recorder for the length of a ``with`` block; none is installed
otherwise. While one is, the hot path's spans (``span(name)``) record
host-clock intervals, and its blocking reads (``host_any``, ``host_int``
and the ``synced()`` blocks around downloads, uploads and data-dependent
shapes) are counted, with the time the host waited in them, against the
innermost open span. Spans measure what the host was doing: they never
synchronize the device, so a span around queued device work ends when the
host has issued it, and the device's time shows in the span that next
blocks on it. Intervals are ``time.perf_counter_ns()`` values, the clock
the benchmark's own spans use and map onto the profiler's. With no
recorder installed a span or a sync site costs a read of a module global
and an ``is None`` test; the blocking read happens either way.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

# the installed recorder (``tracing()``), or None
_recorder = None


class PhaseTimer:
    """Accumulating wall-clock phase timer with device synchronization; the
    program's recorder while ``tracing()`` has it installed."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        # spans: (path, t0, t1) in perf_counter nanoseconds; syncs, and
        # the seconds waited in them, by the innermost open span's path
        # ("" outside every span), and by the call site (file, line)
        self.intervals: list = []
        self.syncs: dict[str, int] = defaultdict(int)
        self.sync_wait: dict[str, float] = defaultdict(float)
        self.sync_sites: dict[tuple, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._local = threading.local()

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

    # ---- the recorder's side: per-thread span stacks, shared totals
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def in_sync(self) -> bool:
        """Whether this thread is inside a counted blocking read."""
        return getattr(self._local, "depth", 0) > 0

    def _span_done(self, path: str, t0: int, t1: int):
        with self._lock:
            self.totals[path] += (t1 - t0) / 1e9
            self.counts[path] += 1
            self.intervals.append((path, t0, t1))

    def _sync_done(self, site: tuple, n: int, waited_ns: int):
        path = "/".join(self._stack())
        with self._lock:
            self.syncs[path] += n
            self.sync_wait[path] += waited_ns / 1e9
            self.sync_sites[site] += n

    def summary(self) -> dict:
        """What the recorder holds, merged over the threads that wrote to
        it: span seconds and counts by path, the intervals, and syncs and
        sync seconds by path and syncs by call site (``file:line``, the
        file from the package's directory on)."""
        with self._lock:
            sites = dict(self.sync_sites)
            return {"totals": dict(self.totals), "counts": dict(self.counts),
                    "intervals": list(self.intervals),
                    "syncs": dict(self.syncs),
                    "sync_wait": dict(self.sync_wait),
                    "sync_sites": {f"{f[max(f.rfind('tpubwa_torch'), 0):]}:"
                                   f"{line}": n
                                   for (f, line), n in sites.items()}}


class _Off:
    """The span and sync block of an uninstalled recorder: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "path", "t0")

    def __init__(self, rec: PhaseTimer, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        st = self.rec._stack()
        st.append(self.name)
        self.path = "/".join(st)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rec._stack().pop()
        self.rec._span_done(self.path, self.t0, t1)
        return False


class _Sync:
    __slots__ = ("rec", "site", "n", "t0")

    def __init__(self, rec: PhaseTimer, frame, n: int):
        self.rec, self.n = rec, n
        self.site = (frame.f_code.co_filename, frame.f_lineno)

    def __enter__(self):
        loc = self.rec._local
        loc.depth = getattr(loc, "depth", 0) + 1
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        waited = time.perf_counter_ns() - self.t0
        self.rec._local.depth -= 1
        self.rec._sync_done(self.site, self.n, waited)
        return False


@contextlib.contextmanager
def tracing():
    """Install a fresh recorder for the block and yield it; the one
    installed before (usually none) is back at exit."""
    global _recorder
    prev, rec = _recorder, PhaseTimer()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = prev


def span(name: str):
    """A span of the hot path: ``with span("seed"):``. Records the block's
    host-clock interval under the path of the spans open on this thread
    (``tier1/seed``); does nothing when no recorder is installed."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Span(rec, name)


def synced(n: int = 1):
    """Counts the ``n`` blocking reads of the block (a download, an upload
    from pageable host memory, a data-dependent shape) at the caller's
    line, with the time waited; does nothing when no recorder is
    installed."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Sync(rec, sys._getframe(1), n)


def host_any(x) -> bool:
    """``bool(x.any())``, counted as one blocking read at the caller's line
    while a recorder is installed."""
    rec = _recorder
    if rec is None:
        return bool(x.any())
    with _Sync(rec, sys._getframe(1), 1):
        return bool(x.any())


def host_int(x) -> int:
    """``int(x)`` of a one-element tensor, counted as one blocking read at
    the caller's line while a recorder is installed."""
    rec = _recorder
    if rec is None:
        return int(x)
    with _Sync(rec, sys._getframe(1), 1):
        return int(x)


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
