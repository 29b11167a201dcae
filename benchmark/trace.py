"""Tracing of a ``--trace 1`` run, from the benchmark's own files: host-clock
spans around the aligner's layer entry points, recorders of the two
hand-written kernels' calls, and a CUDA-activity profile of a bounded slice
of the window.

Spans wrap the aligner instance's methods (an instance attribute shadows
the class's), the recorders wrap the module attributes the pipeline calls;
both are removed when the run ends. The profile records CUDA activity only
and is read from the profiler's raw event list: a batch launches some 10^5
kernels, and building the profiler's event tree with host operators took
minutes (chip_smoke.py's device_share, whose arithmetic this copies).
"""
from __future__ import annotations

import time

# span name -> the Aligner method it wraps
SPANS = {"worker1": "worker1_packed", "tiers": "_tiers",
         "finish": "_finish_threaded", "pe_finish": "_pe_stage_b",
         "pe_prepare": "_pe_stage_a"}


class Spans:
    """Host-clock spans: total seconds by name, and each interval in
    perf_counter nanoseconds."""

    def __init__(self):
        self.total: dict = {}
        self.intervals: list = []
        self._undo: list = []

    def wrap(self, obj, attr: str, name: str):
        fn = getattr(obj, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **kw)
            finally:
                t1 = time.perf_counter_ns()
                self.total[name] = self.total.get(name, 0.0) + (t1 - t0) / 1e9
                self.intervals.append((name, t0, t1))
        setattr(obj, attr, timed)
        self._undo.append((obj, attr))

    def install(self, aligner):
        for name, attr in SPANS.items():
            self.wrap(aligner, attr, name)

    def remove(self):
        for obj, attr in reversed(self._undo):
            delattr(obj, attr)
        self._undo.clear()


class KernelCalls:
    """Records, while ``on``, the task arguments of each call of the
    pipeline's K1 (``extend.worker.ksw_extend``) and K2
    (``pair.rescue.ksw_local``) as device tensors, copied at the call."""

    def __init__(self):
        self.on = False
        self.k1: list = []
        self.k2: list = []
        self._undo: list = []

    def install(self):
        from tpubwa_torch.extend import worker
        from tpubwa_torch.pair import rescue
        k1, k2 = worker.ksw_extend, rescue.ksw_local

        def rec1(query, qlen, target, tlen, h0, w, end_bonus, valid, **kw):
            if self.on:
                self.k1.append(tuple(x.detach().clone() for x in
                                     (qlen, tlen, w, end_bonus, valid)))
            return k1(query, qlen, target, tlen, h0, w, end_bonus, valid, **kw)

        def rec2(query, qlen, target, tlen, minsc, valid, **kw):
            if self.on:
                self.k2.append(tuple(x.detach().clone() for x in
                                     (qlen, tlen, valid)))
            return k2(query, qlen, target, tlen, minsc, valid, **kw)
        worker.ksw_extend, rescue.ksw_local = rec1, rec2
        self._undo = [(worker, "ksw_extend", k1), (rescue, "ksw_local", k2)]

    def remove(self):
        for mod, attr, fn in self._undo:
            setattr(mod, attr, fn)
        self._undo.clear()

    def host(self):
        """The recorded calls as host arrays."""
        return ([tuple(x.cpu().numpy() for x in c) for c in self.k1],
                [tuple(x.cpu().numpy() for x in c) for c in self.k2])


class Profile:
    """A CUDA-activity profile of a slice; the slice's host-clock bounds in
    three clocks, so that device events can be placed against spans."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.events: list = []
        self.wall_s = 0.0

    @staticmethod
    def _clocks():
        return (time.perf_counter_ns(), time.time_ns(), time.monotonic_ns())

    def start(self):
        import torch
        torch.cuda.synchronize()
        self.prof.__enter__()
        self.c0 = self._clocks()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.c1 = self._clocks()
        self.prof.__exit__(None, None, None)
        self.wall_s = (self.c1[0] - self.c0[0]) / 1e9

    def read(self):
        """The slice's device events, read once the window has closed:
        (start ns, duration ns, name), in order of start."""
        from torch.autograd import DeviceType
        self.events = sorted(
            (e.start_ns(), e.duration_ns(), e.name())
            for e in self.prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA)

    def summary(self, spans: Spans, top: int = 10) -> dict:
        """busy_s (union of device intervals), device seconds by name, the
        top device operations, and the device's idle time summed by what
        the host was doing (the innermost span around each idle gap)."""
        busy, end = 0, None
        by_name: dict = {}
        segs: list = []
        for s, d, name in self.events:
            by_name[name] = by_name.get(name, 0) + d
            if end is None or s > end:
                segs.append([s, s + d])
                busy += d
                end = s + d
            elif s + d > end:
                busy += s + d - end
                end = s + d
                segs[-1][1] = end
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
        idle: dict = {}
        off = self._offset()
        if segs and off is not None:
            lo, hi = self.c0[0] + off, self.c1[0] + off
            edges = [lo] + [x for s in segs for x in s] + [hi]
            for a, b in zip(edges[0::2], edges[1::2]):
                if b > a:
                    lab = self._label(spans, (a + b) / 2 - off)
                    idle[lab] = idle.get(lab, 0) + (b - a)
        gaps = sorted(idle.items(), key=lambda x: -x[1])[:top]
        return {"busy_s": busy / 1e9,
                "kernel_s": {k: v / 1e9 for k, v in by_name.items()},
                "device_ops": [[k[:120], v / 1e9] for k, v in ops],
                "idle_gaps": [[lab, g / 1e9] for lab, g in gaps],
                "n_events": len(self.events)}

    def _offset(self):
        """Add to a perf_counter time to get the profiler's clock: the one
        of the three clocks whose slice bounds hold every event."""
        if not self.events:
            return None
        first = self.events[0][0]
        last = max(s + d for s, d, _ in self.events)
        for k in (1, 2, 0):
            lo, hi = self.c0[k], self.c1[k]
            if lo - 10**9 <= first and last <= hi + 10**9:
                return self.c0[k] - self.c0[0]
        return None

    @staticmethod
    def _label(spans: Spans, t: float) -> str:
        best = None
        for name, a, b in spans.intervals:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return f"host: {best[0]}" if best else "host: outside the spans"


def nvidia_smi(fields: str) -> list:
    """Values that nvidia-smi reports for the first card, or []."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    lines = out.strip().splitlines()
    return [x.strip() for x in lines[0].split(",")] if lines else []

