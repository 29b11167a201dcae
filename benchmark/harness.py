"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up (``setup_s``, from process start to the window) loads or builds the
genome, the aligner's index and k-mer table, builds the aligner on the card
as the command line does (``Aligner(FMIndex, MemOptions)``, bwa mem's
defaults), makes the run's batches from its seed, and aligns one warm-up
batch of the cell's own traffic through the same stream entry.

The window feeds whole batches of the CLI's size to ``align_pe_stream`` or
``align_se_stream`` until ``seconds`` have passed, then lets the stream
finish what it holds. Each end-to-end metric is read from the window's
totals by a reader of its own (``end_to_end/<name>.py``), each per-layer
metric from the trace by one in ``metrics/<name>.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import os
import resource
import sys
import time
import numpy as np

from . import check, roofline, trace, world

FORBIDDEN = ("jax", "jaxlib", "flax", "tpubwa")
# the window's batches that the profile covers; batches the check compares
# besides the window's first and last, drawn from the seed
PROFILE_BATCHES = 1
CHECK_DRAWN = 1


@dataclasses.dataclass
class Totals:
    """What an end-to-end metric's reader reads: the window's work and
    times (seconds on the host clock)."""
    reads: int
    bases: int
    window_s: float
    setup_s: float


@dataclasses.dataclass
class TraceData:
    """What a per-layer metric's reader reads. ``window_s``: the traced
    window's length less the time spent stopping the tracer in it."""
    window_s: float
    spans: dict
    stats: dict
    paired: bool
    slice: dict | None
    k1_calls: list
    k2_calls: list
    opt: dict
    int32_peak: float


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run may not hold, each
    compared whole (``tpubwa_torch`` is not ``tpubwa``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def per_layer_for(bench: dict, workload: str) -> list:
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])]


def end_to_end_for(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def _program_batch(b: world.Batch):
    from tpubwa_torch.io.fastx import ReadBatch
    return ReadBatch(b.seqs, b.lens, list(b.names), [None] * b.n)


def _built_files() -> set:
    """The program's build outputs (its kernels' and native libraries)."""
    b = world.REPO / "build"
    return {str(p) for p in b.rglob("*") if p.is_file()} if b.exists() \
        else set()


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace_on: bool, t_start: float, device: str = "cuda",
             cache=world.CACHE, root=world.REPO, procs: int | None = None,
             traffic_dir=world.ROOT / "traffic", log=print) -> dict:
    """A run's result (the keys the benchmark prints), its checks last."""
    import torch
    from tpubwa_torch.pipeline import Aligner

    cell = world.find_cell(bench, workload, root, traffic_dir)
    cfg, trf = cell.config, cell.traffic
    paired = trf["kind"] == "pe"
    on_card = torch.device(device).type == "cuda"

    # ---- set-up ----
    built: list = []          # what this run's set-up had to build
    libs0 = _built_files()
    g = world.genome(cfg, cache, built)
    idx, ikey = world.program_index(cfg, g, cache, root, built)
    opt = world.mem_options(cfg)
    lut = world.lut_path(cfg, ikey, cache, root)
    if not lut.exists():
        built.append("lut")
    aligner = Aligner(idx, opt, device=device, lut_cache=lut)
    stream = aligner.align_pe_stream if paired else aligner.align_se_stream
    t0 = time.perf_counter()
    for _ in stream([_program_batch(world.make_batch(trf, g, seed, -1))]):
        pass
    _sync(device)
    # distinct batches enough for the window at twice the warm-up batch's
    # pace: a batch's time follows its few hardest reads, so a window that
    # cycled a few batches would weigh each one's by the cycle count
    n_pool = 2 + math.ceil(2 * seconds / (time.perf_counter() - t0))
    pool = [world.make_batch(trf, g, seed, b) for b in range(n_pool)]
    feed_batches = [_program_batch(b) for b in pool]
    aligner.stats = {"reads": 0, "fallback_reads": 0}
    if _built_files() - libs0:
        built.append("kernels")

    spans = calls = prof = None
    if trace_on:
        spans = trace.Spans()
        spans.install(aligner)
        calls = trace.KernelCalls()
        calls.install()
        calls.on = True
        if on_card:
            prof = trace.Profile()
            prof.start()      # starting the tracer takes seconds: not timed

    # ---- the window ----
    order: list = []
    texts: list = []
    ru0, load0 = resource.getrusage(resource.RUSAGE_SELF), os.getloadavg()
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start

    def feed():
        j = 0
        while j == 0 or time.perf_counter() - t_w0 < seconds:
            order.append(j % len(pool))
            yield feed_batches[j % len(pool)]
            j += 1

    t_sam: list = []
    tracer_s = 0.0          # the window's time spent stopping the tracer
    for sam in stream(feed(), id0=0):
        texts.append(sam)
        t_sam.append(time.perf_counter() - t_w0)
        if trace_on and calls.on and len(texts) >= PROFILE_BATCHES:
            calls.on = False
            if prof is not None:
                t0 = time.perf_counter()
                prof.stop()
                tracer_s = time.perf_counter() - t0
    _sync(device)
    t_w1 = time.perf_counter()
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    window_s = t_w1 - t_w0
    n_reads = sum(pool[k].n for k in order)
    totals = Totals(n_reads, sum(int(pool[k].lens.sum()) for k in order),
                    window_s, setup_s)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    stats = dict(aligner.stats)

    result_metrics: dict = {}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else
                   "cpu", "count": 1, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace_on:
        if calls.on:          # the window ended inside the profiled slice
            calls.on = False
            if prof is not None:
                prof.stop()
        spans.remove()
        calls.remove()
        k1_calls, k2_calls = calls.host()
        sl = None
        if prof is not None:
            prof.read()
            sl = prof.summary(spans)
            sl["wall_s"] = prof.wall_s
            device_info["busy_s"] = sl["busy_s"]
            device_info["window_s"] = prof.wall_s
            breakdown = {"device_ops": sl["device_ops"],
                         "idle_gaps": sl["idle_gaps"]}
            log(f"profiled slice: {prof.wall_s:.3f} s, {sl['n_events']} "
                f"device events, busy {sl['busy_s']:.3f} s", file=sys.stderr)
        peak, power = _card_peak(on_card, log)
        device_info["power_limit_w"] = power
        log(f"tracer: stopping it took {tracer_s:.3f} s of the window",
            file=sys.stderr)
        td = TraceData(window_s - tracer_s, dict(spans.total), stats, paired,
                       sl,
                       k1_calls, k2_calls,
                       {k: getattr(opt, k) for k in
                        ("a", "o_del", "e_del", "o_ins", "e_ins")}, peak)
        for m in per_layer_for(bench, workload):
            v = importlib.import_module(
                f"{__package__}.metrics.{m['name']}").read(td)
            if v is not None:
                result_metrics[m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
    else:
        for m in end_to_end_for(bench, workload):
            v = importlib.import_module(
                f"{__package__}.end_to_end.{m['name']}").read(totals)
            result_metrics[m["name"]] = {"value": float(v),
                                         "unit": m["unit"]}
    # the host's share in the spread of runs: this process's CPU time and
    # the times the kernel took a core from it, and the host's load
    log(f"host: {ru1.ru_utime - ru0.ru_utime:.1f} s user, "
        f"{ru1.ru_stime - ru0.ru_stime:.1f} s system in the window; "
        f"{ru1.ru_nivcsw - ru0.ru_nivcsw} involuntary switches; load "
        f"{load0[0]:.2f} at its start, {os.cpu_count()} cores",
        file=sys.stderr)
    log("window: batch SAM at " + " ".join(f"{t:.3f}" for t in t_sam) +
        " s", file=sys.stderr)
    log(f"window: {len(texts)} batches of a pool of {len(pool)}, {n_reads} "
        f"reads in {window_s:.3f} s"
        f" ({n_reads / window_s:.1f} reads/s); set-up {setup_s:.3f} s, "
        f"built {built or 'nothing'}; stats {_short(stats)}",
        file=sys.stderr)

    # ---- free the program's state, then check ----
    del aligner, stream, idx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, n_failed = check_window(cfg, g, pool, order, texts, seed,
                                    paired, cache, procs, log)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    res = {"correct": correct, "attempted": n_reads, "failed": n_failed,
           "metrics": result_metrics, "device": device_info}
    if breakdown is not None:
        res["breakdown"] = breakdown
    # a set-up that built caches or kernels is a checkout's first run's:
    # its setup_s is not a warm one
    res["setup_built"] = built
    res["checks"] = checks
    return res


def check_picks(n: int, seed: int) -> list:
    """Which of a window's n batches the check compares: the first, the
    last and ``CHECK_DRAWN`` drawn from the seed among the others."""
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 2])
    inner = range(1, n - 1)
    drawn = rng.choice(inner, size=min(CHECK_DRAWN, len(inner)),
                       replace=False) if len(inner) else []
    return sorted({0, n - 1, *(int(j) for j in drawn)})


def check_window(cfg, g, pool, order, texts, seed, paired, cache,
                 procs, log):
    """The window's first and last batches and ``CHECK_DRAWN`` more drawn
    from the seed, every SAM record compared with the reference's ->
    (checks, records that differ)."""
    t0 = time.perf_counter()
    pick = check_picks(len(order), seed)
    d = check.ensure_ref_index(cfg, g, cache)
    t1 = time.perf_counter()
    diff = lines = 0
    with check.Reference(cfg, d, procs or check.default_procs()) as ref:
        for j in pick:
            b = pool[order[j]]
            want = ref.sam(b, j * (b.n // 2 if paired else b.n), paired)
            got = texts[j] if j < len(texts) else ""
            diff += check.lines_differing(got, want)
            lines += want.count("\n")
    diff += abs(len(texts) - len(order))    # batches the stream never gave
    log(f"reference: batches {pick} of {len(order)}, {lines} records, "
        f"index {t1 - t0:.1f} s, alignment {time.perf_counter() - t1:.1f} s",
        file=sys.stderr)
    return {"sam_lines_differing": {"value": diff, "limit": 0}}, diff


def _card_peak(on_card: bool, log):
    """(int32 operations a second, power limit in W) of card 0."""
    if not on_card:
        return roofline.int32_peak(132, 1980.0), None
    import torch
    props = torch.cuda.get_device_properties(0)
    vals = trace.nvidia_smi("clocks.max.sm,power.limit")
    try:
        clock, power = float(vals[0]), float(vals[1])
    except (IndexError, ValueError):
        log(f"card: nvidia-smi gave {vals}; no int32 peak", file=sys.stderr)
        return None, None
    peak = roofline.int32_peak(props.multi_processor_count, clock)
    log(f"card: {torch.cuda.get_device_name(0)}, {props.multi_processor_count}"
        f" SMs, max SM clock {clock} MHz, int32 peak {peak / 1e12:.3f} TOP/s,"
        f" power limit {power} W", file=sys.stderr)
    return peak, power


def _short(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if not isinstance(v, list)}
