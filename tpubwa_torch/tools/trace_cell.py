"""The recorder's spans and host syncs (``utils/profiling.py``) at a
benchmark cell's size: the cell's world and traffic from
``benchmark/world.py``, its runs from ``benchmark/harness.py``, both
driven as they are.

Modes:
  preview   a ``--trace 1`` run of the cell with the recorder installed
            over the window: the harness's result line, plus the per-layer
            metrics of ``PROPOSED`` read from the recorder (``READERS``),
            and the profiled batch's idle gaps put down to the program's
            spans as well as the harness's;
  syncs     one warm batch of the cell's traffic under
            ``torch.cuda.set_sync_debug_mode("warn")``: each synchronizing
            call PyTorch reports, by file:line, and whether the recorder
            counted it, against the recorder's own count;
  overhead  four untraced runs of the cell (the ``--trace 0`` window, the
            check against the reference left out), the recorder off, on,
            on, off: reads/s of each;
  sitecost  what a span and a sync site cost on this host, the recorder
            off and on (ns, CPU tensors; no card needed).

Usage: python -m tpubwa_torch.tools.trace_cell MODE [--workload NAME]
           [--seed N] [--seconds S] [--out DIR]
Every mode but ``sitecost`` runs on the card and exits 2 without one.
Results go to standard output as JSON, and to ``DIR/<mode>_<cell>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import types
import warnings
from pathlib import Path
from unittest import mock

from ..utils import profiling

# the per-layer metrics these readers give, as benchmark entries
PROPOSED = [
    dict(name=f"{s}_wall_pct", unit="%", better="lower",
         source="program_span", layer=layer, moves="reads_per_s")
    for s, layer in (("seed", "worker1 stages"), ("chain", "worker1 stages"),
                     ("extend", "worker1 stages"), ("tier2", "tiers 2-3"),
                     ("tier3", "tiers 2-3"))] + [
    dict(name="host_syncs_per_kread", unit="syncs/kread", better="lower",
         source="program_counter", layer="host-device boundary",
         moves="reads_per_s"),
    dict(name="sync_wait_pct", unit="%", better="lower",
         source="program_span", layer="host-device boundary",
         moves="reads_per_s")]


def span_s(program: dict, name: str) -> float:
    """Seconds in every span named ``name``, at any depth (``*/seed``)."""
    return sum(v for p, v in program["totals"].items()
               if p.rsplit("/", 1)[-1] == name)


def _wall_pct(name: str):
    def read(t):
        prog = getattr(t, "program", None)
        if prog is None or t.window_s <= 0:
            return None
        return 100.0 * span_s(prog, name) / t.window_s
    read.__doc__ = (f"Every ``{name}`` span's seconds (any depth) over the "
                    f"window's; None without a program trace.")
    return read


def host_syncs_per_kread(t):
    """The recorder's blocking reads, all spans, a thousand reads aligned
    in the window (``stats["reads"]``)."""
    prog = getattr(t, "program", None)
    n = t.stats.get("reads", 0)
    if prog is None or not n:
        return None
    return 1000.0 * sum(prog["syncs"].values()) / n


def sync_wait_pct(t):
    """The seconds the host waited in the recorder's blocking reads, all
    spans, over the window's."""
    prog = getattr(t, "program", None)
    if prog is None or t.window_s <= 0:
        return None
    return 100.0 * sum(prog["sync_wait"].values()) / t.window_s


READERS = {m["name"]: _wall_pct(m["name"][:-len("_wall_pct")])
           for m in PROPOSED if m["name"].endswith("_wall_pct")}
READERS.update(host_syncs_per_kread=host_syncs_per_kread,
               sync_wait_pct=sync_wait_pct)


def _by_span(program: dict) -> str:
    rows = [f"  {p or '(no span)'}: {program['totals'].get(p, 0.0):.3f} s, "
            f"{program['counts'].get(p, 0)} opened, "
            f"{program['syncs'].get(p, 0)} syncs, "
            f"{program['sync_wait'].get(p, 0.0):.3f} s waited"
            for p in sorted(set(program["totals"]) | set(program["syncs"]))]
    return "\n".join(["program spans:"] + rows)


def preview(bench: dict, workload: str, seed: int, seconds: float,
            log=print, **run_kw) -> dict:
    """A traced run of the cell with the recorder installed from the
    harness's spans' install to their removal (the window): the result
    line with ``READERS``' metrics added, its idle gaps labelled by the
    program's spans too (the innermost span wins), and ``program``, the
    recorder's summary less its intervals."""
    from benchmark import harness, trace
    held: dict = {}
    install, remove = trace.Spans.install, trace.Spans.remove
    per_layer_for = harness.per_layer_for

    def install_(self, aligner):
        install(self, aligner)
        held["ctx"] = profiling.tracing()
        held["rec"] = held["ctx"].__enter__()

    def remove_(self):
        remove(self)
        held.pop("ctx").__exit__(None, None, None)
        held["program"] = held.pop("rec").summary()
        self.intervals.extend(held["program"]["intervals"])
        log(_by_span(held["program"]), file=sys.stderr)

    def module(name):
        def read(t):
            t.program = held.get("program")
            return READERS[name](t)
        return types.SimpleNamespace(read=read)

    mods = {f"benchmark.metrics.{m['name']}": module(m["name"])
            for m in PROPOSED}
    with contextlib.ExitStack() as ex:
        ex.enter_context(mock.patch.object(trace.Spans, "install", install_))
        ex.enter_context(mock.patch.object(trace.Spans, "remove", remove_))
        ex.enter_context(mock.patch.object(
            harness, "per_layer_for", lambda b, w: per_layer_for(b, w) + [
                dict(m, workloads=[w]) for m in PROPOSED]))
        ex.enter_context(mock.patch.dict(sys.modules, mods))
        res = harness.run_cell(bench, workload, seed, seconds, True,
                               time.perf_counter(), log=log, **run_kw)
    prog = dict(held.get("program") or {})
    prog.pop("intervals", None)
    res["program"] = prog
    return res


def _short(path: str) -> str:
    i = path.rfind("tpubwa_torch")
    return path[i:] if i >= 0 else path


def sync_check(bench: dict, workload: str, seed: int) -> dict:
    """Every synchronizing call that PyTorch reports over one warm batch
    of the cell's traffic (batch 0 of the seed, after the warm-up batch),
    by the file:line it names, split by whether the recorder was inside
    a counted read then; and the recorder's count of the same batch."""
    import torch

    from benchmark import harness, world

    from ..pipeline import Aligner
    cell = world.find_cell(bench, workload)
    cfg, trf = cell.config, cell.traffic
    g = world.genome(cfg)
    idx, ikey = world.program_index(cfg, g)
    aligner = Aligner(idx, world.mem_options(cfg),
                      lut_cache=world.lut_path(cfg, ikey))
    stream = aligner.align_pe_stream if trf["kind"] == "pe" else \
        aligner.align_se_stream
    warm, batch = (harness._program_batch(world.make_batch(trf, g, seed, i))
                   for i in (-1, 0))
    for _ in stream([warm]):
        pass
    torch.cuda.synchronize()
    found: dict = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        site = f"{_short(filename)}:{lineno}"
        if "tpubwa_torch" not in filename:
            # raised in a library's Python code: add the program's line
            # that called it, the innermost on the stack
            f = sys._getframe(1)
            while f is not None and "tpubwa_torch" not in \
                    f.f_code.co_filename:
                f = f.f_back
            if f is not None:
                site = f"{_short(f.f_code.co_filename)}:{f.f_lineno} " \
                       f"via {site}"
        key = (site, rec.in_sync())
        found[key] = found.get(key, 0) + 1

    with profiling.tracing() as rec, warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in stream([batch]):
                pass
        finally:
            torch.cuda.set_sync_debug_mode(0)
    s = rec.summary()
    counted = sum(n for (_, inside), n in found.items() if inside)
    return {"workload": workload, "seed": seed, "reads": batch.n,
            "warned": sum(found.values()), "warned_counted": counted,
            "warned_uncounted": {site: n for (site, inside), n in
                                 sorted(found.items()) if not inside},
            "warned_counted_sites": {site: n for (site, inside), n in
                                     sorted(found.items()) if inside},
            "recorder_syncs": sum(s["syncs"].values()),
            "recorder_by_span": s["syncs"],
            "recorder_by_site": dict(sorted(s["sync_sites"].items()))}


def overhead(bench: dict, workload: str, seed: int, seconds: float,
             log=print) -> list:
    """Four untraced runs of the cell, the recorder installed over the
    window (the stream's second call; its first is the harness's
    warm-up) in the middle two: off, on, on, off; the check is left out.
    Returns one row a run."""
    from benchmark import harness

    from ..pipeline import Aligner
    rows = []
    for state in ("off", "on", "on", "off"):
        held: dict = {}

        def traced(orig):
            def stream(self, batches, id0=0, depth=2):
                held["calls"] = held.get("calls", 0) + 1
                if held["calls"] == 1:
                    yield from orig(self, batches, id0, depth)
                    return
                with profiling.tracing() as rec:
                    yield from orig(self, batches, id0, depth)
                held["program"] = rec.summary()
            return stream

        with contextlib.ExitStack() as ex:
            ex.enter_context(mock.patch.object(
                harness, "check_window", lambda *a, **k: ({}, 0)))
            if state == "on":
                for m in ("align_se_stream", "align_pe_stream"):
                    ex.enter_context(mock.patch.object(
                        Aligner, m, traced(getattr(Aligner, m))))
            res = harness.run_cell(bench, workload, seed, seconds, False,
                                   time.perf_counter(), log=log)
        prog = held.get("program")
        rows.append({"recorder": state,
                     "reads_per_s": res["metrics"]["reads_per_s"]["value"],
                     "syncs": sum(prog["syncs"].values()) if prog else None,
                     "spans": sum(prog["counts"].values()) if prog else None})
        log(f"overhead: {rows[-1]}", file=sys.stderr)
    return rows


def site_cost(n: int = 100_000) -> dict:
    """ns a call on this host: a span's ``with`` block and a ``synced()``
    block, each less an empty function call, and ``host_any`` less a bare
    ``bool(x.any())`` (an 8-element CPU tensor); with the recorder off and
    on. Each the least of seven loops of n."""
    import timeit

    import torch
    g = {"x": torch.zeros(8, dtype=torch.bool), "p": profiling,
         "bare": lambda: None}

    def ns(stmt):
        return min(timeit.repeat(stmt, repeat=7, number=n, globals=g)) \
            / n * 1e9
    res = {}
    for state in ("off", "on"):
        ctx = profiling.tracing() if state == "on" else \
            contextlib.nullcontext()
        with ctx:
            empty, any_ = ns("bare()"), ns("bool(x.any())")
            res[state] = {
                "span": ns("with p.span('x'): pass") - empty,
                "synced": ns("with p.synced(): pass") - empty,
                "host_any_extra": ns("p.host_any(x)") - any_}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("preview", "syncs", "overhead",
                                     "sitecost"))
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=2**31 + 20)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default="build/trace_cell")
    a = ap.parse_args(argv)
    if a.mode == "sitecost":
        out = site_cost()
    else:
        import torch
        if not torch.cuda.is_available():
            print("trace_cell: no CUDA card", file=sys.stderr)
            return 2
        if not a.workload:
            ap.error(f"{a.mode} needs --workload")
        from benchmark import world
        bench = world.load_json(world.REPO / "BENCHMARK.json")
        if a.mode == "preview":
            out = preview(bench, a.workload, a.seed, a.seconds)
        elif a.mode == "syncs":
            out = sync_check(bench, a.workload, a.seed)
        else:
            out = overhead(bench, a.workload, a.seed, a.seconds)
        out = {"device": torch.cuda.get_device_name(0), "result": out}
    d = Path(a.out)
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{a.mode}_{a.workload or 'host'}.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
