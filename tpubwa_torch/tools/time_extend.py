"""The extension stage bisected on the 4.6 Mbp bench workload: the
counterpart of ``scripts/time_extend.py``.

Cumulative rows through ``extend/worker.py::extend_chains``' debugging
cuts (``_stop_after``), each after seeding, chaining and the filter. With
the task-parallel engine (tier 1's configuration): the preamble, + first-
seed extension (tp1), + candidate mask (tp2), + candidate kernels (tp3),
+ replay (the whole stage); with the round engine: + selection loop 1, +
round-1 kernels, + selection loop 2, + tail rounds. Then two rows at the
production width ``WREF = L + 2 * cal_max_gap(L)``: the four window
gathers of ``ops/window.py`` alone, and one call of the banded-extension
kernel K1 (``ops/sw.py::ksw_extend``; the reference's ``pallas kernel
x1``) on the reference's synthetic tasks: targets ``arange(WREF) % 4``,
``tlen = 100 + (i*37) % (WREF-100)``, h0 19, band 100, end bonus 5. The
measurement rule is time_stages.py's: fresh batch content a rep, one
int32 checksum a row, timed from dispatch to ``.item()``, best of
``reps``. The task-parallel rows are preceded by the candidate count of
one fresh batch (the tp2 cut's count a read).

The reference picks the rows from the aligner's engine; ``--round`` runs
the round engine's rows with tier 3's extension configuration
(``Aligner._tier_configs(3)``) on tier 1's seeds and chains, so that both
engines can be bisected on the card.

Usage: python -m tpubwa_torch.tools.time_extend [batch] [--round]
           [--seed N] [--platform cuda|cpu]
Runs on the card and raises without one unless ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import bench_world, time_stages
from .time_stages import csum, fresh, time_rows

TASK_PARALLEL_ROWS = (("chain+filter+pre", "pre"), ("+tp1 first-seed", "tp1"),
                      ("+tp2 cand mask", "tp2"), ("+tp3 cand kernels", "tp3"),
                      ("+tp4 replay (full)", ""))
ROUND_ROWS = (("chain+filter (base)", "pre"), ("+sel loop 1", "sel1"),
              ("+round1 kernels", "round1"), ("+sel loop 2", "sel2"),
              ("+tail (full)", ""))
KERNEL_ROW = "K1 kernel x1"


def upto(aln, ecfg, stop: str, reduce=csum):
    """Seeding, chaining, filter and the extension cut after ``stop``;
    ``reduce`` maps the extension state to what the row returns."""
    return time_stages.upto(aln, aln.scfg, "extend", ecfg, stop, reduce)


def wref(ecfg, L: int) -> int:
    from ..extend.worker import cal_max_gap
    return L + 2 * cal_max_gap(ecfg, L)


def windows(aln, ecfg):
    """The four window gathers at width WREF on read-derived positions."""
    import torch

    from ..ops.window import (query_window_asc, query_window_desc,
                              text_window_asc, text_window_desc)

    def f(seqs, lens):
        L = seqs.shape[1]
        W = wref(ecfg, L)
        pos = (seqs.sum(dim=1).abs().to(torch.int64) * 9973) % \
            aln.didx.l_pac
        return csum((text_window_desc(aln.didx, pos + 100, W),
                     text_window_asc(aln.didx, pos + 100, W),
                     query_window_desc(seqs, lens // 2, L),
                     query_window_asc(seqs, lens // 2, L)))
    return f


def kernel_args(seqs, lens, W: int) -> tuple:
    """K1's inputs of the kernel row: the batch's reads as queries, the
    reference's synthetic targets and lengths; all int32 on the reads'
    device."""
    import torch
    N = seqs.shape[0]
    dev = seqs.device

    def full(v):
        return torch.full((N,), v, dtype=torch.int32, device=dev)
    t = (torch.arange(W, dtype=torch.int32, device=dev) % 4)[None, :] \
        .expand(N, W).contiguous()
    tl = 100 + (torch.arange(N, dtype=torch.int32, device=dev) * 37) % \
        (W - 100)
    return (seqs.to(torch.int32).contiguous(), lens.to(torch.int32), t,
            tl.to(torch.int32), full(19), full(100), full(5), full(1))


# the bwa scores the aligner's extension runs with (MemOptions defaults)
SCORES = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100, a=1, b=4)


def kernel(ecfg, record=None):
    """One K1 call on kernel_args; ``record`` (a list) keeps its inputs."""
    from ..ops.sw import ksw_extend

    def f(seqs, lens):
        args = kernel_args(seqs, lens, wref(ecfg, seqs.shape[1]))
        if record is not None:
            record.append(args)
        return csum(ksw_extend(*args, **SCORES))
    return f


def candidates(aln, batch_n: int, seed: int) -> dict:
    """The tp2 cut's candidate count on one fresh batch (the first draw of
    ``seed``): the total and the most a read."""
    rng = np.random.default_rng(seed)
    n = upto(aln, aln.ecfg, "tp2", reduce=lambda st: st["n"])(
        *fresh(aln, batch_n, rng))
    return {"total": int(n.sum()), "max_per_read": int(n.max())}


def time_extend(aln, batch_n: int = 4096, round_engine: bool = False,
                seed: int = 0, reps: int = 3, record=None) -> dict:
    """The rows of one engine: the aligner's (task-parallel at tier 1) or,
    with ``round_engine``, the round engine under tier 3's extension
    configuration. ``record`` keeps the kernel row's K1 inputs."""
    ecfg = aln._tier_configs(3)[2] if round_engine else aln.ecfg
    table = TASK_PARALLEL_ROWS if ecfg.task_parallel else ROUND_ROWS
    rows = [(name, upto(aln, ecfg, stop)) for name, stop in table] + \
        [("windows only(x4)", windows(aln, ecfg)),
         (KERNEL_ROW, kernel(ecfg, record))]
    out = {"batch": batch_n, "engine": "task_parallel"
           if ecfg.task_parallel else "round", "seed": seed, "reps": reps,
           "wref": wref(ecfg, bench_world.READ_LEN),
           "device": aln.device.type}
    if ecfg.task_parallel:
        # drawn from a seed of its own, so the rows' draws stay those of
        # ``seed``
        out["candidates"] = candidates(aln, batch_n, seed + 1)
    out["rows"] = time_rows(aln, rows, batch_n, seed, reps)
    return out


def report(r: dict) -> None:
    """The reference script's lines."""
    if "candidates" in r:
        c = r["candidates"]
        print(f"candidates: total={c['total']} / B={r['batch']} "
              f"max/read={c['max_per_read']}", flush=True)
    for row in r["rows"]:
        print(f"{row['row']:22s} {row['ms']:8.1f} ms   "
              f"(+{row['inc_ms']:7.1f})", flush=True)


def main(argv=None) -> int:
    from .scale_bench import require_card
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.time_extend",
        description="extension-stage bisection on the 4.6 Mbp bench "
                    "workload")
    ap.add_argument("batch", type=int, nargs="?", default=bench_world.BATCH)
    ap.add_argument("--round", action="store_true",
                    help="the round engine's rows (tier 3's extension "
                         "configuration)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    require_card(a.platform, "time_extend")
    aln = bench_world.make_aligner(a.platform)
    r = time_extend(aln, a.batch, a.round, a.seed)
    report(r)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
