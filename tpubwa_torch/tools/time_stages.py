"""worker1's stages bisected by cumulative prefixes on the 4.6 Mbp bench
workload: the counterpart of ``scripts/time_stages.py``.

Eleven rows, each a prefix of the device pipeline: the LUT walk cut after
its LUT gather, FM stage 1, FM stage 2 and the diagonal compare
(``seed/lut.py::_walk_lut``'s ``_stop_after``), the whole walk, both
seeding rounds, then + SA walk, + chaining, + filter, + extension, and
the production ``Aligner._make_packed`` call. The measurement rule is the
reference's: every rep runs on batch content it has not seen, and each
row reduces all its outputs to ONE int32 checksum on the device
(``csum``); a rep is timed from dispatch to the checksum's ``.item()``.
Each row prints its best of ``reps`` (3) and its increment over the row
before. The reference draws each rep's reads from ``os.urandom``; here a
rep's read seed comes from ``numpy.random.default_rng(--seed)``, so the
content stays fresh a rep and a run can be repeated.

Usage: python -m tpubwa_torch.tools.time_stages [batch] [fm_dense]
           [--seed N] [--platform cuda|cpu]
Runs on the card and raises without one unless ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

ROWS = ("walk:lut", "walk:fm1", "walk:fm2", "walk:diag", "walk:full",
        "smems(all rounds)", "+sa_walk", "+chain", "+filter", "+extend",
        "packed (prod)")
WALK_CUTS = ("lut", "fm1", "fm2", "diag", "")


def leaves(tree) -> list:
    """The tensors and integers of a nest of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def csum(tree):
    """The reference's checksum: every leaf cast to int32 and summed, with
    int32 wraparound, as one int32 tensor on the leaves' device. Torch's
    integer sums do not promise to wrap, so each leaf is summed in int64
    and the total folded to a signed int32 (the same value modulo 2**32).
    A Python integer (the walk's step count, an int32 scalar in the
    reference) counts as one element."""
    import torch
    ts = [x for x in leaves(tree) if isinstance(x, torch.Tensor)]
    tot = sum(int(x) for x in leaves(tree) if not isinstance(x, torch.Tensor))
    t = torch.zeros((), dtype=torch.int64, device=ts[0].device) + tot
    for x in ts:
        t = t + x.to(torch.int64).sum()
    return (t + 2**31).remainder(2**32).sub(2**31).to(torch.int32)


def fresh(aln, n: int, rng):
    """n bench reads on the aligner's device, from the next seed of rng:
    (seqs, lens) int32."""
    import torch

    from . import bench_world
    b = bench_world.reads(aln.idx, n, int(rng.integers(0, 1 << 30)))
    return (aln._to_device(b.seqs).to(torch.int32),
            aln._to_device(b.lens).to(torch.int32))


def walk_prefix(aln, scfg, stop: str):
    """The LUT walk of round 1 cut after ``stop`` ("" = whole walk)."""
    import torch

    from ..seed.lut import _walk_lut

    def f(seqs, lens):
        ones = torch.ones((seqs.shape[0],), dtype=torch.int32,
                          device=seqs.device)
        return csum(_walk_lut(aln.didx, aln.lut, seqs, lens, ones, True,
                              scfg, _stop_after=stop))
    return f


def upto(aln, scfg, stage: str, ecfg=None, stop: str = "", reduce=csum):
    """Both seeding rounds and the stages after them up to ``stage``; at
    "extend" the extension runs with ``ecfg`` (default the aligner's), cut
    after ``stop``, and ``reduce`` maps its state to what the row
    returns."""
    from ..chain.device import chain_filter, chain_seeds, seeds_from_smems
    from ..extend.worker import extend_chains
    from ..seed.lut import collect_smems_lut

    def f(seqs, lens):
        sm = collect_smems_lut(aln.didx, aln.lut, seqs, lens, scfg)
        if stage == "smems":
            return csum(sm)
        seeds = seeds_from_smems(aln.didx, sm, aln.ccfg)
        if stage == "sa_walk":
            return csum(seeds)
        ch = chain_seeds(aln.didx, seeds, aln.ccfg)
        if stage == "chain":
            return csum(ch)
        flt = chain_filter(ch, aln.ccfg)
        if stage == "filter":
            return csum((ch, flt))
        return reduce(extend_chains(aln.didx, seqs, lens, seeds, ch,
                                    ecfg or aln.ecfg, flt, _stop_after=stop))
    return f


def stage_rows(aln, scfg) -> list:
    """(name, fn(seqs, lens) -> checksum) of the eleven rows."""
    packed = aln._make_packed(scfg, aln.ccfg, aln.ecfg)
    fns = [walk_prefix(aln, scfg, c) for c in WALK_CUTS] + \
        [upto(aln, scfg, s) for s in ("smems", "sa_walk", "chain",
                                      "filter", "extend")] + \
        [lambda s, le: csum(packed(s, le))]
    return list(zip(ROWS, fns))


def time_rows(aln, rows, batch_n: int, seed: int, reps: int) -> list:
    """Each row warmed on one fresh batch, then timed on ``reps`` more
    (dispatch to ``.item()``): its best ms, the increment over the row
    before and every call's checksum, in draw order."""
    rng = np.random.default_rng(seed)
    out, prev = [], 0.0
    for name, fn in rows:
        sums = [int(fn(*fresh(aln, batch_n, rng)).item())]
        best = float("inf")
        for _ in range(reps):
            x = fresh(aln, batch_n, rng)
            t0 = time.perf_counter()
            sums.append(int(fn(*x).item()))
            best = min(best, time.perf_counter() - t0)
        out.append({"row": name, "ms": best * 1e3,
                    "inc_ms": (best - prev) * 1e3, "csums": sums})
        prev = best
    return out


def time_stages(aln, batch_n: int = 4096, fm_dense: int = 0, seed: int = 0,
                reps: int = 3) -> dict:
    """The eleven prefix rows on fresh bench batches of ``batch_n`` reads
    (``fm_dense`` > 0 replaces the seeding config's)."""
    scfg = dataclasses.replace(aln.scfg, fm_dense=fm_dense) if fm_dense \
        else aln.scfg
    return {"batch": batch_n, "fm_dense": scfg.fm_dense, "seed": seed,
            "reps": reps, "device": aln.device.type,
            "rows": time_rows(aln, stage_rows(aln, scfg), batch_n, seed,
                              reps)}


def report(r: dict) -> None:
    """The reference script's lines."""
    for row in r["rows"]:
        print(f"{row['row']:22s} {row['ms']:8.1f} ms   "
              f"(+{row['inc_ms']:7.1f})", flush=True)


def main(argv=None) -> int:
    from . import bench_world as bw
    from .scale_bench import require_card
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.time_stages",
        description="worker1 stage bisection by cumulative prefixes on the "
                    "4.6 Mbp bench workload")
    ap.add_argument("batch", type=int, nargs="?", default=bw.BATCH)
    ap.add_argument("fm_dense", type=int, nargs="?", default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    require_card(a.platform, "time_stages")
    aln = bw.make_aligner(a.platform)
    r = time_stages(aln, a.batch, a.fm_dense, a.seed)
    report(r)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
