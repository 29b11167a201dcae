"""Tier-1 seeding budgets against their cost on the 4.6 Mbp bench workload:
for each ``LutSeedConfig`` variant, worker1's steady time and the reads
that overflow tier 1 (each costs a big-caps re-run). The counterpart of
``scripts/tune_budgets.py``.

The dense budgets of the LUT walk are sized from the batch:
``D = max(B*L // fm_dense, 256)`` lanes for the FM steps and ``D3 =
max(B*L // offdiag_dense, 256)`` for the off-diagonal reseeding
(``seed/lut.py``); ``max_reseed`` caps the reseeding rounds. Each variant
is ``Aligner._make_packed`` with the aligner's seeding config and those
fields replaced. The overflow is read from the packed buffer through
``Aligner._unpack_host``, which reads the flag at bit 10 of a read's count
word (the reference script reads bit 6, a bit of the region count, and so
reports 0 for every variant).

Usage: python -m tpubwa_torch.tools.tune_budgets [batch] [variant ...]
           [--platform cuda|cpu]
  variant syntax: name=val,name=val (LutSeedConfig field overrides); the
  default sweep (seven variants) when none is given.
Runs on the card and raises without one unless ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

DEFAULT_VARIANTS = (
    {},
    {"fm_dense": 16},
    {"fm_dense": 8},
    {"offdiag_dense": 4},
    {"fm_dense": 16, "offdiag_dense": 4},
    {"fm_dense": 8, "offdiag_dense": 4},
    {"max_reseed": 4},
)


def parse_variant(text: str) -> dict:
    """``"fm_dense=8,offdiag_dense=4"`` -> {"fm_dense": 8, ...}."""
    return {k: int(v) for k, v in (kv.split("=") for kv in text.split(","))}


def tag(ov: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in ov.items()) or "base"


def tune_budgets(aln, batch, variants=DEFAULT_VARIANTS, reps: int = 3) -> dict:
    """Each variant's first and best-of-``reps`` worker1 time (ms) and its
    tier-1 overflow on ``batch``."""
    from .scale_bench import sync
    seqs, lens = aln._to_device(batch.seqs), aln._to_device(batch.lens)
    rows = []
    for ov in variants:
        fn = aln._make_packed(dataclasses.replace(aln.scfg, **ov), aln.ccfg,
                              aln.ecfg)
        sync(aln)
        t0 = time.perf_counter()
        out = fn(seqs, lens)
        sync(aln)
        first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(seqs, lens)
            sync(aln)
            best = min(best, time.perf_counter() - t0)
        ovf = aln._unpack_host(out.cpu().numpy(), batch.n)[1]
        rows.append({"variant": tag(ov), "w1_ms": best * 1e3,
                     "first_ms": first * 1e3, "overflow": int(ovf.sum())})
    return {"batch": batch.n, "reps": reps, "variants": rows,
            "device": aln.device.type}


def main(argv=None) -> int:
    from . import bench_world as bw
    from .scale_bench import require_card
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.tune_budgets",
        description="worker1 time and tier-1 overflow of seeding-budget "
                    "variants on the 4.6 Mbp bench batch")
    ap.add_argument("args", nargs="*", metavar="[batch] [variant ...]")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    args = list(a.args)
    batch_n = int(args.pop(0)) if args and args[0].isdigit() else bw.BATCH
    variants = [parse_variant(v) for v in args] or DEFAULT_VARIANTS
    require_card(a.platform, "tune_budgets")
    aln = bw.make_aligner(a.platform)
    r = tune_budgets(aln, bw.reads(aln.idx, batch_n), variants)
    for row in r["variants"]:
        print(f"{row['variant']:40s} w1={row['w1_ms']:7.1f} ms  "
              f"ovf={row['overflow']:5d}/{batch_n}  "
              f"(first {row['first_ms'] / 1e3:.1f}s)", flush=True)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
