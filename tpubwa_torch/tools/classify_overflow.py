"""Which cap drives tier-1 and tier-2 overflow at genome scale, by the
scalar oracle's own counts. The counterpart of
``scripts/classify_overflow.py``; host only (the native oracle and the
host index), no card.

For SE 100 bp reads (seed 3) of the cached scale world, the oracle's SMEMs
(``Oracle.smems``), seeds (each SMEM's occurrences, at most ``max_occ``),
and, unless ``--fast``, chains before the filter and pre-dedup regions,
each read against the tier-1 caps T1 and the tier-2 caps T2. Two faults of
the reference script are not copied: it takes column 3 of the oracle's
SMEM rows ``(k, l, s, qbeg, qend)``, the query begin, as the occurrence
count ``s`` (column 2), and it counts the seed rows of the oracle's chains
(one row a seed) as chains.

A read that the device flags after seeding while the oracle's counts are
inside every cap was flagged by the seeding walk's batch-wide dense
budgets, not by a cap: ``split`` counts both kinds.

Usage: python -m tpubwa_torch.tools.classify_overflow [n_reads]
           [genome_mbp] [--fast | --no-fast]
The world must have been prepared (``python -m tpubwa_torch.tools.
scale_bench 4096 <genome_mbp> --prepare``); the default is 64 Mbp.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from . import scale_bench as sb

CAPS = ("smems", "seeds", "chains", "regs")
T1 = dict(smems=32, seeds=128, chains=32, regs=32)
T2 = dict(smems=63, seeds=640, chains=64, regs=63)


def oracle_counts(oracle, batch, opt, fast: bool = True) -> np.ndarray:
    """(n, 4) int64: the oracle's SMEM, seed, chain and region counts of
    each read, in CAPS order; chains and regions are 0 when ``fast``."""
    out = np.zeros((batch.n, len(CAPS)), np.int64)
    for i in range(batch.n):
        seq = batch.seqs[i][:batch.lens[i]]
        sm = oracle.smems(seq, opt)           # rows (k, l, s, qbeg, qend)
        out[i, 0] = len(sm)
        out[i, 1] = np.minimum(sm[:, 2], opt.max_occ).sum()
        if not fast:
            ch = oracle.chains(seq, opt, filtered=False)  # one row a seed
            out[i, 2] = len(np.unique(ch[:, 3]))
            out[i, 3] = len(oracle.regs_pre(seq, opt)[0])
    return out


def over(counts: np.ndarray, caps: dict) -> np.ndarray:
    """Reads whose count exceeds a cap of ``caps``."""
    return (counts > np.array([caps[k] for k in CAPS])).any(axis=1)


def classify(counts: np.ndarray, genome_mbp: float) -> dict:
    """The reference script's JSON keys from the counts."""
    o2 = over(counts, T2)
    c = {"tier1_overflow": int(over(counts, T1).sum()),
         "tier2_overflow": int(o2.sum()),
         **{f"t2_cap_{k}": int((o2 & (counts[:, j] > T2[k])).sum())
            for j, k in enumerate(CAPS)}}
    st = counts[:, 1]
    return {
        "n_reads": len(counts), "genome_mbp": genome_mbp,
        # a count of 0 is left out, as the reference's Counter leaves it
        **{k: v for k, v in sorted(c.items()) if v},
        "seed_count_p50": int(np.percentile(st, 50)),
        "seed_count_p90": int(np.percentile(st, 90)),
        "seed_count_p99": int(np.percentile(st, 99)),
        "seed_count_max": int(st.max()),
        "t2_need_seeds_cap_for_99pct": int(np.percentile(st, 99)),
    }


def classify_overflow(oracle, batch, opt, genome_mbp: float,
                      fast: bool = True) -> dict:
    return {**classify(oracle_counts(oracle, batch, opt, fast), genome_mbp),
            "fast": fast}


def split(seeded: np.ndarray, counts: np.ndarray, caps: dict) -> dict:
    """Reads the device flagged after seeding (``seeded``), reads whose
    oracle counts exceed a cap, and the reads flagged after seeding with
    every count inside the caps: those the dense budgets flagged."""
    capped = over(counts, caps)
    return {"reads": len(seeded), "after_seeding": int(seeded.sum()),
            "over_a_cap": int(capped.sum()),
            "seeding_and_cap": int((seeded & capped).sum()),
            "dense_budgets": int((seeded & ~capped).sum())}


def run(n_reads: int = 2048, mbp: float = 64, fast: bool = True,
        profile: str | None = None, build_dir: Path = sb.BUILD) -> dict:
    from ..opts import MemOptions
    from ..oracle import Oracle
    g, idx = sb.load_cached(mbp, {}, profile, build_dir)
    return classify_overflow(Oracle(idx), sb.se_batch(g, n_reads),
                             MemOptions(), mbp, fast)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.classify_overflow",
        description="the oracle's per-read counts against the tier caps")
    ap.add_argument("n_reads", type=int, nargs="?", default=2048)
    ap.add_argument("genome_mbp", type=float, nargs="?", default=64)
    ap.add_argument("--fast", action=argparse.BooleanOptionalAction,
                    default=True, help="SMEMs and seeds only (default); "
                    "--no-fast also counts chains and regions")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.n_reads, a.genome_mbp, a.fast)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
