"""worker1's stages timed one by one on one bench batch (LUT seeding): the
counterpart of ``scripts/profile_phases.py``.

On one batch of 4096 bench reads (``tools/bench_world.py``, seed 7) each
stage of ``dist/mesh.py::worker1_step`` runs on its own, on the previous
stage's output: ``collect_smems_lut``, ``seeds_from_smems``,
``chain_seeds``, ``chain_filter``, ``extend_chains``; then the fused
``Aligner.worker1_packed`` and one whole ``align_se`` (tiers and host
finish included). Each stage runs once to warm up and then three times,
each run ending in ``torch.cuda.synchronize()``; a row is the best of the
three (``align_se`` is one run). The reference compiles each stage on
its own; here the stage functions are called as they are. Printed: ms and
reads/s a row, the reads that overflow seeding, and the SAM's line count.

Usage: python -m tpubwa_torch.tools.profile_phases [batch]
           [--platform cuda|cpu]
Runs on the card and raises without one unless ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

REPS = 3
ROWS = ("seed (LUT SMEM walk)", "sa_walk", "chain", "filter", "extend",
        "worker1_packed (fused)", "align_se total (incl host+tier2)")


def profile_phases(aln, batch, reps: int = REPS) -> dict:
    """Each stage's best-of-``reps`` time on ``batch``, the fused
    worker1's and one align_se's; the seeding overflow and the SAM's line
    count."""
    import torch

    from ..chain.device import chain_filter, chain_seeds, seeds_from_smems
    from ..extend.worker import extend_chains
    from ..seed.lut import collect_smems_lut
    from .scale_bench import sync
    d = aln.didx
    seqs = aln._to_device(batch.seqs).to(torch.int32)
    lens = aln._to_device(batch.lens).to(torch.int32)

    def timeit(f):
        r = f()                          # warm-up
        sync(aln)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            r = f()
            sync(aln)
            best = min(best, time.perf_counter() - t0)
        return best, r

    t_seed, smems = timeit(lambda: collect_smems_lut(d, aln.lut, seqs, lens,
                                                     aln.scfg))
    t_sa, seeds = timeit(lambda: seeds_from_smems(d, smems, aln.ccfg))
    t_chain, ch = timeit(lambda: chain_seeds(d, seeds, aln.ccfg))
    t_filter, flt = timeit(lambda: chain_filter(ch, aln.ccfg))
    t_ext, _ = timeit(lambda: extend_chains(d, seqs, lens, seeds, ch,
                                            aln.ecfg, flt))
    t_w1, _ = timeit(lambda: aln.worker1_packed(seqs, lens))
    sync(aln)
    t0 = time.perf_counter()
    sam = aln.align_se(batch)
    t_total = time.perf_counter() - t0
    times = (t_seed, t_sa, t_chain, t_filter, t_ext, t_w1, t_total)
    return {"batch": batch.n, "reps": reps, "device": aln.device.type,
            "rows": [{"row": k, "ms": v * 1e3, "reads_per_s": batch.n / v}
                     for k, v in zip(ROWS, times)],
            "seed_overflows": int(smems["overflow"].sum()),
            "sam_lines": sam.count("\n")}


def report(r: dict) -> None:
    """The reference script's lines."""
    print(f"backend={r['device']} batch={r['batch']}")
    for row in r["rows"]:
        print(f"  {row['row']:36s} {row['ms']:9.1f} ms   "
              f"{row['reads_per_s']:10.0f} reads/s")
    print(f"  seed overflows: {r['seed_overflows']}")
    print(f"  sam lines: {r['sam_lines']}", flush=True)


def main(argv=None) -> int:
    from . import bench_world
    from .scale_bench import require_card
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.profile_phases",
        description="worker1's stages one by one on one 4.6 Mbp bench "
                    "batch")
    ap.add_argument("batch", type=int, nargs="?", default=bench_world.BATCH)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    require_card(a.platform, "profile_phases")
    aln = bench_world.make_aligner(a.platform)
    r = profile_phases(aln, bench_world.reads(aln.idx, a.batch))
    report(r)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
