"""Tier-1 overflow by stage on the 4.6 Mbp bench workload: which stage and
cap sends reads to tier 2? The counterpart of ``scripts/diag_caps.py``.

worker1's stages run one by one, in the order of
``dist/mesh.py::worker1_step`` (``collect_smems_lut`` -> ``seeds_from_
smems`` -> ``chain_seeds`` -> ``chain_filter`` -> ``extend_chains``), on one
batch of bench reads (``tools/bench_world.py``) at the caps given on the
command line. The overflow flag is cumulative: each stage keeps the reads
flagged before it. Reported: the reads flagged after each stage, the reads
each stage added, the p50/p95/max of SMEMs, chains and regions a read, and
the wall time of a first and of a steady run of the stages (the card
compiles nothing, so the first run's extra is allocation and launch set-up).

Usage: python -m tpubwa_torch.tools.diag_caps [batch] [--smems N]
           [--seeds N] [--chains N] [--regs N] [--platform cuda|cpu]
Runs on the card and raises without one unless ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# worker1's stages in order; each flag array is cumulative
STAGES = ("seeding", "sa", "chaining", "extend")


def stage_flags(aln, seqs, lens, cfgs=None) -> dict:
    """One run of worker1's stages (LUT seeding) on the aligner's device
    under ``cfgs`` (scfg, ccfg, ecfg; the aligner's tier-1 configs by
    default). Returns numpy arrays a read: the cumulative overflow after
    each of STAGES and the SMEM (``n_smems``), chain (``n_chains``) and
    region (``n_regs``) counts."""
    import torch

    from ..chain.device import chain_filter, chain_seeds, seeds_from_smems
    from ..extend.worker import extend_chains
    from ..seed.lut import collect_smems_lut
    scfg, ccfg, ecfg = cfgs or (aln.scfg, aln.ccfg, aln.ecfg)
    seqs = aln._to_device(seqs).to(torch.int32)
    lens = aln._to_device(lens).to(torch.int32)
    smems = collect_smems_lut(aln.didx, aln.lut, seqs, lens, scfg)
    seeds = seeds_from_smems(aln.didx, smems, ccfg)
    ch = chain_seeds(aln.didx, seeds, ccfg)
    st = extend_chains(aln.didx, seqs, lens, seeds, ch, ecfg,
                       chain_filter(ch, ccfg))
    out = dict(zip(STAGES, (smems["overflow"], seeds["overflow"],
                            ch["overflow"], st["overflow"])),
               n_smems=smems["n"], n_chains=ch["n"], n_regs=st["n"])
    return {k: v.cpu().numpy() for k, v in out.items()}


def cumulative(flags: dict, k: int | None = None) -> dict:
    """Reads flagged after each stage and the reads each stage added, over
    the first k reads (all by default)."""
    f = {s: flags[s][:k] for s in STAGES}
    return {"overflow": {s: int(f[s].sum()) for s in STAGES},
            "added": {s: int((f[s] & ~f[p]).sum())
                      for p, s in zip(STAGES, STAGES[1:])}}


def spread(a: np.ndarray) -> list:
    """[p50, p95, max] of a count a read."""
    return [float(np.percentile(a, 50)), float(np.percentile(a, 95)),
            int(a.max())]


def diag_caps(aln, batch) -> dict:
    """The per-stage tier-1 overflow of ``batch`` under the aligner's
    configs, and the time of a first and a steady run of the stages."""
    t0 = time.perf_counter()
    flags = stage_flags(aln, batch.seqs, batch.lens)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    stage_flags(aln, batch.seqs, batch.lens)
    steady = time.perf_counter() - t0
    return {"batch": batch.n,
            "caps": {"smems": aln.scfg.max_smems,
                     "seeds": aln.ccfg.max_seeds,
                     "chains": aln.ccfg.max_chains,
                     "regs": aln.ecfg.max_regs},
            **cumulative(flags),
            **{name: spread(flags[f"n_{name}"])
               for name in ("smems", "chains", "regs")},
            "first_s": first, "steady_s": steady,
            "device": aln.device.type}


def report(r: dict) -> None:
    """The reference script's lines."""
    c, o, a, B = r["caps"], r["overflow"], r["added"], r["batch"]
    print(f"caps: smems={c['smems']} seeds={c['seeds']} "
          f"chains={c['chains']} regs={c['regs']}")
    print(f"overflow after seeding:   {o['seeding']:5d}/{B}")
    for s, label in (("sa", "SA/seeds: "), ("chaining", "chaining: "),
                     ("extend", "extend:   ")):
        print(f"overflow after {label}  {o[s]:5d}/{B}  (+{a[s]})")
    for name in ("smems", "chains", "regs"):
        p50, p95, mx = r[name]
        print(f"{name} p50/p95/max: {p50:.0f}/{p95:.0f}/{mx}")
    print(f"wall: first {r['first_s']:.1f}s, steady {r['steady_s']:.3f}s")


def main(argv=None) -> int:
    from . import bench_world as bw
    from .scale_bench import require_card
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.diag_caps",
        description="tier-1 overflow by stage on the 4.6 Mbp bench batch")
    ap.add_argument("batch", type=int, nargs="?", default=bw.BATCH)
    ap.add_argument("--smems", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=128)
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--regs", type=int, default=32)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    require_card(a.platform, "diag_caps")
    aln = bw.make_aligner(a.platform, max_smems=a.smems, max_seeds=a.seeds,
                          max_chains=a.chains, max_regs=a.regs)
    r = diag_caps(aln, bw.reads(aln.idx, a.batch))
    report(r)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
