"""Overflow after the big-caps tiers at genome scale: after tier 2 (and tier
3) re-ran the reads that overflow tier 1, which stage and cap still sends
reads to the host oracle? The counterpart of ``scripts/diag_tier2.py``.

One batch of SE 100 bp reads (seed 3) of the cached scale world goes
through ``worker1_packed`` (tier 1), then twice through the tiers as the
SE path runs them (``Aligner._tier2_dispatch`` and ``_tier2_merge``, then
``Aligner._tier3`` when enough reads are left), each tier timed. The reads
still flagged are then run stage by stage (``tools/diag_caps.py::
stage_flags``), padded to ``TIER2_ROWS`` as tier 2 pads them, under tier
2's own configuration (``Aligner._tier_configs(2)``), and for comparison
under the configuration ``scripts/diag_tier2.py`` breaks down, which
lacks tier 2's ``sa_dense``, ``max_reseed`` and task-parallel extension.

Usage: python -m tpubwa_torch.tools.diag_tier2 [genome_mbp] [batch]
           [--platform cuda|cpu]
The world must have been prepared (``python -m tpubwa_torch.tools.
scale_bench 4096 <genome_mbp> --prepare``); the default is 64 Mbp. Runs on
the card and raises without one unless ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import diag_caps
from . import scale_bench as sb


def run_tiers(aln, batch, n, ovf, l_rep, flat):
    """The big-caps tiers on the reads ``ovf`` flags, in the order of
    ``Aligner._tiers`` (which also counts the batch in ``stats``); the
    arrays are not changed. Returns the merged (n, ovf, l_rep, flat) and
    each tier's time and the reads flagged after tier 2 (tier 3's
    input)."""
    n, ovf, l_rep = n.copy(), ovf.copy(), l_rep.copy()
    t0 = time.perf_counter()
    t2 = aln._tier2_dispatch(batch, ovf) if ovf.any() else None
    if t2 is not None:
        n, ovf, l_rep, flat = aln._tier2_merge(batch, n, ovf, l_rep, flat,
                                               t2)
    t_2 = time.perf_counter() - t0
    after2 = np.flatnonzero(ovf).tolist()
    t0 = time.perf_counter()
    if ovf.any():
        n, ovf, l_rep, flat = aln._tier3(batch, n, ovf, l_rep, flat)
    t_3 = time.perf_counter() - t0
    return (n, ovf, l_rep, flat), {"tier2_fired": t2 is not None,
                                   "after_tier2": after2,
                                   "tier2_s": t_2, "tier3_s": t_3}


def script_configs(aln):
    """The big-caps configuration ``scripts/diag_tier2.py`` breaks down."""
    from ..pipeline import configs_from_opts
    from ..seed.lut import LutSeedConfig
    scfg, ccfg, ecfg = configs_from_opts(
        aln.opt, seed_impl=aln.seed_impl, text_len=2 * int(aln.idx.l_pac),
        max_smems=63, max_seeds=640, max_chains=64, max_regs=63)
    if isinstance(scfg, LutSeedConfig):
        scfg = dataclasses.replace(scfg, fm_dense=4, offdiag_dense=2,
                                   r2_rows=1)
    return scfg, ccfg, dataclasses.replace(ecfg, tail_rows=1)


def breakdown(aln, batch, rows, cfgs) -> dict:
    """The stages under ``cfgs`` on ``rows``, padded to TIER2_ROWS with
    copies of the last: the cumulative overflow of the rows themselves and
    the most SMEMs and regions of a row."""
    pad = (-len(rows)) % aln.TIER2_ROWS
    rsel = np.concatenate([rows, np.repeat(rows[-1:], pad)])
    f = diag_caps.stage_flags(aln, batch.seqs[rsel], batch.lens[rsel], cfgs)
    return {"rows": len(rows),
            "overflow": diag_caps.cumulative(f, len(rows))["overflow"],
            "smems_max": int(f["n_smems"].max()),
            "regs_max": int(f["n_regs"].max())}


def diag_tier2(aln, batch, steady: bool = True) -> dict:
    """Tier-1 overflow, the overflow after tier 2 and after the tiers (a
    first and, with ``steady``, a steady run, each tier timed), and the
    stage breakdown of the reads still flagged under tier 2's
    configuration and under the reference script's."""
    t0 = time.perf_counter()
    buf = aln.worker1_packed(batch.seqs, batch.lens).cpu().numpy()
    n, ovf, l_rep, flat = aln._unpack_host(buf, batch.n)
    tier1_s = time.perf_counter() - t0
    (_, left, _, _), first = run_tiers(aln, batch, n, ovf, l_rep, flat)
    runs = {"first": first}
    if steady:
        runs["steady"] = run_tiers(aln, batch, n, ovf, l_rep, flat)[1]
    rows = np.flatnonzero(left)
    r = {"batch": batch.n, "tier1_overflow": int(ovf.sum()),
         "tier2_fired": first["tier2_fired"],
         "after_tier2": len(first["after_tier2"]),
         "after_tiers": len(rows), "tier1_s": tier1_s,
         "after_tier2_rows": first["after_tier2"],
         "left_rows": rows.tolist(),
         **{name: {k: t[k] for k in ("tier2_s", "tier3_s")}
            for name, t in runs.items()},
         "device": aln.device.type}
    if len(rows):
        r["tier2_config"] = breakdown(aln, batch, rows,
                                      aln._tier_configs(2)[:3])
        r["script_config"] = breakdown(aln, batch, rows,
                                       script_configs(aln))
    return r


def run(mbp: float = 64, n_reads: int = sb.BATCH, device: str = "cuda",
        profile: str | None = None, build_dir: Path = sb.BUILD) -> dict:
    sb.require_card(device, "diag_tier2")
    costs = {}
    g, idx = sb.load_cached(mbp, costs, profile, build_dir)
    aln = sb.make_aligner(idx, mbp, costs, device, profile, build_dir)
    return {"genome_mbp": mbp, **diag_tier2(aln, sb.se_batch(g, n_reads)),
            "costs": costs}


def report(r: dict) -> None:
    """The reference script's lines."""
    B = r["batch"]
    print(f"# tier1: ovf {r['tier1_overflow']}/{B} ({r['tier1_s']:.1f}s)")
    f, s = r["first"], r.get("steady")
    print(f"# tier2: ovf {r['after_tiers']}/{B} "
          f"({f['tier2_s'] + f['tier3_s']:.1f}s first; "
          f"{r['after_tier2']} after tier 2 alone)")
    if s:
        print(f"# tier2 steady: {s['tier2_s'] + s['tier3_s']:.2f}s (tier "
              f"2 {s['tier2_s']:.2f}s, tier 3 {s['tier3_s']:.2f}s)")
    for key, label in (("tier2_config", "big"),
                       ("script_config", "script's big")):
        if key in r:
            b = r[key]
            o = b["overflow"]
            print(f"# {label} smem ovf {o['seeding']}, n max "
                  f"{b['smems_max']}; seeds ovf {o['sa']}; chains ovf "
                  f"{o['chaining']}; extend ovf {o['extend']}, n max "
                  f"{b['regs_max']}")
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.diag_tier2",
        description="overflow after the big-caps tiers on the cached "
                    "scale world")
    ap.add_argument("genome_mbp", type=float, nargs="?", default=64)
    ap.add_argument("batch", type=int, nargs="?", default=sb.BATCH)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    r = run(a.genome_mbp, a.batch, a.platform)
    report(r)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
