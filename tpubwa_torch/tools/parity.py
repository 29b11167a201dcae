"""SAM parity of the device path against the scalar oracle, on the card:
the counterpart of ``scripts/tpu_parity.py``.

The CPU tests hold the port to the reference and the oracle at small
sizes; a card can still differ (a kernel, an index width, a device-only
path), so this drives the production device path on the card and holds
every SAM record to ``Oracle.align_se``: 2048 SE reads of 100 bp with 2%
substitutions and 0.2% indels (seed 3) from the 4.6 Mbp bench genome
(``tools/bench_world.py``), aligned by ``Aligner.align_se``. Every line
must be byte-equal; otherwise the first 5 differing pairs are printed
and the tool exits non-zero. Run it after any change to the device path.

Usage: python -m tpubwa_torch.tools.parity [n_reads] [--platform cuda|cpu]
Runs on the card and raises without one unless ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def parity(aln, n_reads: int = 2048, error_rate: float = 0.02,
           indel_rate: float = 0.002, seed: int = 3) -> dict:
    """Align the reads on the aligner's device and with the oracle; the
    record count, the differing records' count and the first 5 pairs."""
    from ..io import fastx
    fwd = aln.idx.get_seq(0, aln.idx.l_pac).astype(np.uint8)
    recs = fastx.simulate_reads(fwd, n_reads, read_len=100,
                                error_rate=error_rate,
                                indel_rate=indel_rate, seed=seed)
    batch = fastx.batch_reads(recs, max_len=100)
    dev = aln.align_se(batch, id0=0).rstrip("\n").split("\n")
    orc = aln.oracle.align_se(batch, aln.opt, id0=0, rg_id="") \
        .rstrip("\n").split("\n")
    if len(dev) != len(orc):
        raise AssertionError(f"{len(dev)} device records against "
                             f"{len(orc)} of the oracle")
    bad = [i for i, (a, b) in enumerate(zip(dev, orc)) if a != b]
    return {"records": len(dev), "differ": len(bad),
            "first": [(dev[i], orc[i]) for i in bad[:5]],
            "device": aln.device.type}


def report(r: dict) -> int:
    """The reference script's lines; returns the exit code."""
    for d, o in r["first"]:
        print("DEV:", d)
        print("ORC:", o)
    if r["differ"]:
        print(f"FAIL: {r['differ']}/{r['records']} records differ",
              flush=True)
        return 1
    print(f"parity on {r['device']}: PASS ({r['records']} SAM records "
          "identical)", flush=True)
    return 0


def main(argv=None) -> int:
    from . import bench_world
    from .scale_bench import require_card
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.parity",
        description="device-path SAM parity against the scalar oracle")
    ap.add_argument("n_reads", type=int, nargs="?", default=2048)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    require_card(a.platform, "parity")
    r = parity(bench_world.make_aligner(a.platform), a.n_reads)
    rc = report(r)
    print(json.dumps({k: v for k, v in r.items() if k != "first"}),
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
