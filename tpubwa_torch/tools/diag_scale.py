"""Tier-1 overflow by stage at genome scale: which device cap sends reads to
the big-caps tiers? The counterpart of ``scripts/diag_scale.py``.

One batch of SE 100 bp reads (seed 3) of the cached scale world
(``tools/scale_bench.py``: genome, index and LUT of ``genome_mbp`` Mbp)
goes through worker1's stages one by one (``tools/diag_caps.py::
stage_flags``), then twice through ``Aligner.worker1_packed``, whose
overflow is read through ``Aligner._unpack_host``. Packing can only add
overflow (a read whose fields exceed the packed bit budgets is flagged),
so ``stage_not_packed`` (reads the stages flag and the buffer does not)
must be 0.

Usage: python -m tpubwa_torch.tools.diag_scale [genome_mbp] [batch]
           [--platform cuda|cpu]
The world must have been prepared (``python -m tpubwa_torch.tools.
scale_bench 4096 <genome_mbp> --prepare``); the default is 64 Mbp, the
size a chip call can build. Runs on the card and raises without one
unless ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import scale_bench as sb
from .diag_caps import cumulative, stage_flags


def diag_scale(aln, batch) -> dict:
    """Per-stage overflow, SMEM and region counts of ``batch`` under the
    aligner's tier-1 configs, and the packed buffer's overflow with the
    time of a first and a steady ``worker1_packed`` call."""
    t0 = time.perf_counter()
    flags = stage_flags(aln, batch.seqs, batch.lens)
    stages_s = time.perf_counter() - t0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        buf = aln.worker1_packed(batch.seqs, batch.lens).cpu().numpy()
        times.append(time.perf_counter() - t0)
    packed = aln._unpack_host(buf, batch.n)[1]
    r = {"batch": batch.n, **cumulative(flags)}
    r["overflow"]["packed"] = int(packed.sum())
    r.update(smems_mean=float(flags["n_smems"].mean()),
             smems_max=int(flags["n_smems"].max()),
             regs_mean=float(flags["n_regs"].mean()),
             stage_not_packed=int((flags["extend"] & ~packed).sum()),
             stages_s=stages_s, first_s=times[0], steady_s=times[1],
             device=aln.device.type)
    return r


def run(mbp: float = 64, n_reads: int = sb.BATCH, device: str = "cuda",
        profile: str | None = None, build_dir: Path = sb.BUILD) -> dict:
    sb.require_card(device, "diag_scale")
    costs = {}
    g, idx = sb.load_cached(mbp, costs, profile, build_dir)
    aln = sb.make_aligner(idx, mbp, costs, device, profile, build_dir)
    return {"genome_mbp": mbp, **diag_scale(aln, sb.se_batch(g, n_reads)),
            "costs": costs}


def report(r: dict) -> None:
    """The reference script's lines."""
    o, B = r["overflow"], r["batch"]
    print(f"# smem stage {r['stages_s']:.2f}s (all stages): overflow "
          f"{o['seeding']}/{B}, n mean {r['smems_mean']:.1f} max "
          f"{r['smems_max']}")
    print(f"# seeds: overflow {o['sa']}/{B}")
    print(f"# chains: overflow {o['chaining']}/{B}")
    print(f"# extend: overflow {o['extend']}/{B}, regs mean "
          f"{r['regs_mean']:.2f}")
    print(f"# packed: overflow {o['packed']}/{B} (first {r['first_s']:.1f}s,"
          f" steady {r['steady_s']:.2f}s)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.diag_scale",
        description="tier-1 overflow by stage on the cached scale world")
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
