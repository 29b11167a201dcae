"""Where an SE batch's host time goes after worker1: the counterpart of
``scripts/profile_finish.py``.

worker1 runs once on one batch of 4096 bench reads (``tools/bench_world.
py``, seed 7), on the aligner's device: the card, where the reference
forces the CPU, so its numbers are the card's. Then, each as the best of
a few runs: ``Aligner._unpack_host`` (5); the big-caps tiers when tier 1
overflowed (2), which is ``Aligner._tiers`` (tier 2 then tier 3, the
reference's ``_tier2``; it also counts ``stats``); the native finish of
the whole batch on one thread (``_finish_chunk``, 3) and on two
(``_finish_oracles(2)``, one chunk a thread, 3), whose SAMs must be
equal, or the tool raises as the reference asserts; and
``_finish_se_buf``, everything after worker1 (3).

Usage: python -m tpubwa_torch.tools.profile_finish [n]
           [--platform cuda|cpu]
Runs on the card and raises without one unless ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import sys
import time

import numpy as np


def best(fn, reps: int = 5):
    """(best seconds, last result) of reps calls."""
    t = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        r = fn()
        t = min(t, time.perf_counter() - t0)
    return t, r


def finish_k(aln, batch, n, ovf, l_rep, flat, offs_all, k: int) -> str:
    """The native finish over k contiguous chunks, one thread and native
    handle a chunk, joined in order: the body of
    ``Aligner._finish_threaded`` with k given, as the reference script
    copies it, so that k does not depend on the host's cores."""
    oracles = aln._finish_oracles(k)
    bounds = [round(batch.n * i / k) for i in range(k + 1)]
    with cf.ThreadPoolExecutor(max_workers=k) as ex:
        futs = [ex.submit(aln._finish_chunk, batch, n, ovf, l_rep, flat,
                          offs_all, bounds[i], bounds[i + 1], 0, oracles[i])
                for i in range(k)]
        return "".join(f.result() for f in futs)


def profile_finish(aln, batch) -> dict:
    """The host finish of ``batch`` by component (ms), and the 1- and
    2-thread finish SAMs (equal, or AssertionError)."""
    from .scale_bench import sync
    out = {"batch": batch.n, "device": aln.device.type}
    sync(aln)
    t0 = time.perf_counter()
    buf = aln.worker1_packed(batch.seqs, batch.lens).cpu().numpy()
    out["worker1_first_s"] = time.perf_counter() - t0

    dt, (ne, ovf, l_rep, flat) = best(lambda: aln._unpack_host(buf,
                                                               batch.n))
    out.update(unpack_ms=dt * 1e3, regs=len(flat), ovf=int(ovf.sum()))
    if ovf.any():
        dt, _ = best(lambda: aln._tiers(batch, ne.copy(), ovf.copy(),
                                        l_rep.copy(), flat.copy()), reps=2)
        out["tiers_ms"] = dt * 1e3

    n2, ovf2, lrep2, flat2 = aln._unpack_host(buf, batch.n)
    if ovf2.any():
        n2, ovf2, lrep2, flat2 = aln._tiers(batch, n2, ovf2, lrep2, flat2)
    offs_all = np.concatenate([[0], np.cumsum(n2)])
    regs = (n2, ovf2, lrep2, flat2, offs_all)
    dt, sam1 = best(lambda: aln._finish_chunk(batch, *regs, 0, batch.n, 0,
                                              aln.oracle), reps=3)
    out["finish_1t_ms"] = dt * 1e3
    dt, sam2 = best(lambda: finish_k(aln, batch, *regs, 2), reps=3)
    out["finish_2t_ms"] = dt * 1e3
    if sam2 != sam1:
        raise AssertionError("the 2-thread finish SAM differs from the "
                             "1-thread one")
    dt, _ = best(lambda: aln._finish_se_buf(batch, buf, 0), reps=3)
    out["finish_se_buf_ms"] = dt * 1e3
    out["sam_1t"], out["sam_2t"] = sam1, sam2
    return out


def report(r: dict) -> None:
    """The reference script's lines."""
    n = r["batch"]
    print(f"worker1 ({r['device']} device, first call): "
          f"{r['worker1_first_s']:.1f}s")
    print(f"_unpack_host:        {r['unpack_ms']:8.1f} ms  "
          f"(regs={r['regs']}, ovf={r['ovf']})")
    if "tiers_ms" in r:
        print(f"_tier2:              {r['tiers_ms']:8.1f} ms")
    for k in (1, 2):
        ms = r[f"finish_{k}t_ms"]
        print(f"native finish ({k}t):  {ms:8.1f} ms  "
              f"({n / (ms / 1e3):,.0f} reads/s)")
    print(f"_finish_se_buf:      {r['finish_se_buf_ms']:8.1f} ms   "
          "(everything)", flush=True)


def main(argv=None) -> int:
    from . import bench_world
    from .scale_bench import require_card
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.profile_finish",
        description="the SE host finish by component on one 4.6 Mbp bench "
                    "batch")
    ap.add_argument("n", type=int, nargs="?", default=bench_world.BATCH)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    require_card(a.platform, "profile_finish")
    aln = bench_world.make_aligner(a.platform)
    r = profile_finish(aln, bench_world.reads(aln.idx, a.n))
    report(r)
    print(json.dumps({k: v for k, v in r.items()
                      if k not in ("sam_1t", "sam_2t")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
