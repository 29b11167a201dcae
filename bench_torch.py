"""Throughput harness of tpubwa_torch on one CUDA card: the counterpart of
bench.py (BASELINE configs 1 and 2).

Prints ONE JSON line with bench.py's keys ("metric", "value", "unit",
"vs_baseline", "workload", "fallback_pct", "phase_s_per_batch",
"device_busy_pct", "pe_150bp_reads_per_s", "pe_fallback_pct", "setup_s")
and "card", the card's name and power limit as nvidia-smi prints them
("cpu" on the host). On standard error: the set-up and timed seconds, and
the kernels' launches in the timed runs.

Workload, as bench.py's: the repeat-rich 4.6 Mbp BACTERIAL-profile genome
of tpubwa_torch/tools/bench_world.py (index and LUT cached under
build/tpubwa_torch/), SE 100 bp reads with 1% substitutions and 0.1%
indels (seed 7) in batches of TPUBWA_BENCH_BATCH (4096): one warm-up batch,
then TPUBWA_BENCH_TIMED (8) batches streamed through align_se_stream; then
PE 150 bp (inserts 400 +- 50, seed 11) in batches of 2048 pairs: one
warm-up batch and 5 streamed through align_pe_stream.

What the keys mean on the card:
- value: SE reads/s over the timed batches, host finish included;
  vs_baseline: that over 250,000 reads/s (a 32-core CPU bwa-mem node).
- phase_s_per_batch: one batch, not overlapped. "device" is the wall time
  of worker1_packed up to a synchronize. worker1 on the card is host-driven
  loops with a sync in each step, so this is worker1's wall time, not the
  card's busy time. "transfer" copies the packed buffer to the host,
  "host_finish" is _finish_se_buf (the big-caps tiers and the native
  finish).
- device_busy_pct: min(100, 100 * device / (timed wall / timed batches)),
  bench.py's formula: worker1's wall share of a streamed batch. The card's
  own busy share, from a profiler trace, is far lower (chip_smoke.py
  phase 4).
- fallback_pct / pe_fallback_pct: reads the host oracle realigned (SE) or
  whose regions came from the oracle (PE), in the timed runs.

Usage: python3 bench_torch.py [--platform cuda|cpu]
Runs on the card and raises without one unless --platform cpu.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from tpubwa_torch.tools import bench_world  # noqa: E402

BASELINE_READS_PER_S = 250_000.0
PE_READ_LEN = 150
PE_BATCH = 2048            # pairs


def knobs() -> tuple:
    """(reads a batch, timed batches) from bench.py's two variables."""
    return (int(os.environ.get("TPUBWA_BENCH_BATCH", 4096)),
            int(os.environ.get("TPUBWA_BENCH_TIMED", 8)))


def check_lines(sams: list, n: int, what: str) -> None:
    """Raise unless the SAM texts hold a line for each of the n reads."""
    got = sum(s.count("\n") for s in sams)
    if got < n:
        raise AssertionError(f"{what}: {got} SAM lines for {n} reads")


def run(device: str = "cuda", build_dir: Path = bench_world.BUILD,
        genome_len: int = bench_world.GENOME_LEN,
        pe_batch: int = PE_BATCH) -> dict:
    """bench.py's run on ``device``; returns the JSON line's dict."""
    import numpy as np
    from tpubwa_torch.io import fastx
    from tpubwa_torch.ops import sw, sw_local
    from tpubwa_torch.tools.scale_bench import card_line, require_card, sync
    require_card(device, "bench_torch")
    batch_n, timed = knobs()
    n_reads = batch_n * (timed + 1)

    t0 = time.perf_counter()
    aln = bench_world.make_aligner(device, build_dir, genome_len)
    fwd = aln.idx.get_seq(0, aln.idx.l_pac).astype(np.uint8)
    recs = fastx.simulate_reads(fwd, n_reads, read_len=bench_world.READ_LEN,
                                error_rate=bench_world.ERROR_RATE,
                                indel_rate=bench_world.INDEL_RATE,
                                seed=bench_world.READS_SEED)
    batches = [fastx.batch_reads(recs[i:i + batch_n],
                                 max_len=bench_world.READ_LEN)
               for i in range(0, n_reads, batch_n)]
    aln.align_se(batches[0], id0=0)             # warm-up
    sync(aln)
    t1 = time.perf_counter()

    # ---- timed, pipelined run
    aln.stats = {"reads": 0, "fallback_reads": 0}
    sw.ksw_extend.launches = 0
    n = sum(b.n for b in batches[1:])
    sams = list(aln.align_se_stream(batches[1:], id0=batches[0].n))
    sync(aln)
    dt = time.perf_counter() - t1
    k1_se = sw.ksw_extend.launches
    check_lines(sams, n, "SE")
    rps = n / dt
    fb_pct = 100.0 * aln.stats["fallback_reads"] / max(aln.stats["reads"], 1)

    # ---- phase split (one batch, not overlapped): worker1 to a
    # synchronize, the copy to the host, the host finish
    b = batches[1]
    seqs, lens = np.asarray(b.seqs), np.asarray(b.lens)
    td0 = time.perf_counter()
    dev = aln.worker1_packed(seqs, lens)
    sync(aln)
    t_dev = time.perf_counter() - td0
    tt0 = time.perf_counter()
    buf = dev.cpu().numpy()
    t_xfer = time.perf_counter() - tt0
    th0 = time.perf_counter()
    aln._finish_se_buf(b, buf, id0=0)
    t_host = time.perf_counter() - th0
    busy = min(100.0, 100.0 * t_dev / (dt / timed))

    # ---- paired-end throughput (BASELINE config 2: PE 150 bp). The count
    # is bench.py's, 2 * PE_BATCH * 3, and simulate_reads counts it in
    # pairs: 6 batches of PE_BATCH pairs, one warm-up and 5 timed. It sets
    # the timed window, as in bench.py, not a number of pairs.
    pe_recs = fastx.simulate_reads(
        fwd, 2 * pe_batch * 3, read_len=PE_READ_LEN, paired=True,
        error_rate=0.01, indel_rate=0.001, seed=11, insert_mean=400,
        insert_std=50)
    pe_batches = [fastx.batch_reads(pe_recs[i:i + 2 * pe_batch],
                                    max_len=PE_READ_LEN)
                  for i in range(0, len(pe_recs), 2 * pe_batch)]
    aln.align_pe(pe_batches[0], id0=0)          # warm-up
    aln.stats = {"reads": 0, "fallback_reads": 0}
    sw.ksw_extend.launches = sw_local.ksw_local.launches = 0
    sync(aln)
    tp0 = time.perf_counter()
    pe_out = list(aln.align_pe_stream(pe_batches[1:], id0=pe_batch))
    sync(aln)
    pe_dt = time.perf_counter() - tp0
    k1_pe, k2_pe = sw.ksw_extend.launches, sw_local.ksw_local.launches
    pe_n = sum(b.n for b in pe_batches[1:])
    check_lines(pe_out, pe_n, "PE")
    pe_rps = pe_n / pe_dt
    pe_fb = 100.0 * aln.stats["fallback_reads"] / max(aln.stats["reads"], 1)

    card = card_line(aln.device)
    print(f"# setup {t1 - t0:.1f}s, timed {n} reads in {dt:.2f}s, "
          f"PE {pe_n} reads in {len(pe_batches) - 1} batches of "
          f"{pe_batch} pairs in {pe_dt:.2f}s, card={card}", file=sys.stderr)
    print(f"# kernel launches in the timed runs: SE ksw_extend {k1_se}; "
          f"PE ksw_extend {k1_pe}, ksw_local {k2_pe}", file=sys.stderr,
          flush=True)
    return {
        "metric": "se_100bp_reads_per_s_per_chip",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_S, 4),
        "workload": "repeat-rich 4.6Mbp, 1% sub + 0.1% indel errors",
        "fallback_pct": round(fb_pct, 3),
        "phase_s_per_batch": {"device": round(t_dev, 4),
                              "transfer": round(t_xfer, 4),
                              "host_finish": round(t_host, 4)},
        "device_busy_pct": round(busy, 1),
        "pe_150bp_reads_per_s": round(pe_rps, 1),
        "pe_fallback_pct": round(pe_fb, 3),
        "setup_s": round(t1 - t0, 1),
        "card": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="bench_torch.py",
        description="SE and PE alignment throughput on one card, as one "
                    "JSON line")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.platform)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
