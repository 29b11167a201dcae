"""Kill-and-resume rehearsal of a long paired-end run through the command
line (BASELINE config 4): the counterpart of ``scripts/run_1m.py``.

Steps:
  1. write two-file FASTQ (``pairs`` pairs of 150 bp, inserts 400 +- 50,
     1% substitutions, 0.1% indels) from the scale genome's cache
     (``tools/scale_bench.py``), in chunks of 50,000 pairs simulated with
     seed 1000 + the pairs done, names ``p{i}_...`` (kept when a file of
     that many pairs is already there);
  2. ``python -m tpubwa_torch align idx r_1.fq r_2.fq --batch-size B
     --shard-dir ... --platform P`` with ``TPUBWA_LUT_CACHE`` set, SIGKILLed
     (no clean-up: a preempted host) once ``kill_after`` seconds have
     passed and at least 2 ``batch N:`` lines have appeared;
  3. the same command again: the manifest skips the finished batches;
  4. the shards merged (header first) into ``merged.sam`` and counted;
     ``RUN_1M.json`` written.
Everything lives in ``build/tpubwa_torch/run1m_<mbp>/``; the shards of an
earlier run there are removed first, so that every run rehearses.

Usage: python -m tpubwa_torch.tools.run_1m [pairs] [kill_after_s]
           [genome_mbp] [--batch-size N] [--platform cuda|cpu]
The world must be prepared (``python -m tpubwa_torch.tools.scale_bench
4096 <genome_mbp> --prepare``). The run needs a CUDA card and raises
without one unless ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from .scale_bench import BUILD, REPO

CHUNK = 50_000
BATCH_LINE = re.compile(r"batch (\d+):")


def gen_fastq(g, pairs: int, r1: Path, r2: Path) -> float:
    """Write the mate files; seconds taken (0 when they were there)."""
    from ..io import fastx
    if r1.exists() and r2.exists():
        with open(r1) as f:
            if sum(1 for _ in f) == 4 * pairs:
                return 0.0
    t0 = time.time()
    g = np.asarray(g)
    with open(r1, "w") as f1, open(r2, "w") as f2:
        done = 0
        while done < pairs:
            n = min(CHUNK, pairs - done)
            # n pairs: simulate_reads counts pairs when paired (the
            # reference script passes 2 * n and so writes twice the pairs)
            recs = fastx.simulate_reads(
                g, n, read_len=150, paired=True, error_rate=0.01,
                indel_rate=0.001, seed=1000 + done, insert_mean=400,
                insert_std=50)
            for i, r in enumerate(recs):
                # unique names across chunks
                name = f"p{done + i // 2}_{r.name}"
                q = r.qual or "I" * len(r.seq)
                (f1 if i % 2 == 0 else f2).write(f"@{name}\n{r.seq}\n+\n{q}\n")
            done += n
            print(f"  fastq {done}/{pairs} pairs", file=sys.stderr,
                  flush=True)
    return time.time() - t0


def run_1m(pairs: int = 1_000_000, kill_after: float = 600.0,
           mbp: float = 3100, batch_size: int = 4096,
           platform: str = "cuda", build_dir: Path = BUILD) -> dict:
    """The rehearsal; returns RUN_1M.json's keys and ``work`` (the
    directory)."""
    from ..io.sam import merge_shards
    from . import scale_bench as sb
    sb.require_card(platform, "run_1m")
    glen = int(round(mbp * 1_000_000))
    idx_path, _, lut_path = sb.cache_paths(glen, sb.default_profile(mbp),
                                           build_dir)
    if not idx_path.exists():
        raise FileNotFoundError(
            f"{idx_path} is missing: prepare the {mbp:g} Mbp world with "
            f"python -m tpubwa_torch.tools.scale_bench {sb.BATCH} {mbp:g} "
            "--prepare")
    g = sb.get_genome(mbp, {}, build_dir=build_dir)
    work = Path(build_dir) / f"run1m_{mbp:g}"
    work.mkdir(parents=True, exist_ok=True)
    r1, r2 = work / "r_1.fq", work / "r_2.fq"
    out = {"pairs": pairs, "genome_mbp": mbp, "batch_size": batch_size,
           "platform": platform}
    out["fastq_gen_s"] = gen_fastq(g, pairs, r1, r2)

    sd = work / "shards"
    shutil.rmtree(sd, ignore_errors=True)
    cmd = [sys.executable, "-m", "tpubwa_torch", "align", str(idx_path),
           str(r1), str(r2), "--batch-size", str(batch_size), "--shard-dir",
           str(sd), "--platform", platform]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)),
        TPUBWA_LUT_CACHE=str(lut_path))

    # ---- phase 1: run with a hard kill partway ----
    t0 = time.time()
    p = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                         stderr=subprocess.PIPE, text=True)
    killed = False
    batches_before = 0
    with p.stderr:
        for line in p.stderr:
            sys.stderr.write(line)
            batches_before += bool(BATCH_LINE.search(line))
            if time.time() - t0 > kill_after and batches_before >= 2:
                p.send_signal(signal.SIGKILL)
                killed = True
                break
    p.wait()
    out["phase1_s"] = time.time() - t0
    out["phase1_rc"] = p.returncode
    out["phase1_killed"] = killed
    out["phase1_batches"] = batches_before

    # ---- phase 2: resume ----
    t0 = time.time()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True)
    out["phase2_s"] = time.time() - t0
    out["phase2_rc"] = r.returncode
    if r.returncode:
        sys.stderr.write(r.stderr[-3000:])
    m = BATCH_LINE.findall(r.stderr)
    out["phase2_first_batch"] = int(m[0]) if m else None
    out["phase2_batches"] = len(m)
    out["resume_skipped_done"] = (out["phase2_first_batch"] or 0) > 0 \
        if killed else None
    mt = re.search(r"total (\d+) records in ([0-9.]+)s", r.stderr)
    if mt:
        out["phase2_records"] = int(mt.group(1))
        out["phase2_reads_per_s"] = int(mt.group(1)) / \
            max(float(mt.group(2)), 1e-9)

    # ---- merge + count ----
    shards = sorted(sd.glob("shard_*.sam"))
    out["n_shards"] = len(shards)
    merged = work / "merged.sam"
    out["total_records"] = merge_shards([sd / "header.sam", *shards],
                                        merged) if shards else 0
    out["records_ok"] = out["total_records"] == 2 * pairs
    out["total_wall_s"] = out["phase1_s"] + out["phase2_s"]
    out["reads_per_s_overall"] = 2 * pairs / out["total_wall_s"]
    (work / "RUN_1M.json").write_text(json.dumps(out, indent=1) + "\n")
    out["work"] = str(work)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.run_1m",
        description="PE kill-and-resume rehearsal through the command line")
    ap.add_argument("pairs", type=int, nargs="?", default=1_000_000)
    ap.add_argument("kill_after_s", type=float, nargs="?", default=600.0)
    ap.add_argument("genome_mbp", type=float, nargs="?", default=3100)
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    out = run_1m(a.pairs, a.kill_after_s, a.genome_mbp, a.batch_size,
                 a.platform)
    print(json.dumps(out), flush=True)
    ok = out["phase1_killed"] and out["resume_skipped_done"] and \
        out["records_ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
