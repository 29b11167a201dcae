"""Command-line interface — the analog of the reference's command-line
entry point [ref: BWAMEMSpark.scala :: main, commandline/]: ``index``
replaces the external ``bwa index`` dependency, ``align`` replaces the
``cs-bwamem`` subcommand (and ``upload-fastq`` is unnecessary: batches
stream from local FASTQ straight to the device), ``sort`` and ``merge``
post-process SAM.

    python -m tpubwa_torch index ref.fa -o ref.npz
    python -m tpubwa_torch align ref.npz reads.fq -o out.sam
    python -m tpubwa_torch align ref.npz r_1.fq r_2.fq -o pe.sam

bwa-compatible algorithm flags use bwa's letters (-k/-w/-d/-r/-c/-A/-B/-O/
-E/-L/-U/-T) [bwa: bwamem.c getopt loop]. ``--platform`` picks the device:
``cuda`` (default; fails without a card) or ``cpu`` (the plain PyTorch
versions of the kernels).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from . import __version__
from .opts import MemOptions


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpubwa_torch",
        description="BWA-MEM-class aligner on PyTorch and CUDA")
    p.add_argument("--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build an FM-index from FASTA")
    pi.add_argument("fasta")
    pi.add_argument("-o", "--output", required=True, help=".npz index path")
    pi.add_argument("--sa-intv", type=int, default=None,
                    help="SA sample interval (default: build_index's)")

    pa = sub.add_parser("align", help="align FASTQ reads, write SAM")
    pa.add_argument("index", help=".npz index from the index command")
    pa.add_argument("fastq", nargs="+",
                    help="FASTQ file(s); exactly two files = paired-end "
                         "mates (bwa-mem style `reads_1.fq reads_2.fq`) "
                         "unless --se/--multihost is given")
    pa.add_argument("-o", "--output", default="-", help="SAM path (- stdout)")
    pa.add_argument("-p", "--paired", action="store_true",
                    help="interleaved paired-end input")
    pa.add_argument("--se", action="store_true",
                    help="force single-end even with two input files")
    pa.add_argument("--batch-size", type=int, default=4096)
    pa.add_argument("--oracle", action="store_true",
                    help="use the scalar host oracle instead of the device")
    pa.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="device to align on (default cuda: the CUDA "
                         "kernels; cpu: their plain PyTorch versions)")
    pa.add_argument("-R", "--read-group", default="",
                    help="read group id (emitted as @RG / RG:Z)")
    # bwa-compatible algorithm flags
    pa.add_argument("-k", type=int, default=19, help="min seed length")
    pa.add_argument("-w", type=int, default=100, help="band width")
    pa.add_argument("-d", type=int, default=100, help="z-dropoff")
    pa.add_argument("-r", type=float, default=1.5, help="reseed split factor")
    pa.add_argument("-c", type=int, default=500, help="max seed occurrences")
    pa.add_argument("-A", type=int, default=1, help="match score")
    pa.add_argument("-B", type=int, default=4, help="mismatch penalty")
    pa.add_argument("-O", type=int, default=6, help="gap open penalty")
    pa.add_argument("-E", type=int, default=1, help="gap extend penalty")
    pa.add_argument("-L", type=int, default=5, help="clipping penalty")
    pa.add_argument("-U", type=int, default=17, help="unpaired penalty")
    pa.add_argument("-T", type=int, default=30, help="min output score")
    pa.add_argument("--shard-dir", default=None,
                    help="write per-batch SAM shards + resume manifest here "
                         "instead of one file; re-running skips completed "
                         "batches")
    pa.add_argument("--multihost", action="store_true",
                    help="multi-host run over a TCP key-value store (env: "
                         "MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, "
                         "as torchrun sets them; LOCAL_RANK picks the "
                         "card): input FASTQ files are split round-robin "
                         "per host, output goes to a per-host shard (merge "
                         "with the merge command). PE runs agree on a "
                         "global batch count first (the insert-size "
                         "histogram is summed across hosts every batch)")
    pa.add_argument("--id0", type=int, default=0,
                    help="starting global read index (deterministic "
                         "tie-break ids for sharded multi-host runs)")

    ps = sub.add_parser("sort", help="coordinate-sort a SAM file")
    ps.add_argument("sam")
    ps.add_argument("-o", "--output", required=True)

    pm = sub.add_parser("merge", help="merge SAM shards (optionally sort)")
    pm.add_argument("shards", nargs="+")
    pm.add_argument("-o", "--output", required=True)
    pm.add_argument("--sort", action="store_true")
    return p


def opts_from_args(a) -> MemOptions:
    return MemOptions(
        min_seed_len=a.k, w=a.w, zdrop=a.d, split_factor=a.r, max_occ=a.c,
        a=a.A, b=a.B, o_del=a.O, o_ins=a.O, e_del=a.E, e_ins=a.E,
        pen_clip5=a.L, pen_clip3=a.L, pen_unpaired=a.U, T=a.T)


def cmd_index(a) -> int:
    from .index.builder import DEFAULT_SA_INTV, build_index
    from .io.fastx import read_fasta
    t0 = time.time()
    seqs = read_fasta(a.fasta)
    if not seqs:
        print(f"error: no sequences in {a.fasta}", file=sys.stderr)
        return 1
    idx = build_index(seqs, sa_intv=a.sa_intv or DEFAULT_SA_INTV)
    idx.save(a.output)
    total = sum(s.length for s in idx.anns)
    print(f"[tpubwa_torch index] {len(idx.anns)} sequence(s), {total} bp, "
          f"{time.time() - t0:.1f}s -> {a.output}", file=sys.stderr)
    return 0


def _device(a) -> str:
    """The Aligner's device: --platform, and with --multihost on a card the
    card LOCAL_RANK names (several processes may share one card)."""
    if a.platform == "cuda" and a.multihost and os.environ.get("LOCAL_RANK"):
        return f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return a.platform


def cmd_align(a) -> int:
    from .index.builder import FMIndex
    from .io.fastx import batch_reads, iter_fastq
    from .pipeline import Aligner

    # bwa-mem style two-file paired mode: `align idx r1.fq r2.fq`
    # (multihost shards whole FILES round-robin per host, which is
    # incompatible with mate zipping — use interleaved -p there)
    pe2 = (not a.paired and not a.se and not a.multihost
           and len(a.fastq) == 2)
    if pe2:
        a.paired = True
        print("[tpubwa_torch align] two input files: paired-end mate mode "
              "(use --se to force single-end)", file=sys.stderr)

    opt = opts_from_args(a)
    if a.paired:
        opt = opt.replace(flag=opt.flag | MemOptions.F_PE)

    if a.multihost:
        from .dist import multihost
        pid, nproc = multihost.initialize()
        a.fastq = [str(p) for p in
                   multihost.host_shard_of(a.fastq, pid, nproc)]
        if a.output != "-":
            a.output = str(multihost.shard_output_path(a.output, pid))
        print(f"[tpubwa_torch align] multihost process {pid}/{nproc}: "
              f"{len(a.fastq)} input file(s) -> {a.output}",
              file=sys.stderr)

    idx = FMIndex.load(a.index)
    # k-mer LUT cache: default next to the index (one LUT per index), or
    # an explicit TPUBWA_LUT_CACHE path
    lut_cache = os.environ.get("TPUBWA_LUT_CACHE") or \
        (a.index + ".lut_k.npz")
    aln = Aligner(idx, opt, rg_id=a.read_group, lut_cache=lut_cache,
                  device=_device(a))

    manifest = None
    shard_dir = None
    if a.shard_dir:
        from pathlib import Path

        from .io.sam import Manifest
        shard_dir = Path(a.shard_dir)
        shard_dir.mkdir(parents=True, exist_ok=True)
        manifest = Manifest(shard_dir / "manifest.jsonl")
        (shard_dir / "header.sam").write_text(aln.sam_header())
        out = None
    else:
        out = sys.stdout if a.output == "-" else open(a.output, "w")

    # flush granularity: a batch closes at the first record count
    # >= batch_size that is even for PE (pairs stay in one batch)
    flush_at = a.batch_size + (a.batch_size % 2 if a.paired else 0)

    if a.multihost and a.paired and not a.oracle:
        # agree on the global PE reduce-round count up front so uneven
        # per-host inputs can't deadlock the histogram sum: count this
        # host's records (cheap parse-only pass), derive its batch count
        from .dist import multihost
        n_recs = sum(1 for p in a.fastq for _ in iter_fastq(p))
        n_batches = -(-n_recs // flush_at) if n_recs else 0
        total = multihost.pe_plan(n_batches, opt.max_ins)
        print(f"[tpubwa_torch align] multihost PE plan: {n_batches} local / "
              f"{total} global reduce rounds", file=sys.stderr)

    t0 = time.time()
    n_done = 0
    batch_no = 0
    try:
        if out is not None:
            out.write(aln.sam_header())

        def rec_iter():
            if pe2:
                from itertools import zip_longest
                it = zip_longest(iter_fastq(a.fastq[0]),
                                 iter_fastq(a.fastq[1]))
                for i, (r1, r2) in enumerate(it):
                    if r1 is None or r2 is None:
                        raise SystemExit(
                            f"error: mate files differ in length "
                            f"(record {i})")
                    yield r1
                    yield r2
            else:
                for path in a.fastq:
                    yield from iter_fastq(path)

        def batch_iter():
            pend = []
            for rec in rec_iter():
                pend.append(rec)
                if len(pend) >= flush_at:
                    yield batch_reads(pend)
                    pend = []
            if pend:
                yield batch_reads(pend)

        # fast path: device alignment — stream batches through the
        # pipelined aligner (the device computes batch i+1 while the host
        # finishes batch i); SE and PE both pipeline. Covers both the
        # plain-output and the resumable --shard-dir flows (multihost PE
        # keeps the lockstep batch loop below so skipped batches hold the
        # global histogram reduce sequence in order).
        if not a.oracle and not (manifest is not None and a.multihost
                                 and a.paired):
            from collections import deque
            fed: deque = deque()

            def feeder():
                no = 0
                idc = a.id0
                for batch in batch_iter():
                    i0 = idc // 2 if a.paired else idc
                    if manifest is None or not manifest.is_done(no):
                        fed.append((no, batch.n))
                        yield (batch, i0)
                    idc += batch.n
                    no += 1

            stream = (aln.align_pe_stream(feeder())
                      if a.paired else aln.align_se_stream(feeder()))
            t_b = time.time()
            for sam in stream:
                no, cnt = fed.popleft()
                if manifest is not None:
                    shard = shard_dir / f"shard_{no:06d}.sam"
                    shard.write_text(sam)
                    manifest.mark(no, cnt, str(shard))
                    dt_b = time.time() - t_b
                    print(f"[tpubwa_torch align] batch {no}: {cnt} reads in "
                          f"{dt_b:.2f}s ({cnt / max(dt_b, 1e-9):.0f} "
                          f"reads/s)", file=sys.stderr)
                    t_b = time.time()
                else:
                    out.write(sam)
                n_done += sam.count("\n")
                batch_no += 1
            dt = time.time() - t0
            print(f"[tpubwa_torch align] total {n_done} records in "
                  f"{dt:.1f}s ({n_done / max(dt, 1e-9):.0f} reads/s)",
                  file=sys.stderr)
            if out is not None and out is not sys.stdout:
                out.close()
            _launches(aln)
            _mh_done(a)
            return 0

        pending = []

        def run_batch(batch, id0):
            id0 += a.id0
            if a.paired:
                if a.oracle:
                    sam, _ = aln.oracle.align_pe(batch, opt, id0=id0 // 2,
                                                 rg_id=a.read_group)
                else:
                    sam = aln.align_pe(batch, id0=id0 // 2)
                return sam
            if a.oracle:
                return aln.oracle.align_se(batch, opt, id0=id0,
                                           rg_id=a.read_group)
            return aln.align_se(batch, id0=id0)

        def flush():
            nonlocal n_done, batch_no
            if not pending:
                return
            tb = time.time()
            if manifest is not None and manifest.is_done(batch_no):
                if a.multihost and a.paired and not a.oracle:
                    # keep the global histogram reduce sequence aligned
                    # when resume skips different batch counts per host
                    from .dist.multihost import hist_skip
                    hist_skip()
                n_done += len(pending)
                batch_no += 1
                pending.clear()
                return
            batch = batch_reads(pending)
            sam = run_batch(batch, n_done)
            if manifest is not None:
                shard = shard_dir / f"shard_{batch_no:06d}.sam"
                shard.write_text(sam)
                manifest.mark(batch_no, len(pending), str(shard))
            else:
                out.write(sam)
            dt = time.time() - tb
            print(f"[tpubwa_torch align] batch {batch_no}: {len(pending)} "
                  f"reads in {dt:.2f}s ({len(pending) / max(dt, 1e-9):.0f} "
                  f"reads/s)", file=sys.stderr)
            n_done += len(pending)
            batch_no += 1
            pending.clear()

        for rec in rec_iter():
            pending.append(rec)
            if len(pending) >= a.batch_size and \
                    (not a.paired or len(pending) % 2 == 0):
                flush()
        flush()
    finally:
        if out is not None and out is not sys.stdout:
            out.close()
    dt = time.time() - t0
    print(f"[tpubwa_torch align] total {n_done} reads in {dt:.1f}s "
          f"({n_done / max(dt, 1e-9):.0f} reads/s)", file=sys.stderr)
    _launches(aln)
    _mh_done(a)
    return 0


def _launches(aln) -> None:
    """On a card, report how often the run launched each CUDA kernel."""
    if aln.device.type != "cuda":
        return
    from .ops.sw import ksw_extend
    from .ops.sw_local import ksw_local
    print(f"[tpubwa_torch align] kernel launches: ksw_extend "
          f"{ksw_extend.launches}, ksw_local {ksw_local.launches}",
          file=sys.stderr)


def _mh_done(a) -> None:
    """Hold multihost processes at a barrier before exit so hosts with
    uneven batch/build times leave together. PE runs first drain any
    remaining global histogram reduce rounds (hosts with fewer batches
    contribute zeros — see multihost.pe_plan)."""
    if getattr(a, "multihost", False):
        from .dist.multihost import barrier, pe_drain
        pe_drain()
        barrier("align_done")


def cmd_sort(a) -> int:
    from pathlib import Path

    from .io.sam import coordinate_sort
    Path(a.output).write_text(coordinate_sort(Path(a.sam).read_text()))
    return 0


def cmd_merge(a) -> int:
    from .io.sam import merge_shards
    n = merge_shards(a.shards, a.output, sort=a.sort)
    print(f"[tpubwa_torch merge] {len(a.shards)} shards, {n} records -> "
          f"{a.output}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if a.cmd == "index":
        return cmd_index(a)
    if a.cmd == "align":
        return cmd_align(a)
    if a.cmd == "sort":
        return cmd_sort(a)
    if a.cmd == "merge":
        return cmd_merge(a)
    return 2


if __name__ == "__main__":
    sys.exit(main())
