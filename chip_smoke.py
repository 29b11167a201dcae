#!/usr/bin/env python3
"""Smoke run of tpubwa_torch on one CUDA card (an H100 for this port).

Phases (each raises on failure; nothing is caught and turned into exit 0):
  1. build   — the banded-extension kernel K1 (tpubwa_torch/csrc/
               ksw_extend.cu), the local-alignment kernel K2 (csrc/
               ksw_local.cu), both nvcc for sm_90a (and each again without
               DPX instructions, for phase 2's row latency), and the native
               oracle (native/*.cpp, g++), all from this checkout, in
               parallel;
               prints what ptxas says of every template instance
               (registers, spills);
  2. parity  — each kernel against its plain PyTorch version on the card,
               bit-equal (tolerance 0: integer scores and coordinates):
               K1 against ksw_extend_ref over the Q x T envelope, the
               production N shapes, the narrow band + z-drop case and the
               edge sweep (Q at every register-instance boundary and in
               the generic instance, N = 1 and 128, qlen = Q and qlen = 1,
               h0 at the packed key's limit, bands that go empty); K2
               against ksw_local_ref over the same shapes in both
               want_sub modes, with invalid and empty rows; per shape the
               kernel time, the plain time and the bound. Then
               ksw_align_batch (K2 forward + reverse pass) on the card
               against the scalar oracle's ksw_align, and the latency of
               one DP row of each kernel's register and generic instance
               (one task, two target lengths, the slope);
  3. e2e SE  — streamed single-end alignment (BASELINE config 1) of 100 bp
               reads with 1% substitutions and 0.1% indels against the
               4.6 Mbp bacterial-profile synthetic genome, through
               Aligner(..., device="cuda").align_se_stream: one warm-up
               batch, then 2 timed batches of 4096 reads whose SAM must be
               byte-equal to the scalar oracle's; the kernels' launch
               counts are reset just before the timed batches and read
               just after;
  4. stages  — one SE batch stage by stage (host clock around work that
               ends in a synchronize), with K1's launches per stage, and
               the device busy share of another batch from a profiler
               trace;
  5. e2e PE  — streamed paired-end alignment (BASELINE config 2) of 150 bp
               pairs, inserts 400 +- 50, same error rates, genome and
               index, through align_pe_stream: one warm-up batch, then 2
               timed batches of 2048 pairs whose SAM must be byte-equal
               to the oracle's align_pe, with no rescue window missing
               from the injected results and K2 launched at least twice
               per batch; then one PE batch stage by stage and the device
               busy share of another;
  6. kernels — K1 and K2 held against their plain versions (tolerance 0)
               and timed on the inputs of their first main-path calls,
               recorded during phases 3 and 5: K1's first call of the SE
               path and of the PE path, K2's first forward and first
               reverse call; each beside its plain version and its bound,
               printed as one {"kernels": [...]} line with one entry per
               kernel and path (K1) or template instance (K2), each with
               that path's own launch count; beside each the generic
               (shared-memory) instance's time on the same inputs.
  7. CLI SE  — the phase-3 timed reads (2 batches of 4096 x 100 bp) written
               to FASTQ and aligned by `python -m tpubwa_torch align ...
               --platform cuda` in a subprocess: the whole file byte-equal
               to Aligner.sam_header() + the oracle's align_se; the CLI's
               own "total ... reads/s" line and kernel launch counts;
  8. CLI PE  — 2 batches of 2048 pairs of 150 bp (inserts 400 +- 50; 1
               batch in the full call) as r_1.fq / r_2.fq through `align
               idx r_1.fq r_2.fq`: byte-equal to the header +
               Oracle.align_pe; K2 launched;
  9. shards  — an SE run with --shard-dir, then the same command again (it
               aligns no batch); merge of the shards equals phase 7's file;
               sort gives coordinate order; index on a FASTA of the first
               200 kbp equals build_index in this process, array for array;
 10. multihost — two processes of `align -p --multihost --batch-size 2048`
               on one card, joined by a TCP store (MASTER_ADDR, a free port,
               WORLD_SIZE=2, RANK=0/1), on uneven input (3 batches against
               1): host 0's shard equals a single-process run's batch over
               both hosts' round-0 reads (the histogram summed) followed by
               its two lone batches; host 1's shard the rest of that batch;
               the inserts are planted so that host 0's first batch aligns
               differently with its own histogram, else the phase fails;
 11. anchor  — one SE batch of 256 x 100 bp through Aligner(seed_impl=
               "anchor", device="cuda"), SAM byte-equal to the oracle, K1
               launched; on its reads collect_smems_anchor and
               collect_smems equal to Oracle.smems on every read that did
               not overflow; the anchor seed stage timed beside the LUT's.
 12. dist    — device-level distribution on the card(s): worker1_sharded
               on one SE batch (4096 x 100 bp, the phase-3 configs) over
               every card (make_mesh()) and over 4 logical shards on
               cuda:0, each twice (the second call copies no index), K1
               launched, all 13 outputs equal to worker1_step on the
               mesh's blocks and, on every read that overflows in neither
               run, to worker1_step on the whole batch (a dense budget is
               sized from a block's reads, so the split may move reads to
               overflow); a ShardedIndex of the index over 4 logical
               shards
               (and over every card when there are several): occ4_all,
               inv_psi and sa_lookup of 65,536 random ranks and the
               backward search of the batch's first 21-mers equal to the
               replicated DeviceIndex, a routed round timed against a
               replicated one; insert_size_psum equal to np.bincount.
 13. long    — long reads (BASELINE config 5) against the 4.6 Mbp index: 256
               SE reads of 250 bp (seed 43), 1024 reads of 76-250 bp
               (256 in the full call) through align_se and
               align_se_stream, 64 chimeric and 64
               adapter-clipped 250 bp reads; every SAM byte-equal to the
               oracle; fails unless a line has flag 0x800 and SA:Z, a CIGAR
               a soft clip, and K1 ran its K=8 register instance; prints
               the third cap bucket's worker1 calls and K1 launches;
 14. int64   — a second aligner with the index and LUT widened to int64
               aligns phase 3's and phase 5's first timed batch: SAM
               byte-equal to the int32 aligner's and the oracle's, K1 and
               K2 launched, no rescue result missing (in the full call the
               int32 aligner's SAM of those batches is phases 3 and 5's,
               held there to the same oracle text, and is not made again);
 15. scale   — tools/scale_bench at 64 Mbp (chr20 size, BASELINE config 3):
               the genome, index and LUT built (cold) by a --prepare process
               started before phase 7 (phases 7-14 run beside it, and each
               prints whether it still ran at its end), one warm-up and 1
               timed streamed batch of 1024 SE reads in the full call (2
               of 4096 in the scale call), every line
               byte-equal to the oracle; tier-1 overflow per batch and
               whether tier 2 fired (if it fired on no batch, a batch
               built from the overflow reads opens its gate); the tier-2
               call's time and, in the scale call, a stage split of that
               batch (tiers, finish, the whole batch); the PE row (1024
               pairs, 128 in the full call, byte-equal to
               Oracle.align_pe, no rescue result missing).
 16. diag    — the overflow diagnostics (tpubwa_torch/tools/diag_caps.py,
               tune_budgets.py, diag_scale.py, diag_tier2.py,
               classify_overflow.py) on the card: at 4.6 Mbp diag_caps on
               the bench batch of 4096 at the default caps and
               tune_budgets' seeding-budget variants (two in the full
               call, best of one run: the base and fm_dense=8; the seven
               of its default sweep, best of 3, in the diag call); at
               64 Mbp (diag_tier2 without its steady run in the full
               call), on
               phase 15's aligner, diag_scale and diag_tier2 on 4096
               reads, classify_overflow on the first 2048 (SMEMs and
               seeds) and on every 16th read (also chains and regions),
               the split of the reads flagged after seeding into those
               whose oracle counts exceed a cap and those only the dense
               budgets flag (tier 1 and tier 2, over the whole batch, and
               by quarter of the batch), worker1 with each dense budget
               relaxed 2x (tune_budgets, one rep; in the full call the
               base and fm_dense=8 only), and Oracle.align_se's
               ms a read (one thread, at most 512 reads, evenly spaced)
               on the reads tier 1 flagged, on those
               tier 2 left (tier 3's input), on those the tiers left and
               on clean reads, beside the tier-2 and tier-3 calls' times;
               fails if a cumulative stage count decreases, if a read the
               stages flag is not flagged in worker1_packed's buffer, if
               tune_budgets' base variant flags another number of reads
               than diag_caps on the same batch, or if a tool imported JAX
               or the reference package.
 17. profile — the profiling tools (tpubwa_torch/tools/profile_phases.py,
               time_stages.py, time_extend.py, profile_finish.py,
               profile_pe.py) and the parity spot check (parity.py) on the
               4.6 Mbp bench world with phase 3's aligner: profile_phases,
               time_stages and time_extend (both engines' rows; one timed
               rep after the warm-up in the full call, best of 3 in the
               profile call) on 4096 reads, profile_finish on 4096 reads
               (those four on 512 reads in the full call),
               profile_pe on 2048 pairs (256 in the full call), parity
               on 2048 reads (512 in the full call; 2% / 0.2% errors,
               seed 3);
               each prints its rows and a JSON line with the card; fails
               if a tool imported JAX or the reference package, parity
               finds a differing line, the 2-thread finish SAM differs
               from the 1-thread one or (on the bench batch, through the
               uncut walk and extension) from Oracle.align_se, or
               profile_pe misses a rescue result;
 18. rehearsal — tools/run_1m.py on phase 15's 64 Mbp caches: 768 pairs
               of 150 bp (inserts 400 +- 50) through `align r_1.fq r_2.fq
               --shard-dir ... --batch-size 512` in a subprocess,
               SIGKILLed after its second batch line and run again; fails
               unless the run was killed, the resume began past batch 0,
               the merged shards hold 2 x 768 records and every line
               equals the header + Oracle.align_pe, batch by batch.
 19. bench   — `python3 bench_torch.py` (bench.py's counterpart) in a
               subprocess, with TPUBWA_BENCH_TIMED=1 and
               TPUBWA_BENCH_BATCH=2048 in the full call (cut from
               bench.py's 8 batches of 4096 for time; the bench call
               keeps them): one
               JSON line with every key of bench.py's plus "card"; fails
               unless both rates are above 0, the card is this card and
               K1 (SE and PE) and K2 launched in its timed runs;
 20. dryrun  — tools/dryrun.py (__graft_entry__.py's counterpart): entry()
               with a region on every read, dryrun_multichip(8) over 8
               logical shards of cuda:0 (8 cards where there are) with the
               index widened to int64 and the LOAD test (8 x 1024 reads,
               2 Mbp; 8 x 256 in the full call), the reference's asserts; its sharded outputs equal
               worker1_step on the blocks and, on every read that
               overflows in neither, on the whole batch (the LOAD test's
               too, against its one-device run); it writes
               build/tpubwa_torch/SCALING_torch.json. In the full call
               a `dryrun --prepare` process builds the 2 Mbp caches beside
               phases 7-14, as phase 15's --prepare does.
 21. stream  — the SE stream held to the order it replaced and to its
               stages, on the same reads in the same call: (a)
               align_se_stream (one thread, the reference's order), (b)
               the former threaded order (this script's threaded_stream:
               each batch's finish on one worker thread while the calling
               thread dispatches the next worker1), (c) a loop of
               align_se, (d) the stages in turn (_dispatch_se and a
               synchronize, then _finish_se_dispatched, timed apart);
               every variant's SAM byte-equal to the oracle's. In the
               full call, between phases 3 and 4, one pass of (b) and (d)
               over phase 3's 2 timed batches, beside (a) as phase 3 timed
               it on those batches; in the bench call,
               after phase 19, the bench world's batches (4096 x 100 bp,
               seed 7) after one warm-up, windows of 1, 2 and 8 timed
               batches, 3 runs of each variant in turns (a b c d, a b c
               d, ...); per variant and window the seconds a batch and
               the reads/s (median [min, max]).
 22. PE window — only in the pe_window call: the PE stream by window on
               the bench world's PE batches as bench_torch.py makes them
               (2048 pairs of 150 bp, inserts 400 +- 50, seed 11), one
               warm-up batch, then over windows of 1, 2 and 8 timed
               batches, 3 runs each in turns, (pa) align_pe_stream and
               (pb) worker1_packed + sync, then _finish_pe_buf, a batch
               in turn; every SAM byte-equal to Oracle.align_pe, no
               rescue result missing, K1 and K2 launched; per variant and
               window the seconds a batch and the reads/s (median [min,
               max]), worker1's and the finish's seconds for pb, and the
               reserved memory before and after.
 23. options — the alignment options path at the named flag sets of
               tpubwa_torch/tools/option_sets.py (scaled2, pacbio, ont2d,
               intractg, knobs), each parsed by the command line's
               opts_from_args: (a) K1 and K2 bit-equal to their plain
               versions at each set's scores (its band width, z-drop and
               rescue minimum score min_seed_len * a) over the production
               shapes and the edge sweep, whose packed-key rows sit at
               2**22 - a * qlen for the set's match score a, in the
               instance the wrapper picks and the generic one; (b)
               Aligner(opt, device="cuda") on the bench world: one SE batch
               (bench reads, seed 7) and one PE batch (phase 5's pairs,
               seed 11) at each set, kernel counts set to 0 just before
               each and read just after, every SAM byte-equal to
               Oracle.align_se / align_pe under the same options, no rescue
               result missing, K1 launched on both paths and K2 on the PE
               path; a line a set and path with reads, seconds, fallback
               share, tier-1 overflow, tier-2/3 rows, rescue tasks and
               launches; (c) `python -m tpubwa_torch align idx r_1.fq
               r_2.fq --platform cuda -A2 -B8 -O12 -E2` on 512 pairs, the
               file byte-equal to the header + Oracle.align_pe at those
               options. In the full call, after phase 5 (before the 64 Mbp
               build process starts): (a) at all five sets, (b) at scaled2
               and pacbio on 512 reads and 256 pairs, (c) on those 256
               pairs; in the options call
               (b) at all five sets on 4096 reads and 2048 pairs.
 24. contigs — references of many contigs: the bench index re-annotated
               with the grch38 (195 contigs) and hs38dh (3366) layouts of
               tpubwa_torch/tools/contig_layouts.py (the same text, so
               phase 3's LUT cache serves both) under Aligner(...,
               device="cuda"), the header's @SQ lines in layout order; at
               each layout the bench reads through align_se_stream, an
               edge SE batch through align_se (100 bp reads straddling
               every 8th boundary 30, 50 and 70 bp over it on both
               strands, reads flush with 64 contigs' starts and ends, 256
               chimeric 130 + 120 bp reads from two contigs), the bench
               pairs through align_pe_stream and an edge PE batch through
               align_pe (256 plain pairs, fragments across every 8th
               boundary, 128 pairs on two contigs, 64 pairs with a mate
               that has an error every 7 bases 20 bp before a contig's
               end), kernel counts set to 0 just before each and read
               just after, every SAM byte-equal to the oracle at the
               layout, no rescue result missing; per batch reads/s,
               fallback share, tier-1 overflow, tier-2/3 rows, primary
               records on contig 2048 or later (past the packed row's
               11-bit contig field, so tiers 2 and 3 and the oracle),
               SA:Z naming another contig, RNEXT another contig, launches;
               the tiers stage of the bench SE batch at hs38dh against
               grch38; then the command line: the bench text's first
               200 kbp as a grch38-layout FASTA with N runs at the start
               of every 10th contig and the end of every 15th, `index`,
               `align` SE and two-file PE, `align --shard-dir` + `merge
               --sort` and `sort`, each file byte-equal to the header +
               the oracle on that index, chr2 sorted before chr10. In the
               full call, after phase 23 (before the 64 Mbp build
               process starts): 512 bench reads and 256 pairs at both
               layouts, edge batches at every 64th boundary (8 flush
               contigs, 32 chimeras, 16 pairs on two contigs, 8
               heavy-error pairs, 128 plain pairs), no stage split and no
               command line.
 25. long PE — paired-end reads of 2x250 and 2x300 bp on the bench world
               through Aligner(idx, device="cuda"), where K1 (Q > 288) and
               K2 (Q > 256) take their generic shared-memory instances:
               (a) 2048 pairs of 2x250 (inserts 550 +- 50, seed 51), (b)
               2048 pairs of 2x300 (650 +- 60, seed 52), (c) 256 each of
               tpubwa_torch/tools/long_pairs.py's overlapping, read-
               through (TruSeq adapter), trimmed (36-300 bp an end) and
               rescue pairs at 300 bp in one batch, (d) 1024 broad-insert
               pairs (650 +- 250) and 64 rescue pairs, whose rescue
               window makes T >= 2048, (e) 4096 SE reads of 300 bp
               through align_se, each batch with kernel counts set to 0
               just before and read just after, SAM byte-equal to the
               oracle, no rescue result missing; per batch reads/s,
               fallback share, tier-1 overflow, tier-2/3 rows, rescue
               tasks, the rescue calls' Q and T, K1 launches by instance
               and K2's by instance and pass; (f) align_pe_stream over
               (a), (b) and 512 more pairs of 2x250, each batch
               byte-equal to align_pe and the oracle; (g) `python -m
               tpubwa_torch align idx r_1.fq r_2.fq --platform cuda` on
               512 pairs of (b), the file byte-equal to the header +
               Oracle.align_pe. Fails unless K1's generic instance
               launched on (b), (c) and (e), K2's forward and reverse on
               (b), K2's generic instance at T >= 2048 on (d),
               and at 2x250 K1's and K2's K=8 register instances. In the
               full call, after phase 24: (b) and (d) at 256 pairs (16
               rescue pairs), the same checks on what ran.
 26. long SE — long single-end reads (tpubwa_torch/tools/long_reads.py,
               5% chimeras) on the bench world through align_se, where K1
               runs its generic ring instance at widths of 4096-32768: (a)
               512 reads of 4096 bp, hifi profile, bwa's defaults; (b)
               512 reads of 1-12 kbp (log-normal, median 6 kbp), clr
               profile, the pacbio flags, padded one 64-lane bucket past
               its longest read (so split into length buckets); (c) the
               same lengths, ont profile, the ont2d flags, padded to its
               longest read (one full-width call); (d) 256 reads of
               12288 bp, hifi;
               (e) 4 reads of 32768 bp (the packed row's widest query
               begin), hifi; each batch with the kernel count set to 0
               just before and read just after, SAM byte-equal to the
               oracle at the batch's options; per batch reads/s, bases/s,
               fallback share, tier-1 overflow by field (the caps,
               seedcov or seedlen0 above 0x3FF, qe - qb or re - rb above
               0xFFFF), tier-2/3 rows, length buckets, K1's launches and
               device ms by width; then align_se_stream of (a) and (b) at
               bwa's defaults, each byte-equal to (a)'s align_se run and
               to the oracle, and `python -m tpubwa_torch align idx r.fq
               --platform cuda` with the pacbio flags on 128 reads of (b),
               the header's @SQ lines the index's and the file byte-equal
               to the header + Oracle.align_se. Fails unless K1 ran at
               Q = 4096, 8192, 12288 and 32768. In the full call, after
               phase 25: (a) at 32 reads, K1 at Q = 4096.
 27. mate pairs — mate-pair libraries (tpubwa_torch/tools/mate_pairs.py:
               outward-facing RF pairs, either strand) on the bench world
               through Aligner(idx, device="cuda"), where K2's rescue
               windows reach T = 20-40 k: first K2 on 16 tasks at
               T = 40,960 (pestat's widest window at max_ins is below it),
               forward at Q = 150 (K=5) and 300 (generic) and reverse at
               Q = 150, each held to its plain version; then (a) 2048
               pairs of 2x150, gel 3000 +- 300, (b) 2048 of 2x150
               unfractionated (1.5-10 kbp) with 5% junction reads, (c)
               1024 of 2x300 unfractionated, all three with 15% FR
               contamination and 64 rescue pairs, (d) 256 of 2x150
               bimodal (30% at 1.0-1.5 kbp, 70% at 9-10 kbp; T above
               32 k) with 32 rescue pairs, each with kernel counts set to
               0 just before and read just after, SAM byte-equal to the
               oracle, no rescue result missing; per batch reads/s,
               fallback share, rescue tasks, the properly paired share,
               pestat's low, high and failed for each orientation (the
               mirror of native/pe.cpp in tools/mate_pairs.py), the
               rescue calls' T, K2's launches and device ms by pass and
               (Q, T), K1's launches and device ms; then align_pe_stream
               over (a) and (b), each batch byte-equal to its align_pe
               run, and `python -m tpubwa_torch align idx mp.fq -p
               --platform cuda` on 512 interleaved pairs of (b), the
               header's @SQ lines the index's and the file byte-equal to
               the header + Oracle.align_pe. Fails unless RF is live in
               every batch and FR where there is contamination, and K2
               ran at K=5 past T = 14,336 on (b), generic past 13,056 on
               (c) and past 32,768 on (d). In the full call, after phase
               26: (b) at 256 pairs (16 rescue pairs), the same checks.
Phases 7-20 and 23-27 run between phases 5 and 6, each from counts of its
own; phase 6 also holds K1 on the first call of phases 13, 14, 15, 16 and
20 and on phase 17's time_extend kernel row, K2 on the first forward call
of phase 15 and of phase 17's profile_pe, K1 on the first call and K2 on
the first forward call of phase 24's hs38dh batches, and K1 on the first
call and K2 on the first forward call of phase 23 (b) at scaled2 and at
pacbio (at the set's scores), and K1 on the first 2x300 call, K2 on the
first 2x300 forward and reverse calls and on the first forward call at
T >= 2048 of phase 25 (generic instances), K1 on the first call at
Q = 4096 of phase 26, and K2 on the widest first forward call of phase
27 (b) (Q = 150, K=5, T past 14,336), to their plain versions (20 more
entries).
Phases 3 and 5 also print K1's launches of the timed batches by shape
(N, Q, T) with their summed time on the card (CUDA events around each).
Every phase prints its seconds, and the call its whole seconds. In the
full call a process builds the bench world's index and LUT caches beside
phases 1-2, and phase 3 waits for it.
The last line of standard output is {"ok": true, "device": {...}}.

Run from the repository root: python3 chip_smoke.py
(python3 chip_smoke.py kernels stops after phase 2: build, sweeps and row
latency only, for work on the kernels; python3 chip_smoke.py slice runs
the build and phases 7-12 only; python3 chip_smoke.py scale the build and
phases 13-15, with the kernels line of their 4 entries; python3
chip_smoke.py diag the build, the 64 Mbp --prepare and phase 16, with the
kernels line of its one entry; python3 chip_smoke.py profile the build,
the 64 Mbp --prepare and phases 17-18, with the kernels line of their 2
entries; python3 chip_smoke.py bench the build and phases 19 (8 timed SE
batches), 21 (windows of 1, 2 and 8 batches, 3 runs a variant) and 20,
with the kernels line of phase 20's entry; python3 chip_smoke.py
pe_window the build and phase 22; python3 chip_smoke.py options the build
and phase 23 at all five sets at full batch, with the kernels line of its
ten entries, K1 and K2 at each set; python3 chip_smoke.py contigs the
build and phase 24 at full depth with its stage split and command line,
with the kernels line of its two entries; python3 chip_smoke.py long_pe
the build and phase 25 at full depth, (a)-(g), with the kernels line of
its six entries: K1 at 2x250 (K=8) and 2x300 (generic), K2 forward and
reverse at 2x300, forward at T >= 2048, forward at 2x250 (K=8);
python3 chip_smoke.py long_se the build and phase 26 at full depth,
(a)-(e), the stream and the command line, with the kernels line of its
four entries: K1 on its first call at Q = 4096, 8192 and 12288, and at
Q = 32768 on 8 full-width tasks, since (e)'s calls extend no live task;
python3 chip_smoke.py mate_pair the build and phase 27 at full depth,
the stream and the command line, with the kernels line of its five
entries: K2 forward on (b) at Q = 150 and on (c) at Q = 300, and at
T = 40,960 forward at Q = 150 and 300 and reverse at Q = 150.)
"""
import atexit
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
GENOME_LEN = 4_600_000
READ_LEN = 100
BATCH = 4096
TIMED_BATCHES = 2
PE_READ_LEN = 150
PE_PAIRS = 2048         # pairs per PE batch (4096 reads)
PE_TIMED_BATCHES = 2
# int32 peak of one H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# (Hopper architecture white paper); HBM3 at 3.35 TB/s (data sheet)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
OPS_PER_CELL = 15       # int32 operations per banded DP cell (see PERF.md)
# int32 operations per cell of K2's recurrence: score (compare, N test,
# two selects) 4; G = max(max(Hdiag + S, 0), E) 3; A = G - oe_ins + e_ins*j
# 2; running max 1; F = max(carry - e_ins*(j-1), 0) 2; H = max(G, F) 1;
# E' = max(E - e_del, H - oe_del, 0) 4; row max with its column 3
K2_OPS_PER_CELL = 20
SCORING = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, a=1, b=4)
# the same scores under ksw_align_batch's names (the reference's)
ALIGN_SCORING = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, a_sc=1, b_sc=4)
DEVICE = "cuda"         # the device of the command-line and anchor phases
ANCHOR_READS = 256      # phase 11's batch (cut from 4096 and 1024 for time)
NO_DPX = ("KSW_NO_DPX",)  # the kernels' build without DPX instructions


def build():
    """Build K1, K2 (and each without DPX) and the oracle from this
    checkout, concurrently."""
    from tpubwa_torch import oracle
    from tpubwa_torch.ops import sw, sw_local
    from tpubwa_torch.ops.cubuild import KernelLib
    errs = []

    def run(fn):
        try:
            fn()
        except Exception as e:          # re-raised below
            errs.append(e)
    t0 = time.time()
    # the variants without DPX instructions that phase 2's row latency
    # times are built beside the rest
    no_dpx = [KernelLib(m._KERNEL.src.stem, NO_DPX).build
              for m in (sw, sw_local)]
    threads = [threading.Thread(target=run, args=(f,))
               for f in (sw.build_lib, sw_local.build_lib, oracle.get_lib,
                         *no_dpx)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    print(f"build: K1 + K2 (each also without DPX) + oracle in "
          f"{time.time() - t0:.1f} s", flush=True)
    for k in (sw._KERNEL, sw_local._KERNEL):
        for line in ptxas_summary(k.ptxas_log):
            print(f"build: {k.src.name}: {line}", flush=True)


def ptxas_summary(log: str) -> list:
    """One line per kernel instance from nvcc -Xptxas -v: the kernel's name
    with its template arguments, registers, stack and spill bytes."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            sym = m.group(1)
            k = re.search(r"ksw_[a-z_]+_kernel", sym)
            targs = re.findall(r"L[ib](\d+)E", sym[k.end():].split("Ev")[0]) \
                if k else []
            name = (k.group(0) if k else sym) + \
                (f"<{', '.join(targs)}>" if targs else "")
            spill = ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill}")
            name = None
    return out


def gen_tasks(seed, n, maxq, maxt, full=False):
    """Adversarial extension tasks: random, planted-with-errors, duplicated
    and N-containing (the shape envelope of the production path). With
    ``full`` every query has the whole width maxq."""
    import numpy as np
    rng = np.random.default_rng(seed)
    qs = np.full((n, maxq), 4, np.int32)
    ts = np.full((n, maxt), 4, np.int32)
    qlen = rng.integers(5, maxq + 1, n).astype(np.int32)
    if full:
        qlen[:] = maxq
    tlen = rng.integers(10, maxt + 1, n).astype(np.int32)
    for i in range(n):
        t = rng.integers(0, 4, tlen[i]).astype(np.int32)
        q = rng.integers(0, 4, qlen[i]).astype(np.int32)
        if i % 3 == 0 and tlen[i] > qlen[i]:
            off = rng.integers(0, tlen[i] - qlen[i] + 1)
            q = t[off:off + qlen[i]].copy()
            nerr = rng.integers(0, 6)
            pos = rng.integers(0, qlen[i], nerr)
            q[pos] = (q[pos] + rng.integers(1, 4, nerr)) % 4
        if i % 5 == 0 and tlen[i] > 2 * qlen[i]:
            off2 = rng.integers(qlen[i], tlen[i] - qlen[i] + 1)
            t[off2:off2 + qlen[i]] = q % 4
        if i % 7 == 0:
            q[rng.integers(0, qlen[i], 2)] = 4
        qs[i, :qlen[i]] = q
        ts[i, :tlen[i]] = t
    h0 = np.random.default_rng(seed + 1).integers(10, maxq, n).astype(
        np.int32)
    valid = np.ones(n, np.int32)
    valid[::11] = 0                    # invalid rows must come back unchanged
    return qs, qlen, ts, tlen, h0, valid


def time_ms(fn, reps: int) -> float:
    """Mean time of fn on the card over reps calls (CUDA events), after one
    call to warm up; reps = 0 times that one call."""
    import torch
    if reps == 0:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_diff(got, want) -> int:
    import torch
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0


def k1_measure(args, zdrop=100, kernel_reps=20, generic=False,
               scoring=None):
    """Run K1 and ksw_extend_ref on the same card tensors, at ``scoring``
    (ksw_extend's score keywords; bwa's defaults, SCORING, when None);
    returns a dict with the max abs difference, both times and the bound.
    The plain version is timed in the run that gives the values to
    compare (one run of a few hundred ms: repeats cost the call more than
    they tell). With ``generic`` the generic (shared-memory) instance is
    also held to the plain version and timed on the same inputs, in turns
    with the instance the wrapper picks (generic, picked, picked,
    generic)."""
    import torch
    from tpubwa_torch.ops.sw import ksw_extend, ksw_extend_ref, launch_kernel
    q, ql, t, tl, h0, w, eb, valid = args
    kw = dict(scoring or SCORING, zdrop=zdrop)
    # the generic instance's ring is sized for the band, as the worker
    # passes it (no host sync a launch in the timed loops)
    kk = dict(kw, w_max=int(w.max()) if w.numel() else 0)
    got = ksw_extend(*args, **kk)
    stats, ref = {}, []
    plain_ms = time_ms(lambda: ref.append(
        ksw_extend_ref(*args, **kw, stats=stats)), 0)
    want = ref[0]
    err = max_abs_diff(got, want)
    extra = {}
    if generic:
        err = max(err, max_abs_diff(launch_kernel(args, 0, **kk), want))
        g1 = time_ms(lambda: launch_kernel(args, 0, **kk), kernel_reps)
    ms = time_ms(lambda: ksw_extend(*args, **kk), kernel_reps)
    if generic:
        ms = (ms + time_ms(lambda: ksw_extend(*args, **kk), kernel_reps)) / 2
        g2 = time_ms(lambda: launch_kernel(args, 0, **kk), kernel_reps)
        extra["generic_ms"] = (g1 + g2) / 2
    nbytes = sum(x.numel() * x.element_size() for x in args) + \
        got.numel() * got.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    cells = stats.get("cells", 0)        # no row ran: every task was dead
    t_ops = cells * OPS_PER_CELL / INT32_OPS_PER_S * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                cells=cells, bytes=nbytes, **extra)


# Query widths of the edge sweeps: at and around boundaries between two
# register instances (Q a multiple of 32), the widest register instance of
# K2 (256) and of K1 (288), and one width that takes the generic instance of
# both.
EDGE_Q = (31, 32, 33, 127, 128, 129, 159, 160, 161, 255, 256, 257, 288, 300)


def edge_tasks(n, Q, T, seed, a=1):
    """Tasks for the kernels' edge sweeps as numpy arrays (qs, qlen, ts,
    tlen, h0, w, valid): the gen_tasks mix, with every query at full width
    when the seed is odd, and in rows 3.. a query of one base, a target of
    one base, h0 just inside, just outside and far outside what K1's packed
    key holds at match score ``a`` (max(h0, 0) + a * qlen < 2**22; these
    three queries match their targets exactly, so that H reaches that
    sum), h0 = 0, and bands of half-width 0, 1, 3 and 100 in turn so that
    some go empty."""
    import numpy as np
    qs, qlen, ts, tlen, h0, valid = gen_tasks(seed, n, Q, T,
                                              full=bool(seed & 1))
    w = np.array([0, 1, 3, 100] * n, np.int32)[:n]
    if n == 1:
        valid[0], w[0] = 1, 100
    if n >= 12:
        qlen[3], tlen[4] = 1, 1
        h0[5] = (1 << 22) - a * qlen[5] - 1
        h0[6] = (1 << 22) - a * qlen[6]
        h0[7] = 1 << 24
        h0[8] = 0
        w[5:9] = 100
        for i in (5, 6, 7):       # exact matches: H really climbs to
            valid[i] = 1          # h0 + a * qlen, the limit's other side
            tlen[i] = maxt = ts.shape[1]
            ts[i] = np.random.default_rng(seed + i).integers(0, 4, maxt)
            qs[i, :qlen[i]] = ts[i, :qlen[i]]
    return qs, qlen, ts, tlen, h0, w, valid


def set_options(name: str):
    """(MemOptions, the kernels' score keywords) of option set ``name``
    (tpubwa_torch/tools/option_sets.py), or bwa's defaults for None."""
    from tpubwa_torch.opts import MemOptions
    from tpubwa_torch.tools import option_sets
    opt = option_sets.options(name) if name else MemOptions()
    return opt, option_sets.scores(opt)


def parity(card: str, name: str = None, short: bool = False):
    """K1 bit-equal to ksw_extend_ref on the card over the sweep shapes.
    With ``name``, at option set name's scores, band width and z-drop (and
    its match score in the edge sweep's packed-key rows), over the
    production shapes and the edge sweep only; ``short`` keeps the edge
    sweep's rows at the main path's widths (Q = 100 and 151, and 33 at
    N = 1) and leaves out the rest."""
    import torch
    from tpubwa_torch.ops import sw
    dev = torch.device("cuda")
    opt, scoring = set_options(name)
    tag = f"parity[{name}]" if name else "parity"
    shapes = [] if name else [(100, Q, T, 100, 100) for Q in (100, 151, 256)
                              for T in (256, 512, 768, 1024)]
    if not short:
        shapes += [(4500, 100, 290, opt.w, opt.zdrop),
                   (2100, 151, 640, opt.w, opt.zdrop), (600, 100, 290, 3, 10)]
    worst = 0
    for n, Q, T, w, zdrop in shapes:
        qs, qlen, ts, tlen, h0, valid = gen_tasks(Q * 7 + T + n, n, Q, T)
        c = lambda a: torch.as_tensor(a, dtype=torch.int32).to(dev)  # noqa
        args = (c(qs), c(qlen), c(ts), c(tlen), c(h0),
                c([w] * n), c([5] * n), c(valid))
        r = k1_measure(args, zdrop=zdrop, kernel_reps=5, scoring=scoring)
        worst = max(worst, r["max_abs_err"])
        print(f"{tag} N={n:5d} Q={Q:3d} T={T:4d} w={w:3d} zdrop={zdrop:3d}:"
              f" max_abs_err={r['max_abs_err']} (tolerance 0)"
              f" kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
              f" bound {r['bound_ms']:.6f} ms"
              f" ({r['bound_by']}) [{card}]", flush=True)
        if r["max_abs_err"] != 0:
            raise AssertionError(f"K1 differs from ksw_extend_ref at "
                                 f"N={n} Q={Q} T={T} ({tag})")
    # the edge sweep, in the instance the wrapper picks and in the generic
    zd = opt.zdrop
    edge = [(128, Q, 200 + Q, zd) for Q in EDGE_Q]
    edge += [(1, 100, 290, zd), (1, 33, 80, zd), (128, 100, 290, 10),
             (128, 151, 440, zd)]
    for k, (n, Q, T, zdrop) in enumerate(edge):
        if short and k < len(EDGE_Q):
            continue
        qs, qlen, ts, tlen, h0, w, valid = edge_tasks(n, Q, T, 1000 + k,
                                                      opt.a)
        c = lambda a: torch.as_tensor(a, dtype=torch.int32).to(dev)  # noqa
        args = (c(qs), c(qlen), c(ts), c(tlen), c(h0), c(w), c([5] * n),
                c(valid))
        r = k1_measure(args, zdrop=zdrop, kernel_reps=5,
                       generic=True, scoring=scoring)
        worst = max(worst, r["max_abs_err"])
        print(f"{tag} edge N={n:3d} Q={Q:3d} T={T:3d} zdrop={zdrop:3d} "
              f"instance {sw.kernel_instance(Q)} and generic: max_abs_err="
              f"{r['max_abs_err']} (tolerance 0) kernel {r['ms']:.4f} ms, "
              f"generic {r['generic_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms [{card}]", flush=True)
        if r["max_abs_err"] != 0:
            raise AssertionError(f"K1 differs from ksw_extend_ref on the "
                                 f"edge sweep at N={n} Q={Q} T={T} ({tag})")
    return worst


def k2_measure(args, want_sub: bool, kernel_reps=20, generic=False,
               scoring=None):
    """Run K2 and ksw_local_ref on the same card tensors; returns a dict
    with the max abs difference, both times and the bound. The DP cells
    are what these inputs need: qlen x tlen summed over the valid tasks.
    The plain version, ``generic`` and ``scoring`` as in k1_measure."""
    import torch
    from tpubwa_torch.ops.sw_local import (ksw_local, ksw_local_ref,
                                           launch_kernel)
    q, ql, t, tl, minsc, valid = args
    kw = dict(scoring or SCORING, want_sub=want_sub)
    got = ksw_local(*args, **kw)
    ref = []
    plain_ms = time_ms(lambda: ref.append(ksw_local_ref(*args, **kw)), 0)
    want = ref[0]
    err = max_abs_diff(got, want)
    extra = {}
    if generic:
        err = max(err, max_abs_diff(launch_kernel(args, 0, **kw), want))
        g1 = time_ms(lambda: launch_kernel(args, 0, **kw), kernel_reps)
    ms = time_ms(lambda: ksw_local(*args, **kw), kernel_reps)
    if generic:
        ms = (ms + time_ms(lambda: ksw_local(*args, **kw), kernel_reps)) / 2
        g2 = time_ms(lambda: launch_kernel(args, 0, **kw), kernel_reps)
        extra["generic_ms"] = (g1 + g2) / 2
    cells = int((ql.clamp(0, q.shape[1]).to(torch.int64)
                 * tl.clamp(0, t.shape[1]).to(torch.int64)
                 * (valid != 0)).sum())
    nbytes = sum(x.numel() * x.element_size() for x in args) + \
        got.numel() * got.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cells * K2_OPS_PER_CELL / INT32_OPS_PER_S * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                cells=cells, bytes=nbytes, **extra)


def local_tasks(n, Q, T, dev, minsc=19):
    """K2 tasks on the card: the gen_tasks mix plus invalid rows (every
    11th), a row with qlen 0 and a row with tlen 0; the rescue's minimum
    score minsc (min_seed_len * a) on every row."""
    import torch
    qs, qlen, ts, tlen, _, valid = gen_tasks(Q * 5 + T + n, n, Q, T)
    qlen[1], tlen[2] = 0, 0
    c = lambda a: torch.as_tensor(a, dtype=torch.int32).to(dev)  # noqa: E731
    return (c(qs), c(qlen), c(ts), c(tlen), c([minsc] * n), c(valid))


def parity_k2(card: str, name: str = None, short: bool = False):
    """K2 bit-equal to ksw_local_ref on the card over the sweep shapes, in
    both want_sub modes; then ksw_align_batch against the scalar oracle.
    With ``name``, at option set name's scores and rescue minimum score,
    over the production shapes and the edge sweep only; ``short`` as in
    parity (the main path's width here is Q = 150)."""
    import numpy as np
    import torch
    from tpubwa_torch import oracle
    from tpubwa_torch.ops import sw_local
    from tpubwa_torch.pair.rescue import ksw_align_batch
    dev = torch.device("cuda")
    opt, scoring = set_options(name)
    minsc = opt.min_seed_len * opt.a
    tag = f"parity[{name}] K2" if name else "parity K2"
    shapes = [] if name else [(100, Q, T) for Q in (100, 151, 256)
                              for T in (256, 512, 768, 1024)]
    if not short:
        shapes += [(4500, 100, 290), (2100, 151, 640)]
    worst = 0
    for n, Q, T in shapes:
        args = local_tasks(n, Q, T, dev, minsc)
        for want_sub in (True, False):
            r = k2_measure(args, want_sub, kernel_reps=5, scoring=scoring)
            worst = max(worst, r["max_abs_err"])
            print(f"{tag} N={n:5d} Q={Q:3d} T={T:4d} "
                  f"want_sub={int(want_sub)}: max_abs_err={r['max_abs_err']}"
                  f" (tolerance 0) kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms"
                  f" ({r['bound_by']}) [{card}]", flush=True)
            if r["max_abs_err"] != 0:
                raise AssertionError(f"K2 differs from ksw_local_ref at "
                                     f"N={n} Q={Q} T={T} want_sub={want_sub}"
                                     f" ({tag})")
    # the edge sweep (K1's tasks without h0 and w; row 1 gets qlen 0), in
    # the instance the wrapper picks and in the generic one
    edge = [(128, Q, 200 + Q) for Q in EDGE_Q]
    edge += [(1, 150, 768), (1, 33, 80), (128, 150, 768)]
    for k, (n, Q, T) in enumerate(edge):
        if short and k < len(EDGE_Q):
            continue
        qs, qlen, ts, tlen, _, _, valid = edge_tasks(n, Q, T, 2000 + k)
        if n > 1:
            qlen[1] = 0
        c = lambda a: torch.as_tensor(a, dtype=torch.int32).to(dev)  # noqa
        args = (c(qs), c(qlen), c(ts), c(tlen), c([minsc] * n), c(valid))
        for want_sub in (True, False):
            r = k2_measure(args, want_sub, kernel_reps=5,
                           generic=True, scoring=scoring)
            worst = max(worst, r["max_abs_err"])
            print(f"{tag} edge N={n:3d} Q={Q:3d} T={T:3d} want_sub="
                  f"{int(want_sub)} instance {sw_local.kernel_instance(Q)} "
                  f"and generic: max_abs_err={r['max_abs_err']} (tolerance "
                  f"0) kernel {r['ms']:.4f} ms, generic "
                  f"{r['generic_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
                  f"[{card}]", flush=True)
            if r["max_abs_err"] != 0:
                raise AssertionError(f"K2 differs from ksw_local_ref on the "
                                     f"edge sweep at N={n} Q={Q} T={T} "
                                     f"want_sub={want_sub} ({tag})")
    # the composed function (forward pass, reversed prefixes, reverse pass)
    # against the scalar ksw_align, an independent implementation
    q, ql, t, tl, msc, _ = local_tasks(100, 151, 512, dev, minsc)
    ab = dict(scoring)
    ab["a_sc"], ab["b_sc"] = ab.pop("a"), ab.pop("b")
    got = ksw_align_batch(q, ql, t, tl, msc, torch.ones_like(ql),
                          **ab).cpu().numpy()
    qh, qlh, th, tlh = (x.cpu().numpy() for x in (q, ql, t, tl))
    keys = ("score", "tb", "te", "qb", "qe", "score2", "te2")
    want = np.array([[oracle.ksw_align_local(
        qh[i, :qlh[i]], th[i, :tlh[i]], opt, minsc)[k] for k in keys]
        for i in range(len(qlh))])
    bad = int((got != want).any(axis=1).sum())
    print(f"{tag.replace(' K2', '')} ksw_align_batch N=100 Q=151 T=512 on "
          f"the card against the scalar oracle: {bad} rows differ "
          f"(tolerance 0) [{card}]", flush=True)
    if bad:
        raise AssertionError("ksw_align_batch differs from the scalar "
                             "ksw_align")
    return worst


def row_latency(card: str):
    """Latency of one DP row of each kernel, register and generic instance
    side by side: one task (so nothing else shares the card) whose loop
    runs every target row, timed at two target lengths; the slope is the
    time of a row, what is left at zero rows is the cost of a launch. K1's
    task has h0 = 5000, no z-drop and a band and end bonus of 2000, so its
    band is the whole query and stays live on every row; both kernels then
    run tlen rows (256 and 1024), each launch long enough that the host's
    launch rate does not show."""
    import numpy as np
    import torch
    from tpubwa_torch.ops import sw, sw_local
    from tpubwa_torch.ops.cubuild import KernelLib
    dev = torch.device("cuda")
    c = lambda a: torch.as_tensor(a, dtype=torch.int32).to(dev)  # noqa: E731
    rng = np.random.default_rng(5)
    # the same sources built without the DPX instructions (plain max())
    no_dpx = {m: KernelLib(m._KERNEL.src.stem, NO_DPX) for m in (sw, sw_local)}

    def slope(launch, want, what):
        """us a row and us at zero rows of launch(rows), checked against
        the plain version's results want[rows] first."""
        ts = {}
        for rows in (256, 1024):
            if max_abs_diff(launch(rows), want[rows]):
                raise AssertionError(f"{what} differs from its plain version "
                                     "on the row-latency task")
            ts[rows] = time_ms(lambda: launch(rows), 200)
        row_us = (ts[1024] - ts[256]) / 768 * 1e3
        return row_us, ts[256] * 1e3 - 256 * row_us

    how = "(one task, 256 and 1024 rows, 200 launches each)"
    for Q in (100, 150):
        t = rng.integers(0, 4, (1, 1024)).astype(np.int32)
        q = t[:, :Q].copy()
        a1 = {rows: (c(q), c([Q]), c(t[:, :rows]), c([rows]), c([5000]),
                     c([2000]), c([2000]), c([1])) for rows in (256, 1024)}
        kw1 = dict(SCORING, zdrop=0)
        want = {rows: sw.ksw_extend_ref(*a, **kw1) for rows, a in a1.items()}
        for name, inst, lib in (
                ("register", sw.kernel_instance(Q), sw._KERNEL),
                ("register, built without DPX,", sw.kernel_instance(Q),
                 no_dpx[sw]), ("generic", 0, sw._KERNEL)):
            row_us, floor_us = slope(lambda rows: sw.launch_kernel(
                a1[rows], inst, kernel=lib, **kw1), want, "K1")
            print(f"row latency K1 Q={Q} {name} instance {inst}: "
                  f"{row_us:.4f} us a row, {floor_us:.2f} us at zero rows "
                  f"{how} [{card}]", flush=True)
        a2 = {rows: (c(q), c([Q]), c(t[:, :rows]), c([rows]), c([19]),
                     c([1])) for rows in (256, 1024)}
        for want_sub in (True, False):
            kw2 = dict(SCORING, want_sub=want_sub)
            want = {rows: sw_local.ksw_local_ref(*a, **kw2)
                    for rows, a in a2.items()}
            for name, inst, lib in (
                    ("register", sw_local.kernel_instance(Q),
                     sw_local._KERNEL),
                    ("register, built without DPX,",
                     sw_local.kernel_instance(Q), no_dpx[sw_local]),
                    ("generic", 0, sw_local._KERNEL)):
                row_us, floor_us = slope(lambda rows: sw_local.launch_kernel(
                    a2[rows], inst, kernel=lib, **kw2), want, "K2")
                print(f"row latency K2 Q={Q} want_sub={int(want_sub)} {name} "
                      f"instance {inst}: {row_us:.4f} us a row, "
                      f"{floor_us:.2f} us at zero rows {how} [{card}]",
                      flush=True)


def k1_recorder(real, first: list, log: list):
    """A stand-in for worker.ksw_extend that calls the real wrapper, keeps
    the first call's inputs in ``first`` (when given) and every call's
    shape (N, Q, T) in ``log``."""
    def recorder(*args, **kw):
        if first is not None and not first:
            first.append(tuple(a.clone() for a in args))
        log.append((args[0].shape[0], args[0].shape[1], args[2].shape[1]))
        return real(*args, **kw)
    return recorder


def print_k1_shapes(label: str, log: list, what: str, card: str,
                    kernel_ms: list = None):
    """K1's launches by shape (N, Q, T); with ``kernel_ms`` (each launch's
    kernel time from a profiler trace, in launch order) also the summed
    and mean kernel time of each shape."""
    by = {}
    for k, shape in enumerate(log):
        c, ms = by.get(shape, (0, 0.0))
        by[shape] = (c + 1, ms + (kernel_ms[k] if kernel_ms else 0.0))
    total = sum(ms for _, ms in by.values())
    timed = f", {total:.3f} ms of kernel time in all" if kernel_ms else ""
    print(f"{label} K1 launches by shape over {what}: {len(log)} launches, "
          f"{len(by)} shapes{timed} [{card}]", flush=True)
    rows = sorted(by.items(), key=lambda x: (-x[1][1], -x[1][0]))
    for (n, q, t), (c, ms) in rows[:12]:
        each = f", {ms:9.3f} ms summed, {ms / c:.4f} ms each" \
            if kernel_ms else ""
        print(f"{label} K1 shape N={n:5d} Q={q:3d} T={t:4d}: {c:4d} "
              f"launches{each}", flush=True)
    if len(rows) > 12:
        c = sum(v[0] for _, v in rows[12:])
        ms = sum(v[1] for _, v in rows[12:])
        print(f"{label} K1 other shapes ({len(rows) - 12}): {c} launches"
              + (f", {ms:.3f} ms summed" if kernel_ms else ""), flush=True)


def make_aligner():
    """The aligner of the full-size phases: the 4.6 Mbp bench world's
    cached index and LUT (tools/bench_world.py), on the card."""
    from tpubwa_torch.tools import bench_world
    return bench_world.make_aligner("cuda")


def e2e(card: str):
    """Streamed SE alignment on the card, SAM byte-equal to the oracle.
    Returns (aligner, first recorded K1 call's args, launches, reads/s)."""
    import numpy as np
    import torch
    from tpubwa_torch.extend import worker
    from tpubwa_torch.io import fastx
    from tpubwa_torch.ops import sw

    t0 = time.time()
    aln = make_aligner()
    idx = aln.idx
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)
    n_reads = BATCH * (TIMED_BATCHES + 1)
    recs = fastx.simulate_reads(fwd, n_reads, read_len=READ_LEN,
                                error_rate=0.01, indel_rate=0.001, seed=7)
    batches = [fastx.batch_reads(recs[i:i + BATCH], max_len=READ_LEN)
               for i in range(0, n_reads, BATCH)]
    print(f"e2e: index + LUT + reads ready in {time.time() - t0:.1f} s",
          flush=True)
    warm = aln.align_se(batches[0], id0=0)
    if warm != aln.oracle.align_se(batches[0], aln.opt, id0=0):
        raise AssertionError("warm-up batch SAM differs from the oracle")

    # record the first main-path K1 call's inputs and every call's shape
    # and time (the calls go through the real wrapper and are counted)
    recorded, k1_log = [], []
    real = worker.ksw_extend
    worker.ksw_extend = k1_recorder(real, recorded, k1_log)
    aln.stats = {"reads": 0, "fallback_reads": 0}
    try:
        sw.ksw_extend.launches = 0
        torch.cuda.synchronize()
        t1 = time.time()
        sams = list(aln.align_se_stream(batches[1:], id0=BATCH))
        torch.cuda.synchronize()
        dt = time.time() - t1
        launches = sw.ksw_extend.launches
    finally:
        worker.ksw_extend = real
    n = BATCH * TIMED_BATCHES
    rps = n / dt
    fb = aln.stats["fallback_reads"] / max(aln.stats["reads"], 1)
    wants = [aln.oracle.align_se(b, aln.opt, id0=BATCH * (k + 1))
             for k, b in enumerate(batches[1:])]
    check_stream(sams, wants, "phase 3's stream")
    print(f"e2e: {n} reads SAM byte-equal to the oracle; {rps:.1f} reads/s "
          f"over {TIMED_BATCHES} streamed batches of {BATCH} "
          f"({dt:.3f} s); fallback share {fb:.5f}; "
          f"tier1 overflow {aln.stats.get('tier1_ovf', 0)}; "
          f"K1 launches {launches} [{card}]", flush=True)
    if launches <= 0:
        raise AssertionError("the main path launched K1 no time")
    print_k1_shapes("e2e", k1_log, f"{TIMED_BATCHES} timed batches", card)
    return aln, recorded[0], launches, rps, (batches[1:], wants)


def se_stages(aln, timed: list, card: str):
    """Phase 4: the first of phase 3's timed batches stage by stage, and
    the device busy share of the second under the profiler."""
    stages(aln, timed[0], BATCH, card)
    device_share(aln, timed[1], 2 * BATCH, card)


def check_stream(sams: list, wants: list, what: str):
    """Raise unless each batch's SAM equals the oracle's, byte for byte."""
    if len(sams) != len(wants):
        raise AssertionError(f"{what}: {len(sams)} SAM texts for "
                             f"{len(wants)} batches")
    for k, (sam, want) in enumerate(zip(sams, wants)):
        if sam != want:
            d, o = sam.split("\n"), want.split("\n")
            bad = next(i for i, (x, y) in enumerate(zip(d, o)) if x != y)
            raise AssertionError(f"{what}, batch {k}: SAM differs from the "
                                 f"oracle at line {bad}:\n{d[bad]}\n{o[bad]}")


def stepper(out: list):
    """A step(name, fn) that runs fn between two synchronizes and appends
    (name, seconds, K1 launches, K2 launches) to out."""
    import torch
    from tpubwa_torch.ops import sw, sw_local

    def step(name, fn):
        torch.cuda.synchronize()
        l1, l2 = sw.ksw_extend.launches, sw_local.ksw_local.launches
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out.append((name, time.perf_counter() - t0,
                    sw.ksw_extend.launches - l1,
                    sw_local.ksw_local.launches - l2))
        return r
    return step


def print_steps(label: str, out: list, n_reads: int, card: str):
    total = sum(t for _, t, _, _ in out)
    for name, t, k1, k2 in out:
        print(f"{label} {name:15s} {t * 1e3:9.1f} ms "
              f"({100 * t / total:5.1f}%) K1 launches {k1} K2 launches {k2} "
              f"[{card}]", flush=True)
    print(f"{label} total           {total * 1e3:9.1f} ms for {n_reads} "
          f"reads [{card}]", flush=True)


def stages(aln, batch, id0: int, card: str, label: str = "stage") -> dict:
    """Time one batch stage by stage; each stage ends in a synchronize.
    Returns each stage's seconds."""
    import torch
    from tpubwa_torch.chain.device import (chain_filter, chain_seeds,
                                           seeds_from_smems)
    from tpubwa_torch.extend.worker import extend_chains
    from tpubwa_torch.pipeline import _pack
    from tpubwa_torch.seed.lut import collect_smems_lut
    out = []
    step = stepper(out)
    seqs = torch.as_tensor(batch.seqs).to(aln.device).to(torch.int32)
    lens = torch.as_tensor(batch.lens).to(aln.device)
    d, cc = aln.didx, aln.ccfg
    sm = step("seed", lambda: collect_smems_lut(d, aln.lut, seqs, lens,
                                                aln.scfg))
    sd = step("sa+seeds", lambda: seeds_from_smems(d, sm, cc))
    ch = step("chain", lambda: chain_seeds(d, sd, cc))
    fl = step("filter", lambda: chain_filter(ch, cc))
    st = step("extend", lambda: extend_chains(d, seqs, lens, sd, ch,
                                              aln.ecfg, fl))
    buf = step("pack+copy", lambda: _pack(
        st, sd["l_rep"], aln.ecfg.max_regs,
        aln.CAP_FACTOR * batch.n).cpu().numpy())
    regs = step("tiers", lambda: aln._tiers(
        batch, *aln._unpack_host(buf, batch.n)))
    sam = step("finish", lambda: aln._finish_threaded(batch, *regs, id0))
    if sam != aln.oracle.align_se(batch, aln.opt, id0=id0):
        raise AssertionError("stage-by-stage SAM differs from the oracle")
    print_steps(label, out, batch.n, card)
    return {name: t for name, t, _, _ in out}


def pe_e2e(aln, card: str):
    """Streamed PE alignment on the card, SAM byte-equal to the oracle.
    Returns (first recorded K1 call's args, first K2 forward call's args,
    first K2 reverse call's args, K1 launches, K2 launches by want_sub,
    reads/s)."""
    import numpy as np
    import torch
    from tpubwa_torch.extend import worker
    from tpubwa_torch.io import fastx
    from tpubwa_torch.ops import sw, sw_local
    from tpubwa_torch.pair import rescue

    t0 = time.time()
    idx = aln.idx
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)
    n_pairs = PE_PAIRS * (PE_TIMED_BATCHES + 1)
    recs = fastx.simulate_reads(fwd, n_pairs, read_len=PE_READ_LEN,
                                error_rate=0.01, indel_rate=0.001, seed=11,
                                paired=True, insert_mean=400, insert_std=50)
    batches = [fastx.batch_reads(recs[i:i + 2 * PE_PAIRS],
                                 max_len=PE_READ_LEN)
               for i in range(0, 2 * n_pairs, 2 * PE_PAIRS)]
    print(f"e2e PE: reads ready in {time.time() - t0:.1f} s", flush=True)
    warm = aln.align_pe(batches[0], id0=0)
    if warm != aln.oracle.align_pe(batches[0], aln.opt, id0=0)[0]:
        raise AssertionError("PE warm-up batch SAM differs from the oracle")

    # record the first main-path calls' inputs: K1's, and K2's forward and
    # reverse (the calls themselves go through the real wrappers, whose
    # counts are read; K2's count is split by template instance)
    recorded = {}
    calls = {True: 0, False: 0}      # rescue calls per pass, one per batch
    k2_by = {True: 0, False: 0}      # the wrapper's launches per pass
    real = rescue.ksw_local
    real_k1 = worker.ksw_extend

    def recorder(*args, want_sub, **kw):
        calls[want_sub] += 1
        if want_sub not in recorded:
            recorded[want_sub] = tuple(a.clone() for a in args)
        before = sw_local.ksw_local.launches
        r = real(*args, want_sub=want_sub, **kw)
        k2_by[want_sub] += sw_local.ksw_local.launches - before
        return r

    k1_first, k1_log = [], []
    rescue.ksw_local = recorder
    worker.ksw_extend = k1_recorder(real_k1, k1_first, k1_log)
    lib = aln.oracle._lib
    aln.stats = {"reads": 0, "fallback_reads": 0}
    try:
        lib.tb_rescue_miss_reset()
        sw.ksw_extend.launches = 0
        sw_local.ksw_local.launches = 0
        torch.cuda.synchronize()
        t1 = time.time()
        sams = list(aln.align_pe_stream(batches[1:], id0=PE_PAIRS))
        torch.cuda.synchronize()
        dt = time.time() - t1
        k1, k2 = sw.ksw_extend.launches, sw_local.ksw_local.launches
        misses = lib.tb_rescue_miss_count()
    finally:
        rescue.ksw_local = real
        worker.ksw_extend = real_k1
    n = 2 * PE_PAIRS * PE_TIMED_BATCHES
    rps = n / dt
    fb = aln.stats["fallback_reads"] / max(aln.stats["reads"], 1)
    tasks = aln.stats.get("rescue_tasks", 0)
    for k, (b, sam) in enumerate(zip(batches[1:], sams)):
        want = aln.oracle.align_pe(b, aln.opt, id0=PE_PAIRS * (k + 1))[0]
        if sam != want:
            d, o = sam.split("\n"), want.split("\n")
            bad = next(i for i, (x, y) in enumerate(zip(d, o)) if x != y)
            raise AssertionError(f"PE batch {k + 1}: SAM differs from the "
                                 f"oracle at line {bad}:\n{d[bad]}\n{o[bad]}")
    print(f"e2e PE: {n} reads ({n // 2} pairs of {PE_READ_LEN} bp) SAM "
          f"byte-equal to the oracle; {rps:.1f} reads/s over "
          f"{PE_TIMED_BATCHES} streamed batches of {PE_PAIRS} pairs "
          f"({dt:.3f} s); fallback share {fb:.5f}; tier1 overflow "
          f"{aln.stats.get('tier1_ovf', 0)}; rescue tasks per batch "
          f"{tasks / PE_TIMED_BATCHES:.1f}; K1 launches {k1}; K2 launches "
          f"{k2} ({k2_by[True]} forward, {k2_by[False]} reverse; "
          f"{calls[True]} batches with tasks); rescue results missing "
          f"{misses} [{card}]", flush=True)
    if misses != 0:
        raise AssertionError(f"{misses} rescue windows were missing from "
                             "the injected device results")
    if tasks <= 0 or calls[True] == 0 or k2_by != calls \
            or k2 != calls[True] + calls[False] \
            or calls[True] != calls[False]:
        raise AssertionError(f"the PE main path launched K2 {k2} times for "
                             f"{tasks} rescue tasks in {calls[True]} batches "
                             "with tasks: expected a forward and a reverse "
                             "launch for each")
    if k1 <= 0:
        raise AssertionError("the PE main path launched K1 no time")
    print_k1_shapes("e2e PE", k1_log, f"{PE_TIMED_BATCHES} timed batches",
                    card)
    pe_stages(aln, batches[1], PE_PAIRS, card)
    device_share(aln, batches[2], 2 * PE_PAIRS, card, paired=True)
    return k1_first[0], recorded[True], recorded[False], k1, k2_by, rps


def pe_stages(aln, batch, id0: int, card: str):
    """Time one PE batch stage by stage; each stage ends in a synchronize.
    The rescue device call is split into window assembly and the aligned
    batch, and inside that K2's two launches are timed between
    synchronizes of their own; what is left of it is the reversed-prefix
    assembly and glue."""
    import torch
    from tpubwa_torch.pair import rescue
    out = []
    step = stepper(out)
    dev = aln.device
    buf = step("worker1 2 ends", lambda: aln.worker1_packed(
        batch.seqs, batch.lens).cpu().numpy())
    ctx = step("tiers", lambda: aln._pe_regions(batch, buf, id0))
    ctx["hist_h"] = step("isize+hist", lambda: aln._pe_hist(ctx))
    tasks = ctx["tasks"] = step("task gen", lambda: aln._pe_tasks(ctx))
    if len(tasks) == 0:
        raise AssertionError("the staged PE batch has no rescue tasks")
    mate_row, is_rev, rb, wlen, T = rescue.task_arrays(tasks, id0)
    up = lambda a, dt=torch.int32: torch.as_tensor(a).to(dev).to(dt)  # noqa
    wl = up(wlen)
    q, la, t = step("rescue windows", lambda: rescue.rescue_windows(
        aln.didx, up(batch.seqs, torch.uint8), up(batch.lens), up(mate_row),
        up(is_rev), up(rb, aln.didx.pos_dtype), wl, T))
    k2_s = {}
    real = rescue.ksw_local

    def timed(*args, want_sub, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = real(*args, want_sub=want_sub, **kw)
        torch.cuda.synchronize()
        k2_s[want_sub] = time.perf_counter() - t0
        return r
    rescue.ksw_local = timed
    try:
        n = len(tasks)
        res = step("rescue align", lambda: rescue.ksw_align_batch(
            q, la, t, wl,
            torch.full((n,), 19, dtype=torch.int32, device=dev),
            torch.ones(n, dtype=torch.int32, device=dev), **ALIGN_SCORING))
    finally:
        rescue.ksw_local = real
    ctx["res_dev"] = res
    sam = step("finish", lambda: aln._pe_stage_b(ctx))
    if sam != aln.oracle.align_pe(batch, aln.opt, id0=id0)[0]:
        raise AssertionError("PE stage-by-stage SAM differs from the oracle")
    print_steps("PE stage", out, batch.n, card)
    align_s = next(t for name, t, _, _ in out if name == "rescue align")
    print(f"PE stage rescue align of {n} tasks (Q={q.shape[1]} T={T}): K2 "
          f"forward {k2_s[True] * 1e3:.2f} ms, K2 reverse "
          f"{k2_s[False] * 1e3:.2f} ms, reversed prefixes and glue "
          f"{(align_s - k2_s[True] - k2_s[False]) * 1e3:.2f} ms [{card}]",
          flush=True)


def device_share(aln, batch, id0: int, card: str, paired: bool = False):
    """Device busy share of one align_se (or align_pe) batch: the union of
    the CUDA kernel intervals in a torch.profiler trace over the host wall
    time, the kernels that take most device time, the two hand-written
    kernels' device time, and K1's launches of the batch by shape with
    each shape's kernel time from the trace. A trace that shows no device
    time prints "not measured".

    The trace records CUDA activity only and is read from the profiler's
    raw event list: a batch launches 2-4 x 10^5 kernels, and building
    torch.profiler's Python event tree over them (with host operators
    recorded too) took minutes of the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpubwa_torch.extend import worker
    k1_log = []
    real_k1 = worker.ksw_extend
    worker.ksw_extend = k1_recorder(real_k1, None, k1_log)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sam = (aln.align_pe if paired else aln.align_se)(batch, id0=id0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        worker.ksw_extend = real_k1
    t_read = time.perf_counter()
    # (start ns, duration ns, name) of every device event, in start order
    kern = sorted((e.start_ns(), e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)
    t_read = time.perf_counter() - t_read
    want = aln.oracle.align_pe(batch, aln.opt, id0=id0)[0] if paired \
        else aln.oracle.align_se(batch, aln.opt, id0=id0)
    if sam != want:
        raise AssertionError("profiled batch SAM differs from the oracle")
    if not kern:
        print(f"device busy share: not measured (no device time in the "
              f"trace) [{card}]")
        return
    busy, end = 0, 0
    by_name: dict = {}
    for s, d, name in kern:
        if s + d > end:
            busy += s + d - max(s, end)
            end = s + d
        by_name[name] = by_name.get(name, 0) + d
    print(f"device busy share {busy / 1e9 / wall:.4f} of {wall * 1e3:.1f} ms"
          f" (one {'PE' if paired else 'SE'} batch of {batch.n} reads under "
          f"the profiler, {len(kern)} kernels; trace read in {t_read:.1f} s)"
          f" [{card}]", flush=True)
    for name, ns in sorted(by_name.items(), key=lambda x: -x[1])[:6]:
        print(f"  device {ns / 1e6:9.2f} ms  {name[:90]}", flush=True)
    label = "profiled PE batch" if paired else "profiled SE batch"
    for k in ("ksw_extend", "ksw_local"):
        ns = sum(v for n, v in by_name.items() if k in n)
        print(f"{label}: {k} kernels {ns / 1e6:.3f} ms of device time "
              f"[{card}]", flush=True)
    # one stream, so the trace's K1 kernels are in launch order
    k1_ms = [d / 1e6 for _, d, name in kern if "ksw_extend" in name]
    print_k1_shapes(label, k1_log, "the batch", card,
                    k1_ms if len(k1_ms) == len(k1_log) else None)


def smoke_dir() -> Path:
    d = REPO / "build" / "tpubwa_torch" / "smoke_cli"
    d.mkdir(parents=True, exist_ok=True)
    return d


def lut_cache() -> Path:
    from tpubwa_torch.tools import bench_world
    return bench_world.lut_path()


def cli_env(lut: Path = None, **extra) -> dict:
    """The environment of a command-line subprocess: this checkout on the
    path, and the LUT cache phase 3 built (so no process rebuilds it, and
    two processes never write it at once), or ``lut`` for another
    index."""
    return dict(os.environ, PYTHONPATH=str(REPO),
                TPUBWA_LUT_CACHE=str(lut or lut_cache()), **extra)


def run_cli(args: list, what: str, timeout: int = 600,
            lut: Path = None) -> str:
    """Run `python -m tpubwa_torch args` to its end (with ``lut`` as its
    LUT cache, phase 3's unless given); returns its stderr, raises when
    it fails."""
    r = subprocess.run([sys.executable, "-m", "tpubwa_torch", *args],
                       cwd=str(REPO), env=cli_env(lut), capture_output=True,
                       text=True, timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"{what}: the command line exited "
                             f"{r.returncode}:\n{r.stderr[-3000:]}")
    return r.stderr


def cli_line(err: str, key: str) -> str:
    """The command line's own report line that contains key."""
    return next(l for l in err.splitlines() if key in l)


def cli_launches(err: str) -> tuple:
    """(K1, K2) launches from the command line's kernel launch line."""
    m = re.search(r"ksw_extend (\d+), ksw_local (\d+)",
                  cli_line(err, "kernel launches"))
    return int(m.group(1)), int(m.group(2))


def first_diff(got: str, want: str, what: str):
    if got != want:
        d, o = got.split("\n"), want.split("\n")
        bad = next((i for i, (x, y) in enumerate(zip(d, o)) if x != y),
                   min(len(d), len(o)))
        raise AssertionError(
            f"{what}: differs at line {bad} ({len(d)} against {len(o)} "
            f"lines):\n{d[bad] if bad < len(d) else '<end>'}\n"
            f"{o[bad] if bad < len(o) else '<end>'}")


def se_reads(idx):
    """Phase 3's reads, batch by batch (warm-up first)."""
    import numpy as np
    from tpubwa_torch.io import fastx
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)
    n_reads = BATCH * (TIMED_BATCHES + 1)
    recs = fastx.simulate_reads(fwd, n_reads, read_len=READ_LEN,
                                error_rate=0.01, indel_rate=0.001, seed=7)
    return [recs[i:i + BATCH] for i in range(0, n_reads, BATCH)]


def pe_reads(idx):
    """Phase 5's pairs (interleaved records), batch by batch."""
    import numpy as np
    from tpubwa_torch.io import fastx
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)
    n_pairs = PE_PAIRS * (PE_TIMED_BATCHES + 1)
    recs = fastx.simulate_reads(fwd, n_pairs, read_len=PE_READ_LEN,
                                error_rate=0.01, indel_rate=0.001, seed=11,
                                paired=True, insert_mean=400, insert_std=50)
    return [recs[i:i + 2 * PE_PAIRS] for i in range(0, 2 * n_pairs,
                                                    2 * PE_PAIRS)]


def cli_phases(aln, card: str, single_file: bool = True) -> dict:
    """Phases 7-9: the command line on the card. Returns its numbers.
    Without ``single_file`` (the full call) phase 7's SE run is phase 9's
    --shard-dir run, its file the merge of its shards: the two ran the
    same reads through the same command; and phase 8's PE run takes the
    first of phase 5's two timed batches, not both."""
    from tpubwa_torch import cli
    from tpubwa_torch.index.builder import build_index
    from tpubwa_torch.io import fastx
    from tpubwa_torch.utils import dna
    from tpubwa_torch.utils.files import write_atomic
    import numpy as np
    d = smoke_dir()
    idx_path = REPO / "build" / "tpubwa_torch" / \
        f"smoke_index_{GENOME_LEN}.npz"
    if not idx_path.exists():
        write_atomic(idx_path, aln.idx.save)
    hdr = aln.sam_header()
    res = {}

    # ---- 7. SE: the phase-3 timed batches from one FASTQ file
    t0 = time.time()
    fastx.write_fastq(d / "r.fq", [r for b in se_reads(aln.idx)[1:]
                                   for r in b])
    recs = list(fastx.iter_fastq(d / "r.fq"))     # with their qualities
    want = hdr + "".join(aln.oracle.align_se(
        fastx.batch_reads(recs[i:i + BATCH], max_len=READ_LEN), aln.opt,
        id0=i) for i in range(0, len(recs), BATCH))
    prep = time.time() - t0
    sd = d / "shards"
    if sd.exists():
        for f in sd.iterdir():
            f.unlink()
    cmd = ["align", str(idx_path), str(d / "r.fq"), "--platform", DEVICE,
           "--batch-size", str(BATCH), "--shard-dir", str(sd)]
    t0 = time.time()
    if single_file:
        err = run_cli(["align", str(idx_path), str(d / "r.fq"), "-o",
                       str(d / "out.sam"), "--platform", DEVICE,
                       "--batch-size", str(BATCH)], "CLI SE")
    else:
        err = err1 = run_cli(cmd, "CLI SE shard run")
        cli.main(["merge", str(sd / "header.sam"),
                  *map(str, sorted(sd.glob("shard_*.sam"))), "-o",
                  str(d / "out.sam")])
    wall = time.time() - t0
    first_diff((d / "out.sam").read_text(), want, "CLI SE SAM against the "
               "header + the oracle")
    k1, k2 = cli_launches(err)
    res["se"] = dict(line=cli_line(err, "total"), wall=wall, k1=k1, k2=k2)
    how = "" if single_file else " (phase 9's --shard-dir run, merged)"
    print(f"CLI SE{how}: {len(recs)} reads, whole file byte-equal to the "
          f"header + the oracle; the CLI says: {res['se']['line']}; process wall "
          f"{wall:.1f} s (start-up included; reads + oracle prepared in "
          f"{prep:.1f} s); K1 launches {k1}, K2 launches {k2} [{card}]",
          flush=True)
    if k1 <= 0:
        raise AssertionError("the CLI SE path launched K1 no time")

    # ---- 8. PE from two mate files
    t0 = time.time()
    pe_batches = pe_reads(aln.idx)[1:] if single_file else \
        pe_reads(aln.idx)[1:2]
    pe = [r for b in pe_batches for r in b]
    fastx.write_fastq(d / "r_1.fq", pe[0::2])
    fastx.write_fastq(d / "r_2.fq", pe[1::2])
    pe = [r for m in zip(fastx.iter_fastq(d / "r_1.fq"),
                         fastx.iter_fastq(d / "r_2.fq")) for r in m]
    want = hdr + "".join(aln.oracle.align_pe(
        fastx.batch_reads(pe[i:i + 2 * PE_PAIRS], max_len=PE_READ_LEN),
        aln.opt, id0=i // 2)[0] for i in range(0, len(pe), 2 * PE_PAIRS))
    prep = time.time() - t0
    t0 = time.time()
    err = run_cli(["align", str(idx_path), str(d / "r_1.fq"),
                   str(d / "r_2.fq"), "-o", str(d / "pe.sam"),
                   "--platform", DEVICE, "--batch-size", str(2 * PE_PAIRS)],
                  "CLI PE")
    wall = time.time() - t0
    first_diff((d / "pe.sam").read_text(), want, "CLI PE SAM against the "
               "header + Oracle.align_pe")
    k1, k2 = cli_launches(err)
    res["pe"] = dict(line=cli_line(err, "total"), wall=wall, k1=k1, k2=k2)
    print(f"CLI PE: {len(pe) // 2} pairs from two mate files, whole file "
          f"byte-equal to the header + Oracle.align_pe; the CLI says: "
          f"{res['pe']['line']}; process wall {wall:.1f} s (oracle "
          f"{prep:.1f} s); K1 launches {k1}, K2 launches {k2} [{card}]",
          flush=True)
    if k1 <= 0 or k2 < 2 * len(pe_batches):
        raise AssertionError(f"the CLI PE path launched K1 {k1} and K2 "
                             f"{k2} times: expected K2 twice a batch")

    # ---- 9. --shard-dir resume, merge, sort, index
    if single_file:
        err1 = run_cli(cmd, "CLI shard run")
    err2 = run_cli(cmd, "CLI shard rerun")
    shards = sorted(sd.glob("shard_*.sam"))
    n_batches = sum(1 for l in err1.splitlines() if "] batch " in l)
    if len(shards) != TIMED_BATCHES or n_batches != TIMED_BATCHES:
        raise AssertionError(f"shard run: {len(shards)} shards, "
                             f"{n_batches} batches")
    if "] batch " in err2 or "total 0 records" not in err2:
        raise AssertionError("the rerun aligned a batch:\n" + err2[-2000:])
    cli.main(["merge", str(sd / "header.sam"), *map(str, shards), "-o",
              str(d / "merged.sam")])
    first_diff((d / "merged.sam").read_text(),
               (d / "out.sam").read_text(), "merge of the shards")
    cli.main(["sort", str(d / "out.sam"), "-o", str(d / "sorted.sam")])
    srt = (d / "sorted.sam").read_text().splitlines()
    body = [l for l in srt if not l.startswith("@")]
    keys = [(l.split("\t")[2] == "*", int(l.split("\t")[3])) for l in body]
    if srt[0] != "@HD\tVN:1.6\tSO:coordinate" or keys != sorted(keys) or \
            sorted(body) != sorted(l for l in (d / "out.sam").read_text()
                                   .splitlines() if not l.startswith("@")):
        raise AssertionError("sort did not give coordinate order")
    name = aln.idx.anns[0].name
    seq = dna.decode(aln.idx.get_seq(0, 200_000).astype(np.uint8))
    (d / "g200k.fa").write_text(f">{name}\n{seq}\n")
    t0 = time.time()
    cli.main(["index", str(d / "g200k.fa"), "-o", str(d / "g200k.npz")])
    t_index = time.time() - t0
    build_index([(name, seq)]).save(d / "g200k_here.npz")
    a, b = np.load(d / "g200k.npz"), np.load(d / "g200k_here.npz")
    if sorted(a.files) != sorted(b.files) or not all(
            np.array_equal(a[k], b[k]) for k in a.files):
        raise AssertionError("index of the 200 kbp FASTA differs from "
                             "build_index")
    print(f"CLI shards: {len(shards)} shards; the rerun aligned no batch; "
          f"merge equals the single file; sort in coordinate order; index "
          f"of 200 kbp ({t_index:.1f} s) equal to build_index, "
          f"{len(a.files)} arrays [{card}]", flush=True)
    return res


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_phase(aln, card: str) -> dict:
    """Phase 10: two processes of the command line on one card, uneven PE
    input. Files sort as u0, u1, u2: rank 0 aligns u0 (1024 pairs) and u2
    (2048 pairs) in 3 batches of 2048 reads, rank 1 u1 (1024 pairs) in 1.
    Round 0 of the histogram sum holds u0 and u1, so both must equal this
    process's align_pe of u0 + u1 as one batch; rounds 1-2 hold u2's
    batches alone (rank 1 adds zeros). u1's inserts are 600 +- 50, and
    one pair in 8 of u0 has an insert of 650 +- 20: outliers to u0's own
    histogram (not proper pairs), inside the summed one (proper pairs), so
    u0's SAM shows which histogram it was aligned with."""
    import numpy as np
    from tpubwa_torch.io import fastx
    d = smoke_dir()
    idx_path = REPO / "build" / "tpubwa_torch" / \
        f"smoke_index_{GENOME_LEN}.npz"
    recs = [r for b in pe_reads(aln.idx) for r in b]
    half = PE_PAIRS            # reads in 1024 pairs
    fwd = aln.idx.get_seq(0, aln.idx.l_pac).astype(np.uint8)

    def pairs(n, ins, sd, seed, tag):
        return [fastx.FastxRecord(f"{tag}{r.name}", r.seq)
                for r in fastx.simulate_reads(
                    fwd, n, read_len=PE_READ_LEN, error_rate=0.01,
                    indel_rate=0.001, seed=seed, paired=True,
                    insert_mean=ins, insert_std=sd)]
    n_long = half // 16
    parts = {"u0": recs[:half - 2 * n_long] + pairs(n_long, 650, 20, 13,
                                                    "x"),
             "u1": pairs(half // 2, 600, 50, 12, "w"),
             "u2": recs[2 * half:4 * half]}
    for k, v in parts.items():
        fastx.write_fastq(d / f"{k}.fq", v)
        parts[k] = list(fastx.iter_fastq(d / f"{k}.fq"))
    for f in d.glob("mh.host*.sam"):
        f.unlink()
    port = str(free_port())
    args = ["align", "-p", "--multihost", "--batch-size", str(half),
            "--platform", DEVICE, str(idx_path),
            *(str(d / f"{k}.fq") for k in ("u0", "u1", "u2")),
            "-o", str(d / "mh.sam")]
    procs = []
    t0 = time.time()
    try:
        for rank, id0 in ((0, 0), (1, half)):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpubwa_torch", *args, "--id0",
                 str(id0)], cwd=str(REPO),
                env=cli_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                            WORLD_SIZE="2", RANK=str(rank)),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.time() - t0
    for rank, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            raise AssertionError(f"multihost rank {rank} exited "
                                 f"{p.returncode}:\n{err[-3000:]}")
    plans = [cli_line(e, "PE plan") for e in errs]
    launches = [cli_launches(e) for e in errs]
    # the single-process run: this process, the same batches and ids
    b01 = fastx.batch_reads(parts["u0"] + parts["u1"], max_len=PE_READ_LEN)
    s1 = aln.align_pe(b01, id0=0)
    first_diff(s1, aln.oracle.align_pe(b01, aln.opt, id0=0)[0],
               "single-process batch u0+u1 against the oracle")
    u2 = parts["u2"]
    s2 = "".join(aln.align_pe(fastx.batch_reads(
        u2[i:i + half], max_len=PE_READ_LEN), id0=(half + i) // 2)
        for i in range(0, len(u2), half))
    lines = s1.splitlines(True)
    cut = next(i for i, l in enumerate(lines)
               if l.split("\t")[0] == parts["u1"][0].name)

    def body(path):
        return "".join(l for l in path.read_text().splitlines(True)
                       if not l.startswith("@"))
    first_diff(body(d / "mh.host0000.sam"), "".join(lines[:cut]) + s2,
               "multihost rank 0's shard against the single-process run")
    first_diff(body(d / "mh.host0001.sam"), "".join(lines[cut:]),
               "multihost rank 1's shard against the single-process run")
    # what the sum changed: u0 aligned with its own histogram alone
    alone = aln.align_pe(fastx.batch_reads(parts["u0"],
                                           max_len=PE_READ_LEN), id0=0)
    n_diff = sum(x != y for x, y in zip(alone.splitlines(True),
                                        lines[:cut]))
    print(f"multihost: 2 processes on one card, shards byte-equal to the "
          f"single-process run (rank 0: {plans[0].split('] ')[1]}; rank 1: "
          f"{plans[1].split('] ')[1]}); {n_diff} of {cut} lines of rank "
          f"0's first batch differ from aligning it with its own histogram "
          f"alone; wall {wall:.1f} s for both processes; launches K1/K2 "
          f"rank 0 {launches[0]}, rank 1 {launches[1]} [{card}]", flush=True)
    if min(l[0] for l in launches) <= 0:
        raise AssertionError("a multihost process launched K1 no time")
    if n_diff == 0:
        raise AssertionError("rank 0's first batch aligns the same with its "
                             "own histogram: the check cannot tell whether "
                             "the histograms were summed")
    return dict(wall=wall, launches=launches, n_diff=n_diff)


def anchor_phase(aln, card: str) -> dict:
    """Phase 11: the anchor seeding path on the card."""
    import torch
    from tpubwa_torch.io import fastx
    from tpubwa_torch.ops import sw
    from tpubwa_torch.pipeline import Aligner
    from tpubwa_torch.seed.anchor import collect_smems_anchor
    from tpubwa_torch.seed.device import SeedConfig, collect_smems
    from tpubwa_torch.seed.lut import collect_smems_lut
    batch = fastx.batch_reads(se_reads(aln.idx)[1][:ANCHOR_READS],
                              max_len=READ_LEN)
    t0 = time.time()
    anc = Aligner(aln.idx, aln.opt, seed_impl="anchor", device=DEVICE)
    t_init = time.time() - t0
    sw.ksw_extend.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    sam = anc.align_se(batch, id0=BATCH)
    torch.cuda.synchronize()
    dt = time.time() - t0
    k1 = sw.ksw_extend.launches
    first_diff(sam, aln.oracle.align_se(batch, aln.opt, id0=BATCH),
               "anchor-seeded SE batch against the oracle")
    if k1 <= 0:
        raise AssertionError("the anchor path launched K1 no time")
    seqs = torch.as_tensor(batch.seqs).to(DEVICE).to(torch.int32)
    lens = torch.as_tensor(batch.lens).to(DEVICE)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t
    # both seed stages are warm: align_se above ran the anchor's, and the
    # LUT's gets one call first
    out_a, t_anchor = timed(lambda: collect_smems_anchor(
        anc.didx, seqs, lens, anc.scfg))
    lut_seed = lambda: collect_smems_lut(aln.didx, aln.lut, seqs,  # noqa
                                         lens, aln.scfg)
    lut_seed()
    _, t_lut = timed(lut_seed)
    # every read of the batch against the oracle; the anchor's walk is the
    # timed one above
    n = batch.n
    o = aln.opt
    outs = {"anchor": out_a,
            "per-end walk": collect_smems(anc.didx, seqs, lens,
                                          SeedConfig(
                                              min_seed_len=o.min_seed_len,
                                              split_len=o.split_len,
                                              split_width=o.split_width))}
    host = [aln.oracle.smems(batch.seqs[b][: batch.lens[b]], o)
            for b in range(n)]
    checked = {}
    for name, out in outs.items():
        h = {k: v.cpu().numpy() for k, v in out.items()}
        checked[name] = 0
        for b in range(n):
            if h["overflow"][b]:
                continue
            dev = [(int(h["k"][b, i]), int(h["s"][b, i]), int(h["qb"][b, i]),
                    int(h["qe"][b, i])) for i in range(h["n"][b])]
            if dev != [(int(r[0]), int(r[2]), int(r[3]), int(r[4]))
                       for r in host[b]]:
                raise AssertionError(f"{name} seeding differs from "
                                     f"Oracle.smems on read {b}")
            checked[name] += 1
    print(f"anchor: {batch.n} reads through Aligner(seed_impl='anchor') "
          f"SAM byte-equal to the oracle in {dt:.2f} s (set-up {t_init:.1f}"
          f" s); fallback {anc.stats['fallback_reads']}, tier1 overflow "
          f"{anc.stats.get('tier1_ovf', 0)}; K1 launches {k1}; seed stage "
          f"of the batch: anchor {t_anchor * 1e3:.1f} ms "
          f"({int(out_a['it'])} steps, {t_anchor / int(out_a['it']) * 1e3:.2f}"
          f" ms a step, {int(out_a['overflow'].sum())} reads "
          f"overflow) against LUT {t_lut * 1e3:.1f} ms; on {n} reads equal "
          f"to Oracle.smems: anchor {checked['anchor']}, per-end walk "
          f"{checked['per-end walk']} reads (the rest overflowed) [{card}]",
          flush=True)
    return dict(dt=dt, k1=k1, t_anchor=t_anchor, t_lut=t_lut,
                checked=checked)


def sync_all():
    """Wait for every card this process sees."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def backward_search(step, holder, qs, dt, text: int):
    """Backward search of every row of qs (B, Q) from its last base: the
    intervals (k, s) after each step, stacked (Q, B)."""
    import torch
    B, Q = qs.shape
    k = torch.zeros(B, dtype=dt, device=qs.device)
    s = torch.full((B,), text + 1, dtype=dt, device=qs.device)
    ks, ss = [], []
    for j in range(Q - 1, -1, -1):
        alive = s > 0
        k2, s2 = step(holder, torch.where(alive, k, 1),
                      torch.where(alive, s, 1),
                      torch.where(alive, qs[:, j], 0))
        k = torch.where(alive & (s2 > 0), k2, k)
        s = torch.where(alive, s2.clamp(min=0), s)
        ks.append(k)
        ss.append(s)
    return torch.stack(ks), torch.stack(ss)


def step_on_blocks(didx, seqs, lens, lut, cfg: dict, n: int) -> dict:
    """worker1_step on each of n contiguous blocks of the batch in turn,
    concatenated: what entry i of an n-entry mesh must give."""
    import torch
    from tpubwa_torch.dist.mesh import worker1_step
    b = seqs.shape[0] // n
    outs = [worker1_step(didx, seqs[i * b:(i + 1) * b],
                         lens[i * b:(i + 1) * b], lut, **cfg)
            for i in range(n)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def held_to_whole(out: dict, blocks: dict, whole: dict, what: str) -> str:
    """Fail unless a mesh's outputs equal worker1_step on its blocks (all
    13 keys) and, on every read that overflows in neither run, worker1_step
    on the whole batch (tolerance 0); returns the line that says so."""
    import torch
    if blocks is not None:
        bad = [k for k in whole if not torch.equal(out[k], blocks[k])]
        if bad:
            raise AssertionError(f"{what} differs from worker1_step on its "
                                 f"blocks in {bad}")
    kept = ~(out["overflow"] | whole["overflow"])
    bad = [k for k in whole if not torch.equal(out[k][kept],
                                               whole[k][kept])]
    if bad:
        raise AssertionError(f"{what}: reads that overflow in neither "
                             f"run differ from the whole batch in {bad}")
    moved = int((out["overflow"] & ~whole["overflow"]).sum())
    back = int((whole["overflow"] & ~out["overflow"]).sum())
    head = "equal to worker1_step on its blocks (tolerance 0) and, " \
        if blocks is not None else "(tolerance 0), "
    return (f"all 13 outputs {head}on the {int(kept.sum())} reads that "
            f"overflow in neither run, equal to the whole batch; the split "
            f"moved {moved} reads to overflow and {back} out of it")


def dist_phase(aln, card: str) -> dict:
    """Phase 12: worker1 over a mesh of cards and of logical shards on
    cuda:0, the row-sharded index's routed probes and the histogram sum,
    each against the replicated single-device path (tolerance 0)."""
    import numpy as np
    import torch
    from tpubwa_torch.dist import shard_index as sh
    from tpubwa_torch.dist.mesh import (Mesh, insert_size_psum, make_mesh,
                                        worker1_sharded, worker1_step)
    from tpubwa_torch.index import device as dev
    from tpubwa_torch.io import fastx
    from tpubwa_torch.ops import sw

    t_phase = time.time()
    cuda0 = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()
    batch = fastx.batch_reads(se_reads(aln.idx)[1], max_len=READ_LEN)
    seqs = torch.as_tensor(batch.seqs).to(cuda0).to(torch.int32)
    lens = torch.as_tensor(batch.lens).to(cuda0)
    cfg = dict(scfg=aln.scfg, ccfg=aln.ccfg, ecfg=aln.ecfg)

    def timed(fn):
        sync_all()
        sw.ksw_extend.launches = 0
        t = time.perf_counter()
        out = fn()
        sync_all()
        return out, (time.perf_counter() - t) * 1e3, sw.ksw_extend.launches

    # ---- (a) worker1 over a mesh against worker1_step on the whole batch
    # and on each block in turn (what entry i of a mesh must give: a dense
    # budget of the step is sized from its block's reads, so the split may
    # move reads to overflow, as the reference's shard_map does)
    worker1_step(aln.didx, seqs, lens, aln.lut, **cfg)       # warm
    whole, ms_whole, k1_whole = timed(
        lambda: worker1_step(aln.didx, seqs, lens, aln.lut, **cfg))
    print(f"dist: worker1_step on the whole batch of {batch.n} x "
          f"{READ_LEN} bp: {ms_whole:.1f} ms, K1 launches {k1_whole}, "
          f"{int(whole['overflow'].sum())} reads overflow [{card}]",
          flush=True)
    res = {"whole_ms": ms_whole, "k1_whole": k1_whole}
    for name, mesh in ((f"every card ({n_cards})", make_mesh()),
                       ("4 logical shards on cuda:0", Mesh((cuda0,) * 4))):
        blocks = whole
        if mesh.size > 1:
            blocks, ms, k1 = timed(lambda: step_on_blocks(
                aln.didx, seqs, lens, aln.lut, cfg, mesh.size))
            print(f"dist: worker1_step on the {mesh.size} blocks in turn: "
                  f"{ms:.1f} ms, K1 launches {k1} [{card}]", flush=True)
            res[f"{name} blocks"] = (ms, k1)
        runs = [("first call", lambda: worker1_sharded(
                    mesh, aln.didx, seqs, lens, lut=aln.lut, **cfg)),
                ("second call", lambda: worker1_sharded(
                    mesh, aln.didx, seqs, lens, lut=aln.lut, **cfg))]
        for call, fn in runs:
            out, ms, k1 = timed(fn)
            if k1 <= 0:
                raise AssertionError(f"worker1 over {name} ({call}) "
                                     f"launched K1 no time")
            print(f"dist: worker1_sharded over {name}, {call}: "
                  f"{held_to_whole(out, blocks, whole, name)}; {ms:.1f} ms "
                  f"against {ms_whole:.1f} ms; K1 launches {k1} [{card}]",
                  flush=True)
            res[f"{name} {call}"] = (ms, k1)

    # ---- (b) the row-sharded index against the replicated DeviceIndex
    didx = aln.didx
    text = 2 * didx.l_pac
    rng = np.random.default_rng(12)
    ranks = torch.as_tensor(rng.integers(0, text + 1, 65536)).to(
        didx.pos_dtype).to(cuda0)
    valid = torch.as_tensor(rng.random(65536) < 0.9).to(cuda0)
    clean = (seqs[:, :21] < 4).all(dim=1)
    qs = seqs[clean, :21].contiguous()
    whole_bytes = sum(t.numel() * t.element_size()
                      for t in (didx.occ_fused, didx.sa_samples))
    idx_meshes = [("4 logical shards on cuda:0", Mesh((cuda0,) * 4))]
    if n_cards > 1:
        idx_meshes.append((f"every card ({n_cards})", make_mesh()))
    for name, mesh in idx_meshes:
        sidx = sh.ShardedIndex.from_device_index(didx, mesh)
        for what, got, want in (
                ("occ4_all", lambda: sh.run_sharded(
                    mesh, sh.occ4_all_sharded, sidx, ranks),
                 lambda: dev.occ4_all(didx, ranks)),
                ("inv_psi", lambda: sh.run_sharded(
                    mesh, sh.inv_psi_sharded, sidx, ranks),
                 lambda: dev.inv_psi(didx, ranks)),
                ("sa_lookup", lambda: sh.run_sharded(
                    mesh, sh.sa_lookup_sharded, sidx, ranks, valid)[valid],
                 lambda: dev.sa_lookup(didx, ranks, valid)[valid]),
                ("backward search", lambda: torch.cat(sh.run_sharded(
                    mesh, lambda h, q: backward_search(
                        sh.backward_ext_sharded, h, q, didx.pos_dtype, text),
                    sidx, qs)),
                 lambda: torch.cat(backward_search(
                     dev.backward_ext, didx, qs, didx.pos_dtype, text)))):
            g, w = got(), want()
            if not torch.equal(g, w):
                raise AssertionError(f"sharded {what} over {name} differs "
                                     f"from the replicated DeviceIndex")
        reps = 20
        rounds = {}
        for how, fn in (("routed", lambda: sh.occ4_all_sharded(sidx, ranks)),
                        ("replicated", lambda: dev.occ4_all(didx, ranks))):
            fn()
            sync_all()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            sync_all()
            rounds[how] = (time.perf_counter() - t) * 1e3 / reps
        held = [sidx.shard_bytes(i) for i in range(mesh.size)]
        print(f"dist: ShardedIndex over {name}: occ4_all, inv_psi and "
              f"sa_lookup of 65536 ranks and the backward search of "
              f"{qs.shape[0]} reads' first 21-mers equal the replicated "
              f"DeviceIndex (tolerance 0); a round of occ4_all on 65536 "
              f"ranks {rounds['routed']:.4f} ms routed against "
              f"{rounds['replicated']:.4f} ms replicated; a shard holds "
              f"{max(held)} of the {whole_bytes} bytes of occ rows and SA "
              f"samples ({100 * max(held) / whole_bytes:.1f}%) [{card}]",
              flush=True)
        res[f"index {name}"] = (rounds, max(held), whole_bytes)

    # ---- (c) the insert-size histogram summed over the mesh
    inserts = rng.integers(-10, 1200, batch.n).astype(np.int32)
    ok = rng.random(batch.n) < 0.8
    want = np.bincount(np.clip(inserts, 0, 1000)[ok], minlength=1001)
    for name, mesh in ((f"every card ({n_cards})", make_mesh()),
                       ("4 logical shards on cuda:0", Mesh((cuda0,) * 4))):
        got = insert_size_psum(mesh, torch.as_tensor(inserts).to(cuda0),
                               torch.as_tensor(ok).to(cuda0), max_ins=1000)
        if got.device != cuda0 or not np.array_equal(got.cpu().numpy(),
                                                     want):
            raise AssertionError(f"insert_size_psum over {name} differs "
                                 f"from np.bincount")
    print(f"dist: insert_size_psum of {batch.n} inserts over every card and "
          f"over 4 logical shards equals np.bincount; phase 12 took "
          f"{time.time() - t_phase:.1f} s [{card}]", flush=True)
    return res


LONG_READ_LEN = 250
LONG_READS = 256        # SE 250 bp reads of phase 13 (seed 43)
MIXED_READS = 1024      # reads of 76-250 bp in phase 13's mixed batch
FULL_CALL_MIXED_READS = 256   # ... in the full call (cut for phase 25)
CLIP_READS = 64         # chimeric and adapter-clipped reads, each
SCALE_MBP = 64          # phase 15's genome (chr20 size, BASELINE config 3)
SCALE_READS = 8192      # phase 15's timed SE reads (2 batches of 4096)
FULL_CALL_SCALE_READS = 1024   # ... in the full call (cut for time)
SCALE_PE_PAIRS = 1024   # phase 15's PE row: pairs a batch (warm-up, timed)
FULL_CALL_SCALE_PE_PAIRS = 128   # ... in the full call (cut for time)


def count_k1(fn, log: list, first: list = None):
    """Run fn with K1's launch count set to 0 and every call's shape (and
    the first call's inputs, when ``first`` is given) recorded; returns
    (fn's result, K1 launches)."""
    from tpubwa_torch.extend import worker
    from tpubwa_torch.ops import sw
    real = worker.ksw_extend
    worker.ksw_extend = k1_recorder(real, first, log)
    try:
        sw.ksw_extend.launches = 0
        out = fn()
        return out, sw.ksw_extend.launches
    finally:
        worker.ksw_extend = real


def long_records(fwd, n: int, seed: int) -> list:
    """n chimeric 250 bp reads (100-149 bases of one locus, the rest from
    another: a primary and a supplementary line) and n adapter-clipped
    ones (220 bases of the genome and 30 random: a soft clip), built as
    tests/test_long_reads.py builds them, over the whole genome."""
    import numpy as np
    from tpubwa_torch.io import fastx
    from tpubwa_torch.utils import dna
    rng = np.random.default_rng(seed)
    top = len(fwd) - 300
    recs = []
    for i in range(n):
        p1, p2 = (int(x) for x in rng.integers(0, top, 2))
        c = int(rng.integers(100, 150))
        recs.append(fastx.FastxRecord(f"split{i}", dna.decode(
            np.concatenate([fwd[p1:p1 + c], fwd[p2:p2 + 250 - c]]))))
    for i in range(n):
        p = int(rng.integers(0, top))
        junk = rng.integers(0, 4, 30).astype(np.uint8)
        recs.append(fastx.FastxRecord(f"ad{i}", dna.decode(
            np.concatenate([fwd[p:p + 220], junk]))))
    return recs


def long_phase(aln, card: str, mixed_reads: int = MIXED_READS) -> dict:
    """Phase 13: long reads on the card (BASELINE config 5). 256 SE reads
    of 250 bp (seed 43), a mixed batch of ``mixed_reads`` reads of 76-250
    bp through align_se and through align_se_stream (two halves), and 64
    chimeric + 64 adapter-clipped 250 bp reads: every SAM byte-equal to
    the oracle's. Fails unless a line has flag 0x800 and an SA:Z tag, a
    CIGAR has a soft clip, and K1 ran the K=8 register instance."""
    import numpy as np
    import torch
    from tpubwa_torch.io import fastx
    from tpubwa_torch.ops import sw
    t_phase = time.time()
    idx = aln.idx
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)
    long = fastx.batch_reads(fastx.simulate_reads(
        fwd, LONG_READS, read_len=LONG_READ_LEN, error_rate=0.01,
        indel_rate=0.001, seed=43), max_len=LONG_READ_LEN)
    sims = fastx.simulate_reads(fwd, mixed_reads, read_len=LONG_READ_LEN,
                                error_rate=0.01, indel_rate=0.001, seed=44)
    cut = np.random.default_rng(45).integers(76, LONG_READ_LEN + 1,
                                             mixed_reads)
    mixed_recs = [fastx.FastxRecord(r.name, r.seq[:L])
                  for r, L in zip(sims, cut)]
    mixed = fastx.batch_reads(mixed_recs, max_len=LONG_READ_LEN)
    halves = [fastx.batch_reads(mixed_recs[i:i + mixed_reads // 2],
                                max_len=LONG_READ_LEN)
              for i in (0, mixed_reads // 2)]
    clip = fastx.batch_reads(long_records(fwd, CLIP_READS, 46),
                             max_len=LONG_READ_LEN)
    # the third cap bucket's packed worker1, wrapped to count its calls
    # and the K1 launches made inside them
    key = aln._CAP_BUCKETS[-1][0]
    aln._packed_for_len(LONG_READ_LEN)
    real3 = aln._packed[key]
    bucket3 = {"calls": 0, "k1": 0}

    def third(seqs, lens):
        before = sw.ksw_extend.launches
        out = real3(seqs, lens)
        bucket3["calls"] += 1
        bucket3["k1"] += sw.ksw_extend.launches - before
        return out

    def run():
        t = {}
        for name, fn in (
                ("250 bp", lambda: aln.align_se(long, id0=0)),
                ("mixed", lambda: aln.align_se(mixed, id0=0)),
                ("mixed streamed", lambda: "".join(
                    aln.align_se_stream(halves, id0=0))),
                ("clipped", lambda: aln.align_se(clip, id0=0))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t[name] = (fn(), time.perf_counter() - t0)
        return t
    aln._packed[key] = third
    aln.stats = {"reads": 0, "fallback_reads": 0}
    k1_first, k1_log = [], []
    try:
        out, k1 = count_k1(run, k1_log, k1_first)
    finally:
        aln._packed[key] = real3
    o = aln.opt
    want = {"250 bp": aln.oracle.align_se(long, o, id0=0),
            "mixed": aln.oracle.align_se(mixed, o, id0=0),
            "clipped": aln.oracle.align_se(clip, o, id0=0)}
    want["mixed streamed"] = want["mixed"]
    for name, (sam, _) in out.items():
        first_diff(sam, want[name], f"phase 13 {name} SAM against the "
                   "oracle")
    lines = [l.split("\t") for name, (sam, _) in out.items()
             for l in sam.splitlines()]
    supp = sum(1 for f in lines if int(f[1]) & 0x800 and
               any(t.startswith("SA:Z:") for t in f[11:]))
    soft = sum(1 for f in lines if "S" in f[5])
    k8 = sum(1 for n, q, t in k1_log if sw.kernel_instance(q) == 8)
    print(f"long: {LONG_READS} SE reads of {LONG_READ_LEN} bp "
          f"({out['250 bp'][1]:.2f} s, {LONG_READS / out['250 bp'][1]:.1f} "
          f"reads/s), {mixed_reads} reads of 76-{LONG_READ_LEN} bp through "
          f"align_se ({out['mixed'][1]:.2f} s) and align_se_stream "
          f"({out['mixed streamed'][1]:.2f} s), {2 * CLIP_READS} chimeric "
          f"and adapter-clipped reads ({out['clipped'][1]:.2f} s): every "
          f"SAM byte-equal to the oracle; {supp} supplementary lines with "
          f"SA:Z, {soft} lines with a soft clip; fallback "
          f"{aln.stats['fallback_reads']} of {aln.stats['reads']} reads, "
          f"tier1 overflow {aln.stats.get('tier1_ovf', 0)}; K1 launches "
          f"{k1}, {k8} of them by the K=8 register instance; the third "
          f"cap bucket ran {bucket3['calls']} worker1 calls with "
          f"{bucket3['k1']} K1 launches [{card}]", flush=True)
    print_k1_shapes("long", k1_log, "phase 13's batches", card)
    if not supp or not soft or not k8 or not bucket3["calls"]:
        raise AssertionError(
            f"phase 13: {supp} supplementary lines with SA:Z, {soft} soft "
            f"clips, {k8} K1 launches of the K=8 instance, "
            f"{bucket3['calls']} calls of the third cap bucket: each must "
            "be at least one")
    print(f"phase 13 took {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return dict(first=k1_first[0], k1=k1, bucket3=bucket3)


def int64_phase(aln, card: str, int32: bool = True) -> dict:
    """Phase 14: int64 positions on the card. A second aligner of the
    4.6 Mbp index, widened to int64, aligns phase 3's first timed batch
    (4096 x 100 bp) and phase 5's (2048 pairs): each SAM byte-equal to the
    int32 aligner's on the same batch and to the oracle's; K1 and K2
    launched; no rescue result missing. Without ``int32`` (the full call)
    the int32 aligner does not align the two batches again: phases 3 and
    5 held its SAM of them to the same oracle text, so the int64 SAM's
    equality with the oracle is its equality with the int32 SAM."""
    import torch
    from tpubwa_torch.io import fastx
    from tpubwa_torch.ops import sw_local
    from tpubwa_torch.tools.dryrun import widen
    t_phase = time.time()
    se = fastx.batch_reads(se_reads(aln.idx)[1], max_len=READ_LEN)
    pe = fastx.batch_reads(pe_reads(aln.idx)[1], max_len=PE_READ_LEN)
    t32 = {}
    runs32 = (("SE", lambda: aln.align_se(se, id0=BATCH)),
              ("PE", lambda: aln.align_pe(pe, id0=PE_PAIRS)))
    for name, fn in runs32 if int32 else ():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t32[name] = (fn(), time.perf_counter() - t0)
    aln64 = make_aligner()
    aln64.didx, aln64.lut = widen(aln64.didx, aln64.lut)
    if aln64.didx.pos_dtype != torch.int64:
        raise AssertionError("the widened index is not int64")
    lib = aln64.oracle._lib
    lib.tb_rescue_miss_reset()
    sw_local.ksw_local.launches = 0
    k1_first, k1_log, t = [], [], {}

    def run():
        for name, fn in (("SE", lambda: aln64.align_se(se, id0=BATCH)),
                         ("PE", lambda: aln64.align_pe(pe, id0=PE_PAIRS))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t[name] = (fn(), time.perf_counter() - t0)
        torch.cuda.synchronize()
    _, k1 = count_k1(run, k1_log, k1_first)
    k2 = sw_local.ksw_local.launches
    misses = lib.tb_rescue_miss_count()
    for name in t32:
        first_diff(t[name][0], t32[name][0], f"int64 {name} SAM against "
                   "the int32 aligner's")
    first_diff(t["SE"][0], aln.oracle.align_se(se, aln.opt, id0=BATCH),
               "int64 SE SAM against the oracle")
    first_diff(t["PE"][0], aln.oracle.align_pe(pe, aln.opt,
                                               id0=PE_PAIRS)[0],
               "int64 PE SAM against Oracle.align_pe")
    i32 = {k: f"int32 {t32[k][1]:.2f} s" if t32 else
           "int32: phases 3 and 5" for k in ("SE", "PE")}
    print(f"int64: index and LUT widened to {aln64.didx.pos_dtype}; SE "
          f"{se.n} x {READ_LEN} bp ({t['SE'][1]:.2f} s; {i32['SE']}) and PE "
          f"{pe.n // 2} pairs ({t['PE'][1]:.2f} s; {i32['PE']}) SAM "
          f"byte-equal to the int32 aligner's and to the oracle's; rescue "
          f"tasks "
          f"{aln64.stats.get('rescue_tasks', 0)}, results missing {misses}; "
          f"K1 launches {k1}, K2 launches {k2} [{card}]", flush=True)
    if misses or k1 <= 0 or k2 <= 0:
        raise AssertionError(f"int64: {misses} rescue results missing, K1 "
                             f"launched {k1} and K2 {k2} times")
    print_k1_shapes("int64", k1_log, "the SE and PE batch", card)
    print(f"phase 14 took {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return dict(first=k1_first[0], k1=k1, k2=k2)


def start_scale_prepare():
    """Build phase 15's 64 Mbp genome, index and LUT caches in a process
    of their own (host work only), so that the build overlaps the phases
    that run before it."""
    return subprocess.Popen(
        [sys.executable, "-m", "tpubwa_torch.tools.scale_bench",
         str(SCALE_READS), str(SCALE_MBP), "--prepare"], cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_bench_prepare():
    """Build the 4.6 Mbp bench world's index and LUT caches in a process
    of their own (host work only), beside phases 1-2 of the full call."""
    return subprocess.Popen(
        [sys.executable, "-c", "from tpubwa_torch.tools import "
         "bench_world; bench_world.prepare()"], cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_dryrun_prepare():
    """Build phase 20's 2 Mbp index and LUT caches in a process of their
    own (host work only), beside the phases before phase 15."""
    return subprocess.Popen(
        [sys.executable, "-m", "tpubwa_torch.tools.dryrun", "--prepare"],
        cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait_prepare(proc, what: str, card: str):
    """Wait for a cache-building process; raise if it failed."""
    t0 = time.time()
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the {what} process exited "
                             f"{proc.returncode}:\n{err[-3000:]}")
    last = out.strip().splitlines()[-1:] or ["no output"]
    print(f"{what}: caches built ({last[0]}), waited {time.time() - t0:.1f}"
          f" s for them [{card}]", flush=True)


def tier2_measure(aln, batch, card: str):
    """F7's number on a batch where tier 2 fires: the tier-2 call
    (dispatch and merge) alone. The stage split beside it times the
    tiers, the finish and the whole batch."""
    import torch
    buf = aln.worker1_packed(batch.seqs, batch.lens).cpu().numpy()
    n, ovf, l_rep, flat = aln._unpack_host(buf, batch.n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t2 = aln._tier2_dispatch(batch, ovf)
    if t2 is None:
        raise AssertionError("tier 2 does not fire on this batch")
    aln._tier2_merge(batch, n, ovf, l_rep, flat, t2)
    t_t2 = time.perf_counter() - t0
    print(f"tier 2: {len(t2[0])} of {batch.n} reads re-run, the tier-2 "
          f"call alone {t_t2 * 1e3:.1f} ms [{card}]", flush=True)


def gated_batch(aln, batches):
    """A batch on which tier 2 fires: every read that overflows tier 1 in
    the given batches, each followed by seven clean reads, so that the
    overflow reads are an eighth of the batch, above the gate's
    sixteenth."""
    from tpubwa_torch.io import fastx
    from tpubwa_torch.utils import dna
    ovf_recs, clean = [], []
    for b in batches:
        buf = aln.worker1_packed(b.seqs, b.lens).cpu().numpy()
        ovf = aln._unpack_host(buf, b.n)[1]
        for i in range(b.n):
            rec = fastx.FastxRecord(b.names[i],
                                    dna.decode(b.seqs[i][:b.lens[i]]))
            (ovf_recs if ovf[i] else clean).append(rec)
    recs = []
    for k, r in enumerate(ovf_recs):
        recs.append(r)
        recs += clean[7 * k:7 * k + 7]
    return fastx.batch_reads(recs, max_len=READ_LEN)


def scale_world(card: str, prep, phase: str):
    """The 64 Mbp genome and its aligner on the card, the caches built by
    ``prep`` (a running --prepare process, waited for here) or here;
    returns (genome, aligner, costs)."""
    from tpubwa_torch.tools import scale_bench as sb
    t0 = time.time()
    costs = {}
    if prep is not None:
        out, err = prep.communicate(timeout=900)
        if prep.returncode != 0:
            raise AssertionError(f"the 64 Mbp --prepare process exited "
                                 f"{prep.returncode}:\n{err[-3000:]}")
        costs.update(json.loads(out.strip().splitlines()[-1])["costs"])
        print(f"scale: the --prepare process built the caches "
              f"({costs}) and ended {time.time() - t0:.1f} s into "
              f"phase {phase} [{card}]", flush=True)
    g, idx = sb.prepare(SCALE_MBP, costs)
    return g, sb.make_aligner(idx, SCALE_MBP, costs, "cuda"), costs


def scale_phase(card: str, prep=None, n_reads: int = SCALE_READS,
                pe_pairs: int = SCALE_PE_PAIRS, split: bool = True) -> dict:
    """Phase 15: the 64 Mbp genome (chr20 size, BASELINE config 3) through
    tools/scale_bench: the genome, index and LUT from their caches (built
    by ``prep``, a running --prepare process, or here); a warm-up batch
    of 4096 SE reads and n_reads more timed and streamed, every line
    byte-equal to the oracle; the PE row (pe_pairs pairs, byte-equal to
    Oracle.align_pe, no rescue result missing); the tier-2 call's time
    and (with ``split``) a stage split on a batch where tier 2 fires,
    with tier 2 forced by a batch built for it when no timed batch opens
    its gate; K1 and K2 recorded on their first calls."""
    from tpubwa_torch.ops import sw_local
    from tpubwa_torch.pair import rescue
    from tpubwa_torch.tools import scale_bench as sb
    t_phase = time.time()
    g, aln, costs = scale_world(card, prep, "15")
    dbytes = sb.device_bytes(aln)
    print(f"scale: {SCALE_MBP} Mbp genome (text {2 * aln.idx.l_pac}, "
          f"{aln.didx.pos_dtype}), costs {costs}; device bytes: index "
          f"{dbytes['index']}, LUT {dbytes['lut']} [{card}]", flush=True)
    k1_first, k1_log = [], []
    (se, batches), _ = count_k1(lambda: sb.se_row(
        aln, g, n_reads, SCALE_MBP, costs), k1_log, k1_first)
    print(f"scale SE: {json.dumps(se)} [{card}]", flush=True)
    print_k1_shapes("scale", k1_log, f"the warm-up and the "
                    f"{len(batches)} timed batches", card)
    if se["parity_mismatches"] or se["parity_lines_checked"] < n_reads:
        raise AssertionError(f"scale SE: {se['parity_mismatches']} of "
                             f"{se['parity_lines_checked']} lines differ "
                             "from the oracle")
    if se["k1_launches"] <= 0:
        raise AssertionError("the scale SE path launched K1 no time")
    opened = {t["first_read"] for t in se["tier_batches"] if t["tier2"]}
    fired = [i for i, b in enumerate(batches) if b.names[0] in opened]
    if fired:
        b, id0 = batches[fired[0]], fired[0] * sb.BATCH
        tier2_measure(aln, b, card)
        if split:
            stages(aln, b, id0, card, "scale stage")
    else:
        gb = gated_batch(aln, batches)
        aln.TIER2_MIN = 1
        aln.stats = {"reads": 0, "fallback_reads": 0}
        sam = aln.align_se(gb, id0=0)
        first_diff(sam, aln.oracle.align_se(gb, aln.opt, id0=0),
                   "the tier-2 batch against the oracle")
        rows = aln.stats.get("tier2_rows", 0)
        print(f"scale: tier 2 did not fire on the timed batches; a batch "
              f"of {gb.n} reads built from their "
              f"{aln.stats.get('tier1_ovf', 0)} overflow reads ran {rows} "
              f"rows on tier 2, SAM byte-equal to the oracle [{card}]",
              flush=True)
        if not rows:
            raise AssertionError("tier 2 ran on the card no time")
        tier2_measure(aln, gb, card)
        del aln.TIER2_MIN
    # the PE row, K2's first forward call recorded and the forward
    # launches of each rescue call counted (the timed batch's is the last)
    k2_first, k2_fwd = {}, []
    real = rescue.ksw_local

    def recorder(*args, want_sub, **kw):
        if want_sub not in k2_first:
            k2_first[want_sub] = tuple(a.clone() for a in args)
        before = sw_local.ksw_local.launches
        r = real(*args, want_sub=want_sub, **kw)
        if want_sub:
            k2_fwd.append(sw_local.ksw_local.launches - before)
        return r
    rescue.ksw_local = recorder
    try:
        pe = sb.pe_row(aln, g, SCALE_MBP, pe_pairs)
    finally:
        rescue.ksw_local = real
    print(f"scale PE: {json.dumps(pe)} [{card}]", flush=True)
    if pe["parity_mismatches"] or pe["rescue_results_missing"]:
        raise AssertionError(f"scale PE: {pe['parity_mismatches']} lines "
                             f"differ from Oracle.align_pe, "
                             f"{pe['rescue_results_missing']} rescue "
                             "results missing")
    if pe["k1_launches"] <= 0 or pe["k2_launches"] <= 0 or \
            not pe["rescue_tasks"] or not k2_fwd[-1]:
        raise AssertionError("the scale PE row's timed batch launched K1 or "
                             "K2 no time")
    print(f"phase 15 took {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return dict(first=k1_first[0], k1=se["k1_launches"],
                k2_first=k2_first[True], k2=k2_fwd[-1], se=se, pe=pe,
                aln=aln, g=g)


CLASSIFY_FAST_READS = 2048   # phase 16: the oracle's counts, SMEMs + seeds
CLASSIFY_FULL_READS = 256    # ... and with chains and regions
ORACLE_SAMPLE = 512          # most reads the oracle's ms a read is taken on
TUNE_REPS = 3                # tune_budgets: best of 3 steady worker1 calls
FULL_CALL_TUNE_REPS = 1      # ... at 4.6 Mbp in the full call (cut)
# tune_budgets at 4.6 Mbp in the full call (cut from the seven of the
# diag call for time): the base and each dense budget of the LUT walk
# doubled (fm_dense 16 -> 8, offdiag_dense 8 -> 4)
FULL_CALL_VARIANTS = ({}, {"fm_dense": 8})
# tune_budgets at 64 Mbp: each dense budget of the LUT walk relaxed 2x
SCALE_VARIANTS = ({}, {"fm_dense": 8}, {"offdiag_dense": 2},
                  {"fm_dense": 8, "offdiag_dense": 2})
FULL_CALL_SCALE_VARIANTS = SCALE_VARIANTS[:2]   # ... in the full call


def check_cumulative(counts: dict, what: str):
    """Fail unless each stage's cumulative overflow count is at least the
    one before it (the dict is in stage order)."""
    v = list(counts.values())
    if any(b < a for a, b in zip(v, v[1:])):
        raise AssertionError(f"{what}: a cumulative overflow count "
                             f"decreases: {counts}")


def no_reference_imported(what: str):
    bad = sorted(m for m in sys.modules if m in ("jax", "tpubwa") or
                 m.startswith(("jax.", "jaxlib", "tpubwa.")))
    if bad:
        raise AssertionError(f"{what} imported {bad[:8]}")


def rows_batch(batch, rows):
    """The reads ``rows`` of ``batch`` as a ReadBatch of their own."""
    from tpubwa_torch.io.fastx import ReadBatch
    return ReadBatch(seqs=batch.seqs[rows], lens=batch.lens[rows],
                     names=[batch.names[i] for i in rows],
                     quals=[batch.quals[i] for i in rows])


def oracle_ms(aln, batch, rows) -> tuple:
    """(reads, ms a read) of Oracle.align_se on one thread over at most
    ORACLE_SAMPLE of ``rows``, evenly spaced."""
    rows = rows[::-(-len(rows) // ORACLE_SAMPLE) or 1]
    if not len(rows):
        return 0, None
    sub = rows_batch(batch, rows)
    t0 = time.perf_counter()
    aln.oracle.align_se(sub, aln.opt)
    return len(rows), (time.perf_counter() - t0) * 1e3 / len(rows)


def diag_bench(aln, card: str, variants=None, reps: int = TUNE_REPS) \
        -> dict:
    """Phase 16 at 4.6 Mbp: diag_caps and tune_budgets' ``variants`` (the
    base first; the seven of its default sweep when None; best of
    ``reps``) on the bench batch of 4096 reads, at the default caps."""
    from tpubwa_torch.tools import bench_world, diag_caps, tune_budgets
    batch = bench_world.reads(aln.idx, BATCH)
    caps = diag_caps.diag_caps(aln, batch)
    diag_caps.report(caps)
    print(f"diag_caps: {json.dumps(caps)} [{card}]", flush=True)
    check_cumulative(caps["overflow"], "diag_caps")
    tune = tune_budgets.tune_budgets(
        aln, batch, variants or tune_budgets.DEFAULT_VARIANTS, reps=reps)
    for row in tune["variants"]:
        print(f"tune_budgets {row['variant']:32s} w1={row['w1_ms']:7.1f} ms "
              f"(first {row['first_ms']:.1f} ms) ovf={row['overflow']:5d}/"
              f"{batch.n}", flush=True)
    print(f"tune_budgets: {json.dumps(tune)} [{card}]", flush=True)
    base = tune["variants"][0]
    if base["variant"] != "base" or \
            base["overflow"] != caps["overflow"]["extend"]:
        raise AssertionError(f"tune_budgets' base variant flags "
                             f"{base['overflow']} reads, diag_caps "
                             f"{caps['overflow']['extend']} on the same "
                             "batch")
    return dict(caps=caps, tune=tune)


def diag_scale_world(aln, g, card: str, variants=SCALE_VARIANTS,
                     steady: bool = True) -> dict:
    """Phase 16 at 64 Mbp: diag_scale and diag_tier2 on 4096 reads,
    classify_overflow on the first 2048 (fast) and every 16th read (full),
    the split of seeding overflow into cap- and dense-budget-driven reads
    at tier 1 and tier 2, worker1 with each dense budget relaxed, and the
    oracle's ms a read on the reads tier 1 flagged, on tier 3's input and
    on those the tiers left, beside the tiers' times (diag_tier2's steady
    run; its first run without ``steady``)."""
    import numpy as np
    from tpubwa_torch.tools import classify_overflow as co
    from tpubwa_torch.tools import diag_caps, diag_scale, diag_tier2
    from tpubwa_torch.tools import scale_bench as sb
    from tpubwa_torch.tools import tune_budgets
    batch = sb.se_batch(g, sb.BATCH)
    ds = diag_scale.diag_scale(aln, batch)
    diag_scale.report(ds)
    print(f"diag_scale: {json.dumps(ds)} [{card}]", flush=True)
    check_cumulative(ds["overflow"], "diag_scale")
    if ds["stage_not_packed"]:
        raise AssertionError(f"{ds['stage_not_packed']} reads the stages "
                             "flag are not flagged in worker1_packed's "
                             "buffer")
    dt = diag_tier2.diag_tier2(aln, batch, steady)
    diag_tier2.report(dt)
    print(f"diag_tier2: {json.dumps(dt)} [{card}]", flush=True)
    for key in ("tier2_config", "script_config"):
        if key in dt:
            check_cumulative(dt[key]["overflow"], f"diag_tier2 {key}")
    # per read: seeding overflow at tier 1, the packed buffer's overflow
    f1 = diag_caps.stage_flags(aln, batch.seqs, batch.lens)
    ovf1 = aln._unpack_host(aln.worker1_packed(
        batch.seqs, batch.lens).cpu().numpy(), batch.n)[1]
    if (f1["extend"] & ~ovf1).any():
        raise AssertionError("a read the stages flag is not flagged in "
                             "worker1_packed's buffer")
    # the oracle's counts: SMEMs and seeds of every read (the classify line
    # on the first 2048, as the reference script takes them), and with
    # chains and regions of every 16th read
    t0 = time.perf_counter()
    fast = co.oracle_counts(aln.oracle, batch, aln.opt, True)
    ms_fast = (time.perf_counter() - t0) * 1e3 / batch.n
    stride = batch.n // CLASSIFY_FULL_READS
    every = np.arange(0, batch.n, stride)
    t0 = time.perf_counter()
    full = co.oracle_counts(aln.oracle, rows_batch(batch, every), aln.opt,
                            False)
    ms_full = (time.perf_counter() - t0) * 1e3 / len(every)
    for counts, is_fast, ms, what in (
            (fast[:CLASSIFY_FAST_READS], True, ms_fast,
             f"the first {CLASSIFY_FAST_READS} reads"),
            (full, False, ms_full, f"every {stride}th read")):
        r = {**co.classify(counts, SCALE_MBP), "fast": is_fast,
             "oracle_count_ms_per_read": ms, "reads": what}
        print(f"classify_overflow: {json.dumps(r)} [{card}]", flush=True)
    # seeding overflow under tier 2's configuration, on the rows tier 2
    # re-runs (the tier-1 overflow reads, padded as tier 2 pads them)
    rows1 = np.flatnonzero(ovf1)
    pad = (-len(rows1)) % aln.TIER2_ROWS
    rsel = np.concatenate([rows1, np.repeat(rows1[-1:], pad)])
    seeded2 = np.zeros(batch.n, bool)
    seeded2[rows1] = diag_caps.stage_flags(
        aln, batch.seqs[rsel], batch.lens[rsel],
        aln._tier_configs(2)[:3])["seeding"][:len(rows1)]
    on1 = np.zeros(batch.n, bool)
    on1[rows1] = True
    q = batch.n // 4
    split = {"genome_mbp": SCALE_MBP, "reads": batch.n,
             # the dense budgets are filled in read order: reads late in
             # a batch overflow once a budget is spent
             "seeding_by_quarter": [int(f1["seeding"][k * q:(k + 1) * q]
                                        .sum()) for k in range(4)],
             "tier1": co.split(f1["seeding"], fast, co.T1),
             "tier2": co.split(seeded2[on1], fast[on1], co.T2),
             "tier1_full": co.split(f1["seeding"][every], full, co.T1),
             "tier2_full": co.split(seeded2[every][on1[every]],
                                    full[on1[every]], co.T2)}
    print(f"diag split at {SCALE_MBP} Mbp: {json.dumps(split)} [{card}]",
          flush=True)
    # which dense budget: worker1 with each relaxed (budgets are B*L //
    # fm_dense and B*L // offdiag_dense lanes)
    tune = tune_budgets.tune_budgets(aln, batch, variants, reps=1)
    for row in tune["variants"]:
        print(f"tune_budgets {SCALE_MBP} Mbp {row['variant']:24s} "
              f"w1={row['w1_ms']:7.1f} ms ovf={row['overflow']:5d}/"
              f"{batch.n}", flush=True)
    print(f"tune_budgets at {SCALE_MBP} Mbp: {json.dumps(tune)} [{card}]",
          flush=True)
    clean = np.flatnonzero(~ovf1)
    orc = {}
    for what, rows in (("tier1_overflow", rows1),
                       ("after_tier2", np.asarray(dt["after_tier2_rows"])),
                       ("left_by_tiers", np.asarray(dt["left_rows"])),
                       ("clean", clean)):
        n, ms = oracle_ms(aln, batch, rows)
        orc[what] = {"reads": n, "of": len(rows), "ms_per_read": ms}
    calls = dt.get("steady", dt["first"])
    orc["tier_calls_run"] = "steady" if "steady" in dt else "first"
    orc["tier2_call_ms"] = calls["tier2_s"] * 1e3
    orc["tier3_call_ms"] = calls["tier3_s"] * 1e3
    orc["tier2_rows"] = int(ovf1.sum()) if dt["tier2_fired"] else 0
    orc["tier3_rows"] = dt["after_tier2"] \
        if dt["after_tier2"] >= aln.TIER3_MIN else 0
    print(f"diag oracle at {SCALE_MBP} Mbp (one thread): {json.dumps(orc)} "
          f"[{card}]", flush=True)
    return dict(scale=ds, tier2=dt, split=split, oracle=orc, tune=tune)


def diag_phase(aln, aln64, g, card: str, variants=None,
               scale_variants=SCALE_VARIANTS, reps: int = TUNE_REPS,
               steady: bool = True) -> dict:
    """Phase 16: the overflow diagnostics (tools/diag_*.py,
    classify_overflow.py, tune_budgets.py) at 4.6 and 64 Mbp, K1's
    launches counted from 0 and its first call recorded; tune_budgets
    runs ``variants`` at 4.6 Mbp (best of ``reps``), ``scale_variants``
    at 64 Mbp; diag_tier2's steady run only with ``steady``."""
    t_phase = time.time()
    first, log = [], []
    (bench, scale), k1 = count_k1(lambda: (
        diag_bench(aln, card, variants, reps),
        diag_scale_world(aln64, g, card, scale_variants, steady)), log,
        first)
    no_reference_imported("phase 16's tools")
    print(f"phase 16: K1 launched {k1} times [{card}]", flush=True)
    if k1 <= 0:
        raise AssertionError("phase 16 launched K1 no time")
    print_k1_shapes("diag", log, "phase 16", card)
    print(f"phase 16 took {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return dict(first=first[0], k1=k1, bench=bench, scale=scale)


PROFILE_REPS = 3        # phase 17: profile_phases', time_stages' and
                        # time_extend's reps
FULL_CALL_REPS = 1      # ... in the full call (cut for time)
PARITY_READS = 2048     # phase 17: parity's SE reads (2% / 0.2% errors)
FULL_CALL_PE_PAIRS = 256   # profile_pe's pairs in the full call (cut)
FULL_CALL_PARITY_READS = 512   # parity's reads in the full call (cut)
FULL_CALL_PROFILE_READS = 512   # the other tools' reads in the full call
REHEARSAL_PAIRS = 768   # phase 18: run_1m's pairs at 64 Mbp (cut from 3072)
REHEARSAL_BATCH = 512   # ... and its --batch-size (256 pairs a batch)


def tool_line(name: str, r: dict, card: str):
    """A tool's JSON line with the card, without its SAM texts."""
    keep = {k: v for k, v in r.items() if k not in ("sam_1t", "sam_2t")}
    print(f"{name}: {json.dumps(keep)} [{card}]", flush=True)


def profile_tools(aln, card: str, reps: int, pe_pairs: int,
                  round_engine: bool = True,
                  parity_reads: int = PARITY_READS, n: int = BATCH) -> dict:
    """Phase 17's tools on the 4.6 Mbp bench world (profile_phases,
    time_stages, time_extend and profile_finish on n bench reads;
    profile_pe on batches of pe_pairs pairs; time_extend's round-engine
    rows only with ``round_engine``; parity on parity_reads reads);
    returns K1's first kernel-row inputs and K2's first forward call's."""
    from tpubwa_torch.pair import rescue
    from tpubwa_torch.tools import (bench_world, parity, profile_finish,
                                    profile_pe, profile_phases, time_extend,
                                    time_stages)
    batch = bench_world.reads(aln.idx, n)
    r = profile_phases.profile_phases(aln, batch, reps=reps)
    profile_phases.report(r)
    tool_line("profile_phases", r, card)
    r = time_stages.time_stages(aln, n, reps=reps)
    time_stages.report(r)
    tool_line("time_stages", r, card)
    k1_args = []
    for engine in (False, True)[:1 + round_engine]:
        r = time_extend.time_extend(aln, n, engine,
                                    reps=reps, record=k1_args)
        time_extend.report(r)
        tool_line(f"time_extend ({r['engine']})", r, card)
    r = profile_finish.profile_finish(aln, batch)
    profile_finish.report(r)
    tool_line("profile_finish", r, card)
    # the uncut walk and extension (worker1_packed) against the oracle: the
    # cuts leave the path alone
    first_diff(r["sam_1t"], aln.oracle.align_se(batch, aln.opt, id0=0),
               "profile_finish's 1-thread SAM against Oracle.align_se")
    print(f"profile_finish: the 1-thread SAM of the bench batch is "
          f"byte-equal to Oracle.align_se [{card}]", flush=True)
    k2_first = []
    real = rescue.ksw_local

    def recorder(*args, want_sub, **kw):
        if want_sub and not k2_first:
            k2_first.append(tuple(a.clone() for a in args))
        return real(*args, want_sub=want_sub, **kw)
    rescue.ksw_local = recorder
    try:
        r = profile_pe.profile_pe(aln, pe_pairs)
    finally:
        rescue.ksw_local = real
    profile_pe.report(r)
    tool_line("profile_pe", r, card)
    if r["rescue_results_missing"] or not r["n_rescue_tasks"]:
        raise AssertionError(f"profile_pe: {r['rescue_results_missing']} "
                             f"rescue results missing of "
                             f"{r['n_rescue_tasks']} tasks")
    r = parity.parity(aln, parity_reads)
    parity.report(r)
    tool_line("parity", r, card)
    if r["differ"]:
        raise AssertionError(f"parity: {r['differ']} of {r['records']} "
                             "records differ from the oracle")
    return dict(k1_args=k1_args[0], k2_first=k2_first[0])


def profile_phase(aln, card: str, reps: int = PROFILE_REPS,
                  pe_pairs: int = PE_PAIRS, round_engine: bool = True,
                  parity_reads: int = PARITY_READS, n: int = BATCH) -> dict:
    """Phase 17: the profiling tools (on n bench reads) and the parity
    spot check (on parity_reads reads) on the 4.6 Mbp bench world, K1's
    and K2's launches counted from 0; profile_phases, time_stages and
    time_extend take the best of ``reps``; time_extend's round-engine rows
    run with ``round_engine``."""
    from tpubwa_torch.ops import sw_local
    t_phase = time.time()
    sw_local.ksw_local.launches = 0
    out, k1 = count_k1(lambda: profile_tools(aln, card, reps, pe_pairs,
                                             round_engine, parity_reads, n),
                       [])
    k2 = sw_local.ksw_local.launches
    no_reference_imported("phase 17's tools")
    print(f"phase 17: K1 launched {k1} times, K2 {k2} times [{card}]",
          flush=True)
    if k1 <= 0 or k2 <= 0:
        raise AssertionError("phase 17 launched K1 or K2 no time")
    print(f"phase 17 took {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return dict(out, k1=k1, k2=k2)


def rehearsal_phase(aln64, card: str) -> dict:
    """Phase 18: tools/run_1m.py on the 64 Mbp caches: PE pairs through
    the command line, killed after the second batch line and resumed;
    the merged file byte-equal to the header + Oracle.align_pe, batch by
    batch (each batch has its own insert histogram)."""
    from tpubwa_torch.io import fastx
    from tpubwa_torch.tools import run_1m
    t_phase = time.time()
    out = run_1m.run_1m(REHEARSAL_PAIRS, 0.0, SCALE_MBP, REHEARSAL_BATCH,
                        "cuda")
    print(f"run_1m: {json.dumps(out)} [{card}]", flush=True)
    if not (out["phase1_killed"] and out["resume_skipped_done"]):
        raise AssertionError("run_1m: the run was not killed, or the "
                             "resume began at batch 0")
    if out["phase2_rc"] != 0 or not out["records_ok"]:
        raise AssertionError(f"run_1m: the resume exited "
                             f"{out['phase2_rc']}, {out['total_records']} "
                             f"records merged for {REHEARSAL_PAIRS} pairs")
    work = Path(out["work"])
    pe = [r for m in zip(fastx.iter_fastq(work / "r_1.fq"),
                         fastx.iter_fastq(work / "r_2.fq")) for r in m]
    t0 = time.time()
    want = aln64.sam_header() + "".join(aln64.oracle.align_pe(
        fastx.batch_reads(pe[i:i + REHEARSAL_BATCH], max_len=PE_READ_LEN),
        aln64.opt, id0=i // 2)[0] for i in range(0, len(pe),
                                                 REHEARSAL_BATCH))
    first_diff((work / "merged.sam").read_text(), want, "the rehearsal's "
               "merged shards against the header + Oracle.align_pe")
    print(f"rehearsal: {REHEARSAL_PAIRS} pairs at {SCALE_MBP} Mbp, killed "
          f"after {out['phase1_batches']} batch lines, resumed at batch "
          f"{out['phase2_first_batch']}; {out['total_records']} merged "
          f"records byte-equal to the header + Oracle.align_pe (oracle "
          f"{time.time() - t0:.1f} s); phase 18 took "
          f"{time.time() - t_phase:.1f} s [{card}]", flush=True)
    return out


# the keys of the line bench.py prints (bench.py:118-131)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "workload",
              "fallback_pct", "phase_s_per_batch", "device_busy_pct",
              "pe_150bp_reads_per_s", "pe_fallback_pct", "setup_s")
FULL_CALL_BENCH_TIMED = 1   # phase 19's timed SE batches in the full call
FULL_CALL_BENCH_BATCH = 2048   # ... and their reads (TPUBWA_BENCH_BATCH)
DRYRUN_DEVICES = 8          # phase 20's mesh (the reference's __main__)
FULL_CALL_LOAD_PER_DEV = 256   # phase 20's LOAD test in the full call (cut
                               # from the tool's 1024 reads an entry; 512
                               # before phase 27)


def bench_phase(card: str, timed: int = None, batch: int = None) -> dict:
    """Phase 19: `python3 bench_torch.py` in a subprocess, as a user runs
    it, with TPUBWA_BENCH_TIMED=timed and TPUBWA_BENCH_BATCH=batch
    (bench.py's 8 and 4096 when None). Fails
    unless its last line has every key of bench.py's line, both rates are
    above 0 and its card is this card, or if a kernel of its timed runs
    (K1 SE and PE, K2 PE) launched no time."""
    import torch
    t_phase = time.time()
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env.pop("TPUBWA_BENCH_BATCH", None)
    env.pop("TPUBWA_BENCH_TIMED", None)
    if timed is not None:
        env["TPUBWA_BENCH_TIMED"] = str(timed)
    if batch is not None:
        env["TPUBWA_BENCH_BATCH"] = str(batch)
    r = subprocess.run([sys.executable, "bench_torch.py"], cwd=str(REPO),
                       env=env, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {r.returncode}:\n"
                             f"{r.stderr[-3000:]}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    missing = [k for k in BENCH_KEYS if k not in line]
    if missing:
        raise AssertionError(f"bench_torch.py's line lacks {missing}")
    if not (line["value"] > 0 and line["pe_150bp_reads_per_s"] > 0):
        raise AssertionError(f"bench_torch.py's rates: {line['value']} SE, "
                             f"{line['pe_150bp_reads_per_s']} PE")
    if line.get("card") != card:
        raise AssertionError(f"bench_torch.py ran on {line.get('card')!r}, "
                             f"not on {card!r}")
    m = re.search(r"SE ksw_extend (\d+); PE ksw_extend (\d+), ksw_local "
                  r"(\d+)", r.stderr)
    if not m or min(int(x) for x in m.groups()) <= 0:
        raise AssertionError("bench_torch.py's timed runs launched a "
                             f"kernel no time: {m and m.group(0)}")
    for err in r.stderr.splitlines():
        if err.startswith("# "):
            print(f"bench: {err[2:]}", flush=True)
    print(f"bench: {json.dumps(line)}", flush=True)
    print(f"phase 19 took {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return dict(line=line, launches=tuple(int(x) for x in m.groups()))


def dryrun_phase(card: str, load_per_dev: int = None) -> dict:
    """Phase 20: tools/dryrun.py on the card. entry() with n >= 1 on every
    read; dryrun_multichip(8) with the LOAD test, which raises on any of
    the reference's asserts; its first mesh call (the int64 tiny world)
    held to worker1_step on the blocks and, on every read that overflows
    in neither run, on the whole batch, and the LOAD test's mesh run to its
    one-device run on the whole batch, on those reads (tolerance 0); the
    file it wrote holds what it returned. Records K1's first call. With
    ``load_per_dev`` the LOAD test runs that many reads an entry in place
    of dryrun.LOAD_PER_DEV."""
    import torch
    from tpubwa_torch.tools import dryrun
    t_phase = time.time()
    per_dev = dryrun.LOAD_PER_DEV
    fn, args = dryrun.entry("cuda")
    score, n = fn(*args)
    torch.cuda.synchronize()
    if not bool((n >= 1).all()):
        raise AssertionError(f"dryrun entry(): region counts {n.tolist()}")
    print(f"dryrun: entry() on {n.numel()} reads: every read has a region "
          f"(n = {n.tolist()}), scores {score[:, 0].tolist()} [{card}]",
          flush=True)

    calls = []
    real = dryrun.worker1_sharded

    def recorder(mesh, didx, seqs, lens, scfg, ccfg, ecfg, lut=None):
        out = real(mesh, didx, seqs, lens, scfg, ccfg, ecfg, lut)
        calls.append((mesh, didx, seqs, lens, lut,
                      dict(scfg=scfg, ccfg=ccfg, ecfg=ecfg), out))
        return out
    path = REPO / "build" / "tpubwa_torch" / "SCALING_torch.json"
    load = os.environ.get("TPUBWA_DRYRUN_LOAD")
    os.environ["TPUBWA_DRYRUN_LOAD"] = "1"
    dryrun.worker1_sharded = recorder
    dryrun.LOAD_PER_DEV = load_per_dev or per_dev
    k1_first, k1_log = [], []
    try:
        scaling, k1 = count_k1(lambda: dryrun.dryrun_multichip(
            DRYRUN_DEVICES, "cuda", out=path), k1_log, k1_first)
        nb = dryrun.LOAD_PER_DEV * DRYRUN_DEVICES
    finally:
        dryrun.worker1_sharded = real
        dryrun.LOAD_PER_DEV = per_dev
        if load is None:
            os.environ.pop("TPUBWA_DRYRUN_LOAD")
        else:
            os.environ["TPUBWA_DRYRUN_LOAD"] = load
    if json.loads(path.read_text()) != scaling:
        raise AssertionError(f"{path} does not hold what dryrun returned")
    if k1 <= 0:
        raise AssertionError("dryrun_multichip launched K1 no time")
    mesh, didx, seqs, lens, lut, cfg, out = calls[0]
    if didx.pos_dtype != torch.int64 or mesh.size != DRYRUN_DEVICES:
        raise AssertionError(f"dryrun's first call: {mesh.size} entries, "
                             f"{didx.pos_dtype}")
    whole = dryrun.worker1_step(didx, seqs, lens, lut, **cfg)
    blocks = step_on_blocks(didx, seqs, lens, lut, cfg, mesh.size)
    print(f"dryrun: worker1_sharded over {mesh.size} entries on "
          f"{len(set(mesh.devices))} card(s), int64 tiny world of "
          f"{seqs.shape[0]} reads: "
          f"{held_to_whole(out, blocks, whole, 'the dry run')} [{card}]",
          flush=True)
    load_runs = {m.size: o for m, _, s, _, _, _, o in calls
                 if s.shape[0] == nb}
    if set(load_runs) != {1, DRYRUN_DEVICES}:
        raise AssertionError(f"the LOAD test ran meshes of {set(load_runs)}")
    held = held_to_whole(load_runs[DRYRUN_DEVICES], None, load_runs[1],
                         "the LOAD test")
    print(f"dryrun: LOAD test, {nb} reads over {DRYRUN_DEVICES} entries "
          f"against one: {held} [{card}]", flush=True)
    print(f"dryrun: {json.dumps(scaling)}", flush=True)
    print(f"dryrun: K1 launched {k1} times; phase 20 took "
          f"{time.time() - t_phase:.1f} s [{card}]", flush=True)
    return dict(first=k1_first[0], k1=k1, scaling=scaling)


def dryrun_entry(dry, card: str) -> tuple:
    """Phase 6 for phase 20: K1 on the dry run's first call."""
    return k1_entry("ksw_extend_dryrun", f"worker1 over {DRYRUN_DEVICES} "
                    "mesh entries, int64 tiny world and the 2 Mbp LOAD test "
                    "(phase 20)", dry["first"], dry["k1"], card)


def profile_entries(prof, card: str) -> list:
    """Phase 6 for phase 17: K1 on time_extend's kernel-row input and K2
    on profile_pe's first forward call, each held to its plain version."""
    return [k1_entry("ksw_extend_profile", "time_extend's K1 kernel x1 "
                     "row (phase 17)", prof["k1_args"], prof["k1"], card),
            k2_entry("ksw_local_profile", "PE rescue, forward pass, "
                     "profile_pe (phase 17)", prof["k2_first"], prof["k2"],
                     card)]


STREAM_WINDOWS = (1, 2, 8)   # phases 21-22's windows of timed batches
STREAM_REPS = 3              # ... each variant's runs of a window, in turns
STREAM_VARIANTS = {          # phase 21 (SE): a-d; phase 22 (PE): pa, pb
    "a": "align_se_stream (one thread, the reference's order)",
    "b": "threaded stream (the finish on one worker thread)",
    "c": "align_se loop",
    "d": "stages in turn (_dispatch_se + sync, then the finish)",
    "pa": "align_pe_stream (one thread, the reference's order)",
    "pb": "stages in turn (worker1_packed + sync, then _finish_pe_buf)",
}
PE_STREAM_VARIANTS = ("pa", "pb")


def threaded_stream(aln, batches, id0: int, depth: int = 2):
    """The SE stream's former order, kept here only to be timed beside
    align_se_stream: each batch's finish (the download, tiers 2 and 3,
    the native finish) runs on one worker thread while the calling thread
    dispatches the next batch's worker1; up to ``depth`` batches are in
    flight."""
    import concurrent.futures as cf
    pending, n = [], id0
    with cf.ThreadPoolExecutor(max_workers=1) as ex:
        for b in batches:
            parts = aln._dispatch_se(b)
            pending.append(ex.submit(aln._finish_se_dispatched, b, parts, n))
            n += b.n
            if len(pending) >= depth:
                yield pending.pop(0).result()
        for fut in pending:
            yield fut.result()


def stream_variant(aln, v: str, batches, id0: int, split: list) -> list:
    """Variant ``v`` of STREAM_VARIANTS over the batches (id0 counts reads
    for SE, pairs for PE); returns the SAM texts. The stages in turn (d,
    pb) append each batch's (worker1 s, finish s) to ``split``."""
    import torch
    if v == "a":
        return list(aln.align_se_stream(batches, id0=id0))
    if v == "pa":
        return list(aln.align_pe_stream(batches, id0=id0))
    if v == "b":
        return list(threaded_stream(aln, batches, id0))
    out, n = [], id0
    for b in batches:
        if v == "c":
            out.append(aln.align_se(b, id0=n))
        else:
            t0 = time.perf_counter()
            if v == "d":
                parts = aln._dispatch_se(b)
                finish = lambda: aln._finish_se_dispatched(b, parts, n)  # noqa
            else:
                buf = aln.worker1_packed(b.seqs, b.lens)
                finish = lambda: aln._finish_pe_buf(  # noqa: E731
                    b, buf.cpu().numpy(), n)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out.append(finish())
            torch.cuda.synchronize()
            split.append((t1 - t0, time.perf_counter() - t1))
        n += b.n // 2 if v == "pb" else b.n
    return out


def spread(xs: list) -> str:
    """median [min, max] of the values."""
    import statistics
    return f"{statistics.median(xs):.4f} [{min(xs):.4f}, {max(xs):.4f}]"


def stream_phase(aln, batches, wants, id0: int, card: str, windows,
                 reps: int, variants="abcd", phase: str = "21") -> dict:
    """Phase 21 (SE) or 22 (PE): a stream against other orders and against
    its stages, on the same batches in the same call. For each window of
    w timed batches (the first w of ``batches``, whose oracle SAMs are
    ``wants``), ``reps`` rounds of the variants in turns (a b c d, a b c
    d, ...), each between two synchronizes; every variant's SAM must be
    byte-equal to the oracle's, and a PE variant's run must miss no
    rescue result. Prints the card's reserved memory before the runs,
    and per variant and window the seconds a batch and the reads/s
    (median [min, max]) and the reserved memory after the runs; for the
    stages in turn also worker1's and the finish's seconds a batch.
    Returns {(variant, window): [s a batch, ...]}."""
    import torch
    if len(batches) < max(windows):
        raise AssertionError(f"phase {phase}: {len(batches)} batches for "
                             f"a window of {max(windows)}")
    t_phase = time.time()
    lib = aln.oracle._lib
    print(f"phase {phase}: reserved {torch.cuda.memory_reserved() / 2**20:.0f}"
          f" MiB before the runs [{card}]", flush=True)
    secs, mem, splits = {}, {}, {}
    for w in windows:
        for _ in range(reps):
            for v in variants:
                split = splits.setdefault((v, w), [])
                what = f"phase {phase} variant {v}, window {w}"
                lib.tb_rescue_miss_reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sams = stream_variant(aln, v, batches[:w], id0, split)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                check_stream(sams, wants[:w], what)
                misses = lib.tb_rescue_miss_count()
                if misses:
                    raise AssertionError(f"{what}: {misses} rescue windows "
                                         "were missing from the injected "
                                         "device results")
                secs.setdefault((v, w), []).append(dt / w)
                mem.setdefault((v, w), []).append(
                    torch.cuda.memory_reserved())
    n = batches[0].n
    for w in windows:
        for v in variants:
            s = secs[(v, w)]
            print(f"stream {v} window {w}: {spread(s)} s a batch, "
                  f"{spread([n / x for x in s])} reads/s over {len(s)} "
                  f"runs of {w} x {n} reads, SAM byte-equal; reserved "
                  f"{min(mem[(v, w)]) / 2**20:.0f}-"
                  f"{max(mem[(v, w)]) / 2**20:.0f} MiB; "
                  f"{STREAM_VARIANTS[v]} [{card}]", flush=True)
            sp = splits[(v, w)]
            if sp:
                print(f"stream {v} window {w}: worker1 "
                      f"{spread([a for a, _ in sp])} s, finish "
                      f"{spread([b for _, b in sp])} s a batch over "
                      f"{len(sp)} batches [{card}]", flush=True)
    print(f"phase {phase} took {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return secs


def bench_stream_phase(card: str) -> dict:
    """Phase 21 in the bench call: the bench world's SE batches as phase
    3 and bench_torch.py make them (4096 x 100 bp, seed 7), one warm-up
    batch through align_se, then every variant over windows of 1, 2 and
    8 timed batches, 3 runs each in turns."""
    import numpy as np
    from tpubwa_torch.io import fastx
    aln = make_aligner()
    fwd = aln.idx.get_seq(0, aln.idx.l_pac).astype(np.uint8)
    w = max(STREAM_WINDOWS)
    n_reads = BATCH * (w + 1)
    recs = fastx.simulate_reads(fwd, n_reads, read_len=READ_LEN,
                                error_rate=0.01, indel_rate=0.001, seed=7)
    batches = [fastx.batch_reads(recs[i:i + BATCH], max_len=READ_LEN)
               for i in range(0, n_reads, BATCH)]
    check_stream([aln.align_se(batches[0], id0=0)],
                 [aln.oracle.align_se(batches[0], aln.opt, id0=0)],
                 "phase 21 warm-up")
    wants = [aln.oracle.align_se(b, aln.opt, id0=BATCH * (k + 1))
             for k, b in enumerate(batches[1:])]
    return stream_phase(aln, batches[1:], wants, BATCH, card,
                        STREAM_WINDOWS, STREAM_REPS)


def pe_window_phase(card: str) -> dict:
    """Phase 22 (the pe_window call): the PE stream by window. The bench
    world's PE batches as bench_torch.py makes them (2048 pairs of 150 bp,
    inserts 400 +- 50, seed 11; its six batches are the first six here),
    one warm-up batch through align_pe, then align_pe_stream (pa) and
    worker1_packed + sync, then _finish_pe_buf, a batch in turn (pb), over
    windows of 1, 2 and 8 timed batches, 3 runs each in turns; every SAM
    byte-equal to Oracle.align_pe (computed once a batch), no rescue
    result missing, K1 and K2 launched in the timed runs."""
    import numpy as np
    from tpubwa_torch.io import fastx
    from tpubwa_torch.ops import sw, sw_local
    aln = make_aligner()
    fwd = aln.idx.get_seq(0, aln.idx.l_pac).astype(np.uint8)
    n_pairs = PE_PAIRS * (max(STREAM_WINDOWS) + 1)
    recs = fastx.simulate_reads(fwd, n_pairs, read_len=PE_READ_LEN,
                                error_rate=0.01, indel_rate=0.001, seed=11,
                                paired=True, insert_mean=400, insert_std=50)
    batches = [fastx.batch_reads(recs[i:i + 2 * PE_PAIRS],
                                 max_len=PE_READ_LEN)
               for i in range(0, 2 * n_pairs, 2 * PE_PAIRS)]
    t0 = time.time()
    wants = [aln.oracle.align_pe(b, aln.opt, id0=PE_PAIRS * k)[0]
             for k, b in enumerate(batches)]
    print(f"phase 22: Oracle.align_pe of {len(batches)} batches in "
          f"{time.time() - t0:.1f} s", flush=True)
    check_stream([aln.align_pe(batches[0], id0=0)], wants[:1],
                 "phase 22 warm-up")
    sw.ksw_extend.launches = sw_local.ksw_local.launches = 0
    secs = stream_phase(aln, batches[1:], wants[1:], PE_PAIRS, card,
                        STREAM_WINDOWS, STREAM_REPS, PE_STREAM_VARIANTS,
                        "22")
    k1, k2 = sw.ksw_extend.launches, sw_local.ksw_local.launches
    print(f"phase 22: K1 launches {k1}, K2 launches {k2} over the timed "
          f"runs [{card}]", flush=True)
    if k1 <= 0 or k2 <= 0:
        raise AssertionError(f"phase 22 launched K1 {k1} and K2 {k2} times")
    return secs

OPTION_SE_READS = 4096      # phase 23's SE batch at each set (options call)
OPTION_PE_PAIRS = 2048      # ... and its PE batch, in pairs
FULL_CALL_OPTION_SETS = ("scaled2", "pacbio")   # (b) in the full call
FULL_CALL_OPTION_SE_READS = 512     # ... its SE batch (1024 before phase 27)
FULL_CALL_OPTION_PE_PAIRS = 256     # ... and PE pairs (512 before phase 27)
OPTION_CLI_PAIRS = 512      # (c): the command line's pairs (the batch's, if
#                             fewer)


def option_sweeps(names, card: str, short: bool = False) -> dict:
    """Phase 23 (a): K1 and K2 against their plain versions on the card at
    each option set's scores (production shapes and edge sweep, the
    packed key's rows at the set's match score; with ``short``, the edge
    rows at the main path's widths alone). Sets whose kernel arguments
    equal an earlier set's (scores, band width, z-drop, rescue minimum
    score) are held by that set's sweep. Returns the worst error of each
    kernel."""
    t0 = time.time()
    seen, worst = {}, [0, 0]
    for name in names:
        opt, scoring = set_options(name)
        key = (tuple(sorted(scoring.items())), opt.w, opt.zdrop,
               opt.min_seed_len * opt.a)
        if key in seen:
            print(f"options: {name}'s kernel arguments are {seen[key]}'s, "
                  f"held by its sweep [{card}]", flush=True)
            continue
        seen[key] = name
        t1 = time.time()
        worst[0] = max(worst[0], parity(card, name, short))
        worst[1] = max(worst[1], parity_k2(card, name, short))
        print(f"options: {name} sweeps of K1 and K2 bit-equal to their "
              f"plain versions in {time.time() - t1:.1f} s [{card}]",
              flush=True)
    print(f"options: the sweeps took {time.time() - t0:.1f} s [{card}]",
          flush=True)
    return dict(k1=worst[0], k2=worst[1])


def option_batches(idx, se_reads: int, pe_pairs: int):
    """Phase 23's SE batch (bench reads: 100 bp, 1% substitutions, 0.1%
    indels, seed 7), PE batch (150 bp pairs, inserts 400 +- 50, seed 11;
    the reads of phases 3 and 5) and the PE batch's records."""
    import numpy as np
    from tpubwa_torch.io import fastx
    from tpubwa_torch.tools import bench_world
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)
    recs = fastx.simulate_reads(fwd, pe_pairs, read_len=PE_READ_LEN,
                                error_rate=0.01, indel_rate=0.001, seed=11,
                                paired=True, insert_mean=400, insert_std=50)
    return (bench_world.reads(idx, se_reads),
            fastx.batch_reads(recs, max_len=PE_READ_LEN), recs)


def option_set_run(idx, name: str, se, pe, card: str) -> dict:
    """Phase 23 (b) at one set: an Aligner at the set's options on the
    card aligns the SE batch and the PE batch (held_run). Returns the
    numbers, the first K1 call's and first forward K2 call's inputs and
    the aligner."""
    from tpubwa_torch.pipeline import Aligner
    from tpubwa_torch.tools import bench_world, option_sets
    opt, scoring = set_options(name)
    t0 = time.time()
    aln = Aligner(idx, opt, device=DEVICE, lut_cache=bench_world.lut_path())
    setup = time.time() - t0
    out = dict(name=name, flags=" ".join(option_sets.SETS[name]))
    with kernel_calls() as calls:
        for path, batch in (("SE", se), ("PE", pe)):
            out[path] = held_run(aln, path, batch,
                                 f"options {name} ({out['flags']})", card)
            out[path].pop("sam")
    out.update(setup=setup, k1_first=calls.first_call("K1"),
               k2_first=calls.first_call("K2 fwd"),
               scoring=scoring, zdrop=opt.zdrop, aln=aln)
    return out


def instance_name(k: int) -> str:
    return f"K={k}" if k else "generic"


class kernel_calls:
    """A context in which worker.ksw_extend and rescue.ksw_local go
    through the real wrappers (and are counted) while every launch (a
    call with a task) is logged by kernel and instance: ``counts`` maps
    ("K1", instance), ("K2 fwd", instance) and ("K2 rev", instance) to
    launches, ``first`` to that key's first call's inputs and, on the
    card, ``events`` to a pair of CUDA events around each launch
    (``kernel_ms``); the rescue calls' (Q, T) are ``k2_shapes``, and
    the generic K2 launches whose window T is 2048 or more to ``wide``,
    the forward ones also to ("K2 fwd wide", 0) in ``counts`` and
    ``first``; K2's launches are also logged by (pass, Q, T):
    ``k2_by_shape``, ``k2_first`` and ``k2_events`` (``k2_shape_ms``).
    With ``by_width`` K1's launches are also logged by query width:
    ``q_counts``, ``q_first`` and ``q_events`` (``width_ms``)."""

    def __init__(self, by_width: bool = False):
        self.by_width = by_width

    def __enter__(self):
        import torch
        from tpubwa_torch.extend import worker
        from tpubwa_torch.ops import sw, sw_local
        from tpubwa_torch.pair import rescue
        self.real = worker.ksw_extend, rescue.ksw_local
        real1, real2 = self.real
        self.counts, self.first, self.events = {}, {}, {}
        self.wide = 0
        self.k2_by_shape, self.k2_first, self.k2_events = {}, {}, {}
        self.q_counts, self.q_first, self.q_events = {}, {}, {}

        def run(key, args, fn):
            if not args[0].shape[0]:
                return fn()
            self.counts[key] = self.counts.get(key, 0) + 1
            if key not in self.first:
                self.first[key] = tuple(a.clone() for a in args)
            if not args[0].is_cuda:
                return fn()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn()
            ev[1].record()
            self.events.setdefault(key, []).append(ev)
            return out

        def k1(*args, **kw):
            Q = args[0].shape[1]
            key = ("K1", sw.kernel_instance(Q))
            if not self.by_width or not args[0].shape[0]:
                return run(key, args, lambda: real1(*args, **kw))
            self.q_counts[Q] = self.q_counts.get(Q, 0) + 1
            if Q not in self.q_first:
                self.q_first[Q] = tuple(a.clone() for a in args)
            out = run(key, args, lambda: real1(*args, **kw))
            if args[0].is_cuda:
                self.q_events.setdefault(Q, []).append(self.events[key][-1])
            return out

        def k2(*args, want_sub, **kw):
            Q, T = args[0].shape[1], args[2].shape[1]
            inst = sw_local.kernel_instance(Q)
            key = ("K2 fwd" if want_sub else "K2 rev", inst)
            if not args[0].shape[0]:
                return run(key, args, lambda: real2(*args, want_sub=want_sub,
                                                    **kw))
            if inst == 0 and T >= 2048:
                self.wide += 1
                if want_sub:
                    w = ("K2 fwd wide", 0)
                    self.counts[w] = self.counts.get(w, 0) + 1
                    self.first.setdefault(w, tuple(a.clone() for a in args))
            sk = ("forward" if want_sub else "reverse", Q, T)
            self.k2_by_shape[sk] = self.k2_by_shape.get(sk, 0) + 1
            self.k2_first.setdefault(sk, tuple(a.clone() for a in args))
            out = run(key, args, lambda: real2(*args, want_sub=want_sub,
                                               **kw))
            if args[0].is_cuda:
                self.k2_events.setdefault(sk, []).append(
                    self.events[key][-1])
            return out
        worker.ksw_extend, rescue.ksw_local = k1, k2
        return self

    def __exit__(self, *exc):
        from tpubwa_torch.extend import worker
        from tpubwa_torch.pair import rescue
        worker.ksw_extend, rescue.ksw_local = self.real
        return False

    @property
    def k2_shapes(self) -> set:
        """The (Q, T) of the K2 launches."""
        return {(q, t) for _, q, t in self.k2_by_shape}

    def by(self, kernel: str) -> dict:
        """Launches of ``kernel`` ("K1", "K2 fwd", "K2 rev") by instance
        name."""
        return {instance_name(i): n for (k, i), n in sorted(
            self.counts.items()) if k == kernel}

    def total(self, *kernels) -> int:
        return sum(n for (k, _), n in self.counts.items() if k in kernels)

    def kernel_ms(self) -> dict:
        """Device ms of the launches by "kernel instance" name (CUDA
        events around each launch; empty off the card)."""
        import torch
        if self.events:
            torch.cuda.synchronize()
        return {f"{k} {instance_name(i)}": sum(a.elapsed_time(b)
                                               for a, b in evs)
                for (k, i), evs in sorted(self.events.items())}

    def width_ms(self) -> dict:
        """Device ms of K1's launches by query width (``by_width``)."""
        import torch
        if self.q_events:
            torch.cuda.synchronize()
        return {q: sum(a.elapsed_time(b) for a, b in evs)
                for q, evs in sorted(self.q_events.items())}

    def k2_shape_ms(self) -> dict:
        """Device ms of K2's launches by (pass, Q, T)."""
        import torch
        if self.k2_events:
            torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in evs)
                for k, evs in sorted(self.k2_events.items())}

    def first_call(self, kernel: str):
        """The inputs of ``kernel``'s first launch ("K1", "K2 fwd"), of
        whichever instance."""
        return next(v for (k, _), v in self.first.items() if k == kernel)


def held_run(aln, path: str, batch, what: str, card: str,
             stream: bool = False) -> dict:
    """One batch on the card, PE when ``path`` starts with "PE" (through
    align_se_stream / align_pe_stream with ``stream``, else align_se /
    align_pe), with the kernels' counts set to 0 just before and read
    just after: the SAM byte-equal to the oracle's under the aligner's
    options, no rescue result missing, K1 launched on both paths and K2
    on the PE path. Prints a line; returns the numbers and the SAM."""
    import torch
    from tpubwa_torch.ops import sw, sw_local
    pe = path.startswith("PE")
    aln.stats = {"reads": 0, "fallback_reads": 0}
    aln.oracle._lib.tb_rescue_miss_reset()
    torch.cuda.synchronize()
    sw.ksw_extend.launches = sw_local.ksw_local.launches = 0
    t1 = time.perf_counter()
    if stream:
        sam = "".join((aln.align_pe_stream if pe else aln.align_se_stream)(
            [batch], id0=0))
    else:
        sam = (aln.align_pe if pe else aln.align_se)(batch, id0=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    k1, k2 = sw.ksw_extend.launches, sw_local.ksw_local.launches
    misses = aln.oracle._lib.tb_rescue_miss_count()
    st = dict(aln.stats)
    want = aln.oracle.align_pe(batch, aln.opt, id0=0)[0] if pe \
        else aln.oracle.align_se(batch, aln.opt, id0=0)
    first_diff(sam, want, f"{what} {path} SAM against the oracle at the "
               "same options")
    out = dict(reads=batch.n, s=dt, reads_per_s=batch.n / dt,
               fallback=st["fallback_reads"] / max(st["reads"], 1),
               tier1_ovf=st.get("tier1_ovf", 0),
               tier2_rows=st.get("tier2_rows", 0),
               tier3_rows=st.get("tier3_rows", 0),
               rescue_tasks=st.get("rescue_tasks", 0), misses=misses,
               k1=k1, k2=k2, sam=sam)
    print(f"{what} {path}: {batch.n} reads SAM byte-equal to the oracle in "
          f"{dt:.3f} s ({batch.n / dt:.1f} reads/s); fallback share "
          f"{out['fallback']:.5f}; tier1 overflow {out['tier1_ovf']}; tier2 "
          f"rows {out['tier2_rows']}, tier3 rows {out['tier3_rows']}; rescue "
          f"tasks {out['rescue_tasks']}, results missing {misses}; K1 "
          f"launches {k1}, K2 launches {k2} [{card}]", flush=True)
    if misses:
        raise AssertionError(f"{what} {path}: {misses} rescue results "
                             "missing")
    if k1 <= 0 or (pe and k2 <= 0):
        raise AssertionError(f"{what} {path} launched K1 {k1} and K2 {k2} "
                             "times")
    return out


def option_cli(aln, recs, card: str) -> dict:
    """Phase 23 (c): `python -m tpubwa_torch align idx r_1.fq r_2.fq
    --platform cuda` with the scaled2 flags on the first OPTION_CLI_PAIRS
    pairs of ``recs`` (interleaved): the file byte-equal to the header +
    Oracle.align_pe under the same options (``aln``, the scaled2 aligner
    of (b)), K1 and K2 launched."""
    from tpubwa_torch.io import fastx
    from tpubwa_torch.tools import bench_world
    from tpubwa_torch.tools.option_sets import SETS
    d = smoke_dir()
    pe = recs[:2 * OPTION_CLI_PAIRS]
    fastx.write_fastq(d / "o_1.fq", pe[0::2])
    fastx.write_fastq(d / "o_2.fq", pe[1::2])
    pe = [r for m in zip(fastx.iter_fastq(d / "o_1.fq"),
                         fastx.iter_fastq(d / "o_2.fq")) for r in m]
    want = aln.sam_header() + aln.oracle.align_pe(
        fastx.batch_reads(pe, max_len=PE_READ_LEN), aln.opt, id0=0)[0]
    t0 = time.time()
    err = run_cli(["align", str(bench_world.BUILD /
                                f"smoke_index_{GENOME_LEN}.npz"),
                   str(d / "o_1.fq"), str(d / "o_2.fq"), "-o",
                   str(d / "o_pe.sam"), "--platform", DEVICE,
                   "--batch-size", str(len(pe)), *SETS["scaled2"]],
                  "CLI PE at scaled2")
    wall = time.time() - t0
    first_diff((d / "o_pe.sam").read_text(), want, "CLI PE SAM at scaled2 "
               "against the header + Oracle.align_pe")
    k1, k2 = cli_launches(err)
    print(f"options CLI PE ({' '.join(SETS['scaled2'])}): "
          f"{len(pe) // 2} pairs, whole file byte-equal to the header + "
          f"Oracle.align_pe at the same options; the CLI says: "
          f"{cli_line(err, 'total')}; process wall {wall:.1f} s; K1 "
          f"launches {k1}, K2 launches {k2} [{card}]", flush=True)
    if k1 <= 0 or k2 <= 0:
        raise AssertionError(f"the CLI at scaled2 launched K1 {k1} and K2 "
                             f"{k2} times")
    return dict(wall=wall, k1=k1, k2=k2)


def options_phase(card: str, sweep_names, names, se_reads: int,
                  pe_pairs: int, idx=None, short: bool = False) -> dict:
    """Phase 23: the alignment options path. (a) the kernels' sweeps at
    the scores of ``sweep_names`` (``short``: at the main path's widths
    alone); (b) an SE batch of se_reads and a PE
    batch of pe_pairs through Aligner(opt, device="cuda") at each set of
    ``names``, SAM byte-equal to the oracle's; (c) the command line at
    scaled2. Returns (a)'s worst errors and (b)'s runs by set."""
    from tpubwa_torch.tools import bench_world
    t0 = time.time()
    worst = option_sweeps(sweep_names, card, short)
    if idx is None:
        idx = bench_world.get_index()
    se, pe, recs = option_batches(idx, se_reads, pe_pairs)
    runs = {}
    for name in names:
        t1 = time.time()
        runs[name] = option_set_run(idx, name, se, pe, card)
        aln = runs[name].pop("aln")
        if name == "scaled2":
            cli_res = option_cli(aln, recs, card)
        del aln
        print(f"options: {name} took {time.time() - t1:.1f} s (aligner "
              f"set-up {runs[name]['setup']:.1f} s) [{card}]", flush=True)
    print(f"phase 23 took {time.time() - t0:.1f} s [{card}]", flush=True)
    return dict(worst=worst, runs=runs, cli=cli_res)


def option_kernels(opts: dict, names, card: str) -> list:
    """The {"kernels": [...]} entries of phase 23 (option_entries), each
    with the worst error of its kernel's sweeps at the sets' scores."""
    w = opts["worst"]
    return [kernel_entry(*e[:5], w["k1" if e[2] == "ksw_extend.cu" else
                                    "k2"], e[5])
            for e in option_entries(opts, names, card)]


def option_entries(opts: dict, names, card: str) -> list:
    """Phase 6 for phase 23: K1 on the first call and K2 on the first
    forward call of (b) at each set of ``names``, held to their plain
    versions at the set's scores and timed beside their bounds."""
    out = []
    for name in names:
        r = opts["runs"][name]
        out.append(k1_entry(f"ksw_extend_{name}", f"SE + PE at {name} "
                            f"({r['flags']}; phase 23)", r["k1_first"],
                            r["SE"]["k1"] + r["PE"]["k1"], card,
                            r["scoring"], r["zdrop"]))
        out.append(k2_entry(f"ksw_local_{name}", f"PE rescue, forward "
                            f"pass, at {name} (phase 23)", r["k2_first"],
                            r["PE"]["k2"], card, r["scoring"]))
    return out


CONTIG_SE_READS = 4096      # phase 24's bench reads a layout (contigs call)
CONTIG_PE_PAIRS = 2048      # ... and bench pairs
FULL_CALL_CONTIG_SE_READS = 512                 # ... in the full call
FULL_CALL_CONTIG_PE_PAIRS = 256
# phase 24's edge batches: every n-th boundary straddled (SE, 30, 50 and
# 70 bp over it, both strands) and paired across (PE); contigs with reads
# flush with their start and end; chimeric 130 + 120 bp reads; pairs on
# two contigs; heavy-error pairs at contig ends; plain pairs beside them
CONTIG_EDGES = dict(every=8, flush=64, chimeras=256, split=128, rescue=64,
                    plain=256)
FULL_CALL_CONTIG_EDGES = dict(every=64, flush=8, chimeras=32, split=16,
                              rescue=8, plain=128)
CONTIG_FIELD = 2048         # first contig id the packed row's field lacks
CONTIG_CLI_LEN = 200_000    # the contigs call's FASTA: the bench text's head


def edge_batches(idx, e: dict):
    """Phase 24's edge batches on a layout's index: SE (100 bp
    straddlers, flush reads, 250 bp chimeras: a mixed-length batch) and
    PE (150 bp; plain pairs, inserts 400 +- 50, seed 17; pairs across
    boundaries; pairs on two contigs; pairs whose second mate has an
    error every 7 bases, their fragment ending 20 bp before a contig's
    end)."""
    import numpy as np
    from tpubwa_torch.io import fastx
    from tpubwa_torch.tools import contig_layouts as cl
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)
    a = idx.anns
    se = (cl.straddlers(fwd, a, e["every"]) + cl.flush_reads(fwd, a,
                                                            e["flush"])
          + cl.chimeras(fwd, a, e["chimeras"], seed=13))
    pe = (fastx.simulate_reads(fwd, e["plain"], read_len=PE_READ_LEN,
                               error_rate=0.01, indel_rate=0.001, seed=17,
                               paired=True, insert_mean=400, insert_std=50)
          + cl.boundary_pairs(fwd, a, e["every"], 400, PE_READ_LEN)
          + cl.split_pairs(fwd, a, e["split"], seed=19,
                           read_len=PE_READ_LEN)
          + cl.end_rescue_pairs(fwd, a, e["rescue"], seed=23, insert=400,
                                read_len=PE_READ_LEN))
    return fastx.batch_reads(se), fastx.batch_reads(pe, max_len=PE_READ_LEN)


def contig_counts(sam: str, names) -> dict:
    """Of ``sam``'s records: primaries placed on contig CONTIG_FIELD or
    later, records whose SA:Z names another contig, records whose RNEXT
    is another contig."""
    late = set(names[CONTIG_FIELD:])
    n = dict(late=0, sa_other=0, rnext_other=0)
    for line in sam.splitlines():
        f = line.split("\t")
        flag, rname = int(f[1]), f[2]
        n["late"] += not flag & 0x904 and rname in late
        sa = line.split("\tSA:Z:")
        n["sa_other"] += len(sa) > 1 and sa[1].split(",")[0] != rname
        n["rnext_other"] += f[6] not in ("=", "*")
    return n


def contig_layout_run(idx, name: str, se, pe, edges: dict, card: str,
                      split: bool = False) -> dict:
    """Phase 24 at one layout: the bench index re-annotated with layout
    ``name`` and its LUT cache (the same text, so the same table) under
    an Aligner on the card; its header's @SQ lines in layout order; the
    bench SE batch through align_se_stream, the edge SE batch through
    align_se, the bench PE batch through align_pe_stream and the edge PE
    batch through align_pe (held_run: byte-equal to the oracle at the
    layout, no rescue result missing); with ``split``, the bench SE batch
    stage by stage. Returns the runs, the first K1 and forward K2 calls'
    inputs and the stage split."""
    from tpubwa_torch.pipeline import Aligner
    from tpubwa_torch.tools import bench_world, contig_layouts
    t0 = time.time()
    lidx = contig_layouts.reannotate(idx, name)
    aln = Aligner(lidx, device=DEVICE, lut_cache=bench_world.lut_path())
    names = [a.name for a in lidx.anns]
    sq = [l.split("\t")[1][3:] for l in aln.sam_header().splitlines()
          if l.startswith("@SQ")]
    if sq != names or len(sq) != contig_layouts.COUNTS[name]:
        raise AssertionError(f"phase 24 {name}: {len(sq)} @SQ lines, not "
                             f"the layout's {contig_layouts.COUNTS[name]} "
                             "in order")
    se_x, pe_x = edge_batches(lidx, edges)
    setup = time.time() - t0
    runs = {}
    with kernel_calls() as calls:
        for path, batch, stream in (("SE bench", se, True),
                                    ("SE edge", se_x, False),
                                    ("PE bench", pe, True),
                                    ("PE edge", pe_x, False)):
            r = runs[path] = held_run(aln, path, batch, f"contigs {name}",
                                      card, stream)
            r.update(contig_counts(r.pop("sam"), names))
            print(f"contigs {name} {path}: {r['late']} primary records on "
                  f"contig {CONTIG_FIELD} or later, {r['sa_other']} SA:Z "
                  f"naming another contig, {r['rnext_other']} with RNEXT "
                  f"another contig [{card}]", flush=True)
    split_s = stages(aln, se, 0, card, f"contigs {name} stage") \
        if split else None
    print(f"contigs {name}: {len(sq)} @SQ lines in layout order; set-up "
          f"{setup:.1f} s (edge batches of {se_x.n} SE reads and "
          f"{pe_x.n // 2} pairs); layout took {time.time() - t0:.1f} s "
          f"[{card}]", flush=True)
    return dict(runs=runs, k1_first=calls.first_call("K1"),
                k2_first=calls.first_call("K2 fwd"),
                split=split_s, k1=sum(r["k1"] for r in runs.values()),
                k2=sum(r["k2"] for r in runs.values()))


def contig_cli(idx, card: str) -> dict:
    """Phase 24's command line (contigs call only): the bench text's first
    CONTIG_CLI_LEN bases as a grch38-layout FASTA with N runs at the start
    of every 10th contig and the end of every 15th; `index` on it, then
    `align` SE and two-file PE, `align --shard-dir` + `merge --sort`, and
    `sort`, each file byte-equal to the header + the oracle's text on
    that index; the sorted files place chr2 before chr10."""
    import types

    import numpy as np
    from tpubwa_torch.index.builder import FMIndex
    from tpubwa_torch.io import fastx, sam
    from tpubwa_torch.opts import MemOptions
    from tpubwa_torch.oracle import Oracle
    from tpubwa_torch.pipeline import Aligner
    from tpubwa_torch.tools import contig_layouts as cl
    t0 = time.time()
    d = smoke_dir() / "contigs"
    d.mkdir(exist_ok=True)
    lay = cl.layout(CONTIG_CLI_LEN, "grch38")
    (d / "g.fa").write_text(cl.fasta_text(cl.gapped_records(
        idx.get_seq(0, CONTIG_CLI_LEN).astype(np.uint8), lay, seed=29)))
    lut = d / "g.lut.npz"
    run_cli(["index", str(d / "g.fa"), "-o", str(d / "g.npz")],
            "CLI index of the contigs FASTA", lut=lut)
    cidx = FMIndex.load(d / "g.npz")
    if [(a.name, a.offset, a.length) for a in cidx.anns] != lay or \
            len(cidx.ambs) != len(lay[::10]) + len(lay[::15]):
        raise AssertionError("the contigs index's annotations or N runs "
                             "are not the FASTA's")
    fwd = cidx.get_seq(0, cidx.l_pac).astype(np.uint8)
    se = fastx.simulate_reads(fwd, 1024, read_len=READ_LEN, error_rate=0.01,
                              indel_rate=0.001, seed=31) + \
        cl.straddlers(fwd, lay, every=4)
    pe = fastx.simulate_reads(fwd, 512, read_len=PE_READ_LEN,
                              error_rate=0.01, indel_rate=0.001, seed=37,
                              paired=True, insert_mean=400, insert_std=50) + \
        cl.split_pairs(fwd, lay, 32, seed=41, read_len=PE_READ_LEN)
    fastx.write_fastq(d / "se.fq", se)
    fastx.write_fastq(d / "c_1.fq", pe[0::2])
    fastx.write_fastq(d / "c_2.fq", pe[1::2])
    se = list(fastx.iter_fastq(d / "se.fq"))
    pe = [r for m in zip(fastx.iter_fastq(d / "c_1.fq"),
                         fastx.iter_fastq(d / "c_2.fq")) for r in m]
    orc, opt = Oracle(cidx), MemOptions()
    header = Aligner.sam_header(types.SimpleNamespace(idx=cidx, rg_id=""))
    want_se = header + orc.align_se(fastx.batch_reads(se), opt, id0=0)
    want_pe = header + orc.align_pe(fastx.batch_reads(pe), opt, id0=0)[0]
    npz, out = str(d / "g.npz"), {}
    for what, args, want in (
            ("SE", [str(d / "se.fq"), "--batch-size", str(len(se))],
             want_se),
            ("PE", [str(d / "c_1.fq"), str(d / "c_2.fq"), "--batch-size",
                    str(len(pe))], want_pe)):
        f = d / f"{what}.sam"
        err = run_cli(["align", npz, *args, "-o", str(f), "--platform",
                       DEVICE], f"CLI {what} on the contigs index", lut=lut)
        first_diff(f.read_text(), want, f"contigs CLI {what} against the "
                   "header + the oracle")
        out[what] = cli_launches(err)
    shard = 256
    run_cli(["align", npz, str(d / "se.fq"), "--platform", DEVICE,
             "--batch-size", str(shard), "--shard-dir", str(d / "shards")],
            "CLI --shard-dir on the contigs index", lut=lut)
    body = "".join(orc.align_se(fastx.batch_reads(se[i:i + shard]), opt,
                                id0=i) for i in range(0, len(se), shard))
    shards = sorted((d / "shards").glob("shard_*.sam"))
    run_cli(["merge", str(d / "shards" / "header.sam"), *map(str, shards),
             "-o", str(d / "merged.sam"), "--sort"], "CLI merge --sort")
    first_diff((d / "merged.sam").read_text(),
               sam.coordinate_sort(header + body), "contigs CLI merge "
               "--sort against the sorted header + oracle")
    run_cli(["sort", str(d / "SE.sam"), "-o", str(d / "sorted.sam")],
            "CLI sort")
    srt = (d / "sorted.sam").read_text()
    first_diff(srt, sam.coordinate_sort(want_se), "contigs CLI sort "
               "against the sorted header + oracle")
    rn = [l.split("\t")[2] for l in srt.splitlines() if l[0] != "@"]
    if not ("chr2" in rn and "chr10" in rn and
            max(i for i, r in enumerate(rn) if r == "chr2") <
            min(i for i, r in enumerate(rn) if r == "chr10")):
        raise AssertionError("the sorted file does not place chr2 before "
                             "chr10")
    print(f"contigs CLI: index of {len(lay)} records ({len(cidx.ambs)} N "
          f"runs), SE ({len(se)} reads) and two-file PE ({len(pe) // 2} "
          f"pairs) files, {len(shards)} shards merged with --sort and the "
          f"sorted SE file byte-equal to the header + the oracle; chr2 "
          f"before chr10; K1/K2 launches SE {out['SE']}, PE {out['PE']}; "
          f"{time.time() - t0:.1f} s [{card}]", flush=True)
    if min(out["SE"][0], *out["PE"]) <= 0:
        raise AssertionError(f"the contigs CLI launched K1/K2 {out}")
    return out


def contigs_phase(card: str, se_reads: int, pe_pairs: int, edges: dict,
                  idx=None, full: bool = False) -> dict:
    """Phase 24: references of many contigs. At the grch38 and hs38dh
    layouts (tpubwa_torch/tools/contig_layouts.py) over the bench index:
    se_reads bench reads, pe_pairs bench pairs and the edge batches
    (contig_layout_run); K1's first call and K2's first forward call at
    hs38dh kept for phase 6; the tiers stage of the bench SE batch at
    hs38dh against grch38; with ``full`` the stage split and the
    command line (contig_cli)."""
    from tpubwa_torch.tools import bench_world, contig_layouts
    t0 = time.time()
    if idx is None:
        idx = bench_world.get_index()
    se, pe, _ = option_batches(idx, se_reads, pe_pairs)
    runs = {name: contig_layout_run(idx, name, se, pe, edges, card, full)
            for name in contig_layouts.NAMES}
    if full:
        t = {n: runs[n]["split"]["tiers"] for n in runs}
        print(f"contigs: tiers stage of the bench SE batch ({se.n} reads) "
              f"{t['hs38dh'] * 1e3:.1f} ms at hs38dh against "
              f"{t['grch38'] * 1e3:.1f} ms at grch38, difference "
              f"{(t['hs38dh'] - t['grch38']) * 1e3:.1f} ms [{card}]",
              flush=True)
        contig_cli(idx, card)
    print(f"phase 24 took {time.time() - t0:.1f} s [{card}]", flush=True)
    return runs


def contig_entries(runs: dict, card: str) -> list:
    """Phase 6 for phase 24: K1 on the first call and K2 on the first
    forward call of the hs38dh batches, held to their plain versions and
    timed beside their bounds; launches are the hs38dh batches'."""
    r = runs["hs38dh"]
    return [k1_entry("ksw_extend_contigs", "SE + PE at the hs38dh layout, "
                     "3366 contigs (phase 24)", r["k1_first"], r["k1"], card),
            k2_entry("ksw_local_contigs", "PE rescue, forward pass, at the "
                     "hs38dh layout (phase 24)", r["k2_first"], r["k2"],
                     card)]


LONG_PE = {250: (550, 50, 51), 300: (650, 60, 52)}   # (a), (b): insert
#   mean, sd and seed a read length (2x250 HiSeq 2500 Rapid / NovaSeq SP,
#   2x300 MiSeq v3)
LONG_PE_PAIRS = 2048        # phase 25's (a) and (b) batches, in pairs
LONG_PE_EDGE = 256          # (c): overlap, read-through, trimmed and rescue
#                             pairs of 300 bp, each
LONG_PE_WIDE = 1024         # (d): broad-insert pairs (650 +- WIDE_SD) ...
LONG_PE_WIDE_RESCUE = 64    # ... and rescue pairs beside them
WIDE_SD = 250               # long_pairs.wide_pairs: rescue window > 1792
LONG_PE_SE_READS = 4096     # (e): SE reads of 300 bp
LONG_PE_STREAM_PAIRS = 512  # (f): the stream's third batch (2x250)
LONG_PE_CLI_PAIRS = 512     # (g): the command line's 2x300 pairs
FULL_CALL_LONG_PE = 256     # the full call: (b) and (d) at 256 pairs ...
FULL_CALL_LONG_PE_RESCUE = 16   # ... and 16 rescue pairs beside (d)'s


def long_pe_run(aln, label: str, batch, card: str, path: str = "PE") -> dict:
    """Phase 25 on one batch: held_run (align_pe, or align_se with
    ``path`` "SE"; byte-equal to the oracle, no rescue result missing)
    with every launch logged by instance (kernel_calls), the logged
    launches equal to the wrappers' counts. Prints the launches by
    instance and the rescue calls' widths."""
    from tpubwa_torch.ops import sw_local
    with kernel_calls() as calls:
        r = held_run(aln, path, batch, f"long PE {label}", card)
    r.pop("sam")
    if (calls.total("K1"), calls.total("K2 fwd", "K2 rev")) != \
            (r["k1"], r["k2"]):
        raise AssertionError(f"long PE {label}: the logged launches "
                             f"{calls.counts} are not the wrappers' K1 "
                             f"{r['k1']} and K2 {r['k2']}")
    smem = sorted({sw_local.smem_bytes(q) for q, _ in calls.k2_shapes})
    ms = calls.kernel_ms()
    print(f"long PE {label}: K1 launches by instance {calls.by('K1')}; K2 "
          f"forward {calls.by('K2 fwd')}, reverse {calls.by('K2 rev')}; "
          f"rescue calls' (Q, T) {sorted(calls.k2_shapes)}, shared memory "
          f"a block {smem} bytes; {calls.wide} generic K2 launches "
          f"at T >= 2048; kernel device ms by instance "
          f"{ {k: round(v, 3) for k, v in ms.items()} }, "
          f"{sum(ms.values()):.3f} ms in all, "
          f"{100 * sum(ms.values()) / 1e3 / r['s']:.2f}% of the batch's "
          f"{r['s']:.3f} s [{card}]", flush=True)
    r.update(calls=calls, kernel_ms=ms)
    return r


def long_pe_batches(idx, full: bool) -> dict:
    """Phase 25's batches by letter: (a) 2x250 and (b) 2x300 simulated
    pairs (1% substitutions, 0.1% indels, LONG_PE's inserts), (c) the
    300 bp overlap, read-through, trimmed (650 +- 60) and rescue (insert
    650) pairs of tools/long_pairs.py in one batch, (d) broad-insert
    pairs (650 +- WIDE_SD) with rescue pairs beside them, (e) 300 bp SE
    reads; with ``full`` (the full call) only (b) and (d), at
    FULL_CALL_LONG_PE pairs. Values: (path, ReadBatch, records)."""
    import numpy as np
    from tpubwa_torch.io import fastx
    from tpubwa_torch.tools import long_pairs as lp
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)

    def sim(L, n, seed=None):
        mean, sd, s = LONG_PE[L]
        return fastx.simulate_reads(fwd, n, read_len=L, error_rate=0.01,
                                    indel_rate=0.001, seed=seed or s,
                                    paired=True, insert_mean=mean,
                                    insert_std=sd)
    n = FULL_CALL_LONG_PE if full else LONG_PE_PAIRS
    recs = {"b": sim(300, n)}
    n_wide, n_resc = (FULL_CALL_LONG_PE, FULL_CALL_LONG_PE_RESCUE) if full \
        else (LONG_PE_WIDE, LONG_PE_WIDE_RESCUE)
    recs["d"] = (lp.wide_pairs(fwd, n_wide, 300, 53, 650, WIDE_SD)
                 + lp.rescue_pairs(fwd, n_resc, 300, 54, 650))
    if not full:
        e = LONG_PE_EDGE
        recs["a"] = sim(250, LONG_PE_PAIRS)
        recs["c"] = (lp.overlap_pairs(fwd, e, 300, 55)
                     + lp.readthrough_pairs(fwd, e, 300, 56)
                     + lp.trimmed_pairs(fwd, e, 300, 57, 650, 60)
                     + lp.rescue_pairs(fwd, e, 300, 58, 650))
        recs["e"] = fastx.simulate_reads(fwd, LONG_PE_SE_READS, read_len=300,
                                         error_rate=0.01, indel_rate=0.001,
                                         seed=59)
    return {k: ("SE" if k == "e" else "PE",
                fastx.batch_reads(recs[k], max_len=250 if k == "a" else 300),
                recs[k]) for k in sorted(recs)}


LONG_PE_LABELS = {"a": "(a) 2x250", "b": "(b) 2x300",
                  "c": "(c) overlap, read-through, trimmed, rescue",
                  "d": "(d) broad inserts", "e": "(e) SE 300 bp"}


def long_pe_checks(runs: dict):
    """Phase 25's launch checks: K1's generic instance on (b), (c) and
    (e); K2's generic instance forward and reverse on (b); a generic K2
    launch at T >= 2048 on (d); at 2x250 (a)
    the K=8 register instances of K1 and of K2 (both passes). Checks what
    ran: the full call runs (b) and (d) alone."""
    from tpubwa_torch.ops import sw_local
    c = {k: r["calls"].counts for k, r in runs.items()}
    need = [(k, key) for k, key in (
        ("b", ("K1", 0)), ("c", ("K1", 0)), ("e", ("K1", 0)),
        ("b", ("K2 fwd", 0)), ("b", ("K2 rev", 0)), ("a", ("K1", 8)),
        ("a", ("K2 fwd", 8)), ("a", ("K2 rev", 8))) if k in c]
    bad = [f"{LONG_PE_LABELS[k]} {key[0]} {instance_name(key[1])}"
           for k, key in need if not c[k].get(key)]
    if not runs["d"]["calls"].wide:
        bad.append(f"{LONG_PE_LABELS['d']} K2 generic at T >= 2048")
    if bad:
        raise AssertionError("phase 25 launched no " + "; no ".join(bad))


def long_pe_stream(aln, batches: dict, idx, card: str) -> dict:
    """Phase 25 (f): align_pe_stream over (a), (b) and a third batch of
    LONG_PE_STREAM_PAIRS 2x250 pairs (seed 60), each numbered from pair
    0, kernel counts set to 0 just before and read just after: (a)'s and
    (b)'s SAM byte-equal to their align_pe runs, which the oracle held,
    the third's to align_pe and to the oracle; no rescue result missing;
    K1 and K2 launched in the K=8 and the generic instances."""
    import numpy as np
    import torch
    from tpubwa_torch.io import fastx
    from tpubwa_torch.ops import sw, sw_local
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)
    mean, sd, _ = LONG_PE[250]
    third = fastx.batch_reads(fastx.simulate_reads(
        fwd, LONG_PE_STREAM_PAIRS, read_len=250, error_rate=0.01,
        indel_rate=0.001, seed=60, paired=True, insert_mean=mean,
        insert_std=sd), max_len=250)
    order = [batches["a"][1], batches["b"][1], third]
    wants = [aln.align_pe(b, id0=0) for b in order]
    lib = aln.oracle._lib
    first_diff(wants[2], aln.oracle.align_pe(third, aln.opt, id0=0)[0],
               "phase 25 (f) third batch's align_pe against the oracle")
    for w, b, what in zip(wants[:2], order[:2], "ab"):
        first_diff(w, aln.oracle.align_pe(b, aln.opt, id0=0)[0],
                   f"phase 25 ({what}) align_pe against the oracle")
    lib.tb_rescue_miss_reset()
    with kernel_calls() as calls:
        torch.cuda.synchronize()
        sw.ksw_extend.launches = sw_local.ksw_local.launches = 0
        t0 = time.perf_counter()
        got = list(aln.align_pe_stream([(b, 0) for b in order]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        k1, k2 = sw.ksw_extend.launches, sw_local.ksw_local.launches
    misses = lib.tb_rescue_miss_count()
    for i, (g, w) in enumerate(zip(got, wants)):
        first_diff(g, w, f"phase 25 (f) stream batch {i} against align_pe")
    n = sum(b.n for b in order)
    print(f"long PE (f) stream 2x250, 2x300, 2x250 ({n} reads): every "
          f"batch byte-equal to align_pe and the oracle in {dt:.3f} s "
          f"({n / dt:.1f} reads/s); rescue results missing {misses}; K1 "
          f"launches {k1} by instance {calls.by('K1')}; K2 {k2}, forward "
          f"{calls.by('K2 fwd')}, reverse {calls.by('K2 rev')} [{card}]",
          flush=True)
    if misses or (calls.total("K1"), calls.total("K2 fwd", "K2 rev")) != \
            (k1, k2):
        raise AssertionError(f"phase 25 (f): {misses} rescue results "
                             f"missing, logged launches {calls.counts}")
    for key in (("K1", 8), ("K1", 0), ("K2 fwd", 8), ("K2 fwd", 0)):
        if not calls.counts.get(key):
            raise AssertionError(f"phase 25 (f) launched no {key[0]} "
                                 f"{instance_name(key[1])}")
    return dict(s=dt, reads_per_s=n / dt, k1=k1, k2=k2, misses=misses)


def long_pe_cli(aln, recs, card: str) -> dict:
    """Phase 25 (g): `python -m tpubwa_torch align idx r_1.fq r_2.fq
    --platform cuda` on the first LONG_PE_CLI_PAIRS pairs of (b): the file
    byte-equal to the header + Oracle.align_pe, K1 and K2 launched."""
    from tpubwa_torch.io import fastx
    from tpubwa_torch.tools import bench_world
    d = smoke_dir()
    pe = recs[:2 * LONG_PE_CLI_PAIRS]
    fastx.write_fastq(d / "l_1.fq", pe[0::2])
    fastx.write_fastq(d / "l_2.fq", pe[1::2])
    pe = [r for m in zip(fastx.iter_fastq(d / "l_1.fq"),
                         fastx.iter_fastq(d / "l_2.fq")) for r in m]
    want = aln.sam_header() + aln.oracle.align_pe(
        fastx.batch_reads(pe, max_len=300), aln.opt, id0=0)[0]
    t0 = time.time()
    err = run_cli(["align", str(bench_world.BUILD /
                                f"smoke_index_{GENOME_LEN}.npz"),
                   str(d / "l_1.fq"), str(d / "l_2.fq"), "-o",
                   str(d / "l_pe.sam"), "--platform", DEVICE,
                   "--batch-size", str(len(pe))], "CLI PE at 2x300")
    wall = time.time() - t0
    first_diff((d / "l_pe.sam").read_text(), want, "CLI PE SAM at 2x300 "
               "against the header + Oracle.align_pe")
    k1, k2 = cli_launches(err)
    print(f"long PE (g) CLI: {len(pe) // 2} pairs of 2x300, whole file "
          f"byte-equal to the header + Oracle.align_pe; the CLI says: "
          f"{cli_line(err, 'total')}; process wall {wall:.1f} s; K1 "
          f"launches {k1}, K2 launches {k2} [{card}]", flush=True)
    if k1 <= 0 or k2 <= 0:
        raise AssertionError(f"the CLI at 2x300 launched K1 {k1} and K2 "
                             f"{k2} times")
    return dict(wall=wall, k1=k1, k2=k2)


def long_pe_phase(card: str, aln=None, full: bool = False) -> dict:
    """Phase 25: paired-end reads of 2x250 and 2x300 bp on the card (the
    bench world, Aligner(idx, device="cuda")). (a)-(e) of long_pe_batches
    through long_pe_run, then long_pe_checks; without ``full`` also (f)
    the mixed-width stream and (g) the command line. Returns the runs."""
    t0 = time.time()
    if aln is None:
        aln = make_aligner()
    batches = long_pe_batches(aln.idx, full)
    runs = {k: long_pe_run(aln, LONG_PE_LABELS[k], b, card, path)
            for k, (path, b, _) in batches.items()}
    long_pe_checks(runs)
    if not full:
        runs["f"] = long_pe_stream(aln, batches, aln.idx, card)
        runs["g"] = long_pe_cli(aln, batches["b"][2], card)
    print(f"phase 25 took {time.time() - t0:.1f} s [{card}]", flush=True)
    return runs


def long_pe_entries(runs: dict, card: str) -> list:
    """Phase 6 for phase 25: the first calls of K1 at 2x250 (K=8) and at
    2x300 (generic), K2 forward and reverse at 2x300 (generic), K2
    forward on (d) at T >= 2048 (generic, above 48 KB) and K2 forward at
    2x250 (K=8), each held to its plain version and timed beside its
    bound and the generic instance; those of the batches that ran. The
    launches are that kernel's pass and instance in its batch."""
    out = []
    for k, key, name, path in (
            ("a", ("K1", 8), "ksw_extend_pe250", "PE 2x250, K=8 (phase 25)"),
            ("b", ("K1", 0), "ksw_extend_pe300",
             "PE 2x300, generic instance (phase 25)"),
            ("b", ("K2 fwd", 0), "ksw_local_pe300", "PE 2x300 rescue, "
             "forward pass, generic instance (phase 25)"),
            ("b", ("K2 rev", 0), "ksw_local_pe300_rev", "PE 2x300 rescue, "
             "reverse pass, generic instance (phase 25)"),
            ("d", ("K2 fwd wide", 0), "ksw_local_wide", "PE 2x300 broad "
             "inserts, forward pass, generic instance at T >= 2048 (phase "
             "25)"),
            ("a", ("K2 fwd", 8), "ksw_local_pe250", "PE 2x250 rescue, "
             "forward pass, K=8 (phase 25)")):
        if k not in runs:
            continue
        c = runs[k]["calls"]
        args, n_l = c.first[key], c.counts[key]
        if key[0] == "K1":
            out.append(k1_entry(name, path, args, n_l, card))
        else:
            out.append(k2_entry(name, path, args, n_l, card,
                                want_sub=key[0] != "K2 rev"))
    return out


# Phase 26: long single-end reads on the bench world. Batch letter ->
# (reads, length (None: log-normal 1-12 kbp), tools/long_reads.py profile,
# option set (None: bwa's defaults), seed, the batch's padded width). (b)
# is padded one 64-lane bucket past its longest read, so that align_se
# splits it into length buckets; (c) as the command line pads a batch, to
# its longest read, so that it runs as one full-width call.
LONG_SE = {"a": (512, 4096, "hifi", None, 61, 4096),
           "b": (512, None, "clr", "pacbio", 62, 12288 + 64),
           "c": (512, None, "ont", "ont2d", 63, 12288),
           "d": (256, 12288, "hifi", None, 64, 12288),
           "e": (4, 32768, "hifi", None, 65, 32768)}
LONG_SE_LABELS = {"a": "(a) 4096 bp hifi",
                  "b": "(b) 1-12 kbp clr, pacbio, length buckets",
                  "c": "(c) 1-12 kbp ont, ont2d, one call",
                  "d": "(d) 12288 bp hifi",
                  "e": "(e) 32768 bp hifi (the packed row's widest query)"}
LONG_SE_CLI = 128           # the command line's reads of (b)
FULL_CALL_LONG_SE = 32      # the full call: (a) alone, at 32 reads (64
#                             before phase 27's piece)
LONG_SE_WIDTHS = (4096, 8192, 12288, 32768)   # K1's entries, by Q
LONG_SE_FULL_TASKS = 8      # K1's entry at Q = 32768: full-width tasks
# the packed row's fields that a long read can pass (pipeline.py::_pack)
PACK_FIELDS = (("seedcov", 0x3FF), ("seedlen0", 0x3FF))
PACK_SPANS = (("qe-qb", "qe", "qb", 0xFFFF), ("re-rb", "re", "rb", 0xFFFF))


class overflow_fields:
    """A context in which ``aln``'s tier-1 worker1 calls (through
    ``_dispatch_se``) record, before packing, each read's tier-1 overflow
    by cause: ``caps`` (a cap or dense budget of worker1's stages), a
    region's ``seedcov`` or ``seedlen0`` above 0x3FF, ``qe-qb`` or
    ``re-rb`` above 0xFFFF, and ``any`` (the read's packed overflow, the
    other fields and the buffer's capacity included). Padding rows of a
    length bucket are not counted. ``buckets`` counts the tier-1 calls."""

    def __init__(self, aln):
        self.aln = aln

    def __enter__(self):
        import numpy as np
        import torch
        from tpubwa_torch import pipeline
        self.real_pack, self.real_dispatch = pipeline._pack, \
            self.aln._dispatch_se
        self.counts = {k: 0 for k in ("caps", "seedcov", "seedlen0",
                                      "qe-qb", "re-rb", "any")}
        self.buckets, self.calls = 0, None
        real_pack, real_dispatch = self.real_pack, self.real_dispatch

        def pack(st, l_rep, R, cap):
            out = real_pack(st, l_rep, R, cap)
            if self.calls is None:          # a tier-2 or tier-3 call
                return out
            valid = torch.arange(st["qb"].shape[1], device=st["n"].device
                                 )[None, :] < st["n"][:, None]
            f = {"caps": st["overflow"].bool()}
            for k, hi in PACK_FIELDS:
                f[k] = (valid & ((st[k] < 0) | (st[k] > hi))).any(dim=1)
            for k, e, b, hi in PACK_SPANS:
                d = st[e].to(torch.int64) - st[b].to(torch.int64)
                f[k] = (valid & ((d < 0) | (d > hi))).any(dim=1)
            B = st["n"].shape[0]
            f["any"] = (out[:B] >> 10) & 1 > 0
            self.calls.append({k: v.cpu().numpy() for k, v in f.items()})
            return out

        def dispatch(batch):
            self.calls = []
            try:
                parts = real_dispatch(batch)
            finally:
                calls, self.calls = self.calls, None
            for (rows, _, n_sub), f in zip(parts, calls):
                n = n_sub if rows is None else len(rows)
                for k in self.counts:
                    self.counts[k] += int(np.count_nonzero(f[k][:n]))
            self.buckets += len(parts)
            return parts
        pipeline._pack, self.aln._dispatch_se = pack, dispatch
        return self

    def __exit__(self, *exc):
        from tpubwa_torch import pipeline
        pipeline._pack = self.real_pack
        del self.aln._dispatch_se
        return False


def long_se_aligner(idx, name):
    """An Aligner on the card at option set ``name`` (bwa's defaults for
    None), the bench world's LUT cache."""
    from tpubwa_torch.pipeline import Aligner
    from tpubwa_torch.tools import bench_world
    opt, _ = set_options(name)
    return Aligner(idx, opt, device=DEVICE, lut_cache=bench_world.lut_path())


def long_se_batches(idx, full: bool) -> dict:
    """Phase 26's batches by letter (LONG_SE; tools/long_reads.py, 5%
    chimeras): values (ReadBatch, records, option set). With ``full``
    (the full call) only (a), at FULL_CALL_LONG_SE reads."""
    import numpy as np
    from tpubwa_torch.io import fastx
    from tpubwa_torch.tools import long_reads
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)
    out = {}
    for k, (n, length, profile, name, seed, width) in LONG_SE.items():
        if full and k != "a":
            continue
        recs = long_reads.long_reads(fwd, FULL_CALL_LONG_SE if full else n,
                                     profile, seed, length=length)
        out[k] = (fastx.batch_reads(recs, max_len=width), recs, name)
    return out


def long_se_run(aln, label: str, batch, card: str) -> dict:
    """Phase 26 on one batch: held_run through align_se (byte-equal to
    the oracle at the aligner's options) with K1's launches logged by
    width and the tier-1 overflow recorded by field; the logged launches
    equal to the wrapper's count. Prints reads/s, bases/s, the fallback
    share, the overflow by field, tier-2/3 rows, the length buckets and
    K1's launches and device ms by width."""
    with kernel_calls(by_width=True) as calls, overflow_fields(aln) as ovf:
        r = held_run(aln, "SE", batch, f"long SE {label}", card)
    r["sam_digest"] = hash_text(r.pop("sam"))
    if calls.total("K1") != r["k1"]:
        raise AssertionError(f"long SE {label}: the logged launches "
                             f"{calls.counts} are not the wrapper's "
                             f"{r['k1']}")
    bases = int(batch.lens.sum())
    ms = calls.width_ms()
    r.update(calls=calls, bases=bases, bases_per_s=bases / r["s"],
             fields=dict(ovf.counts), buckets=ovf.buckets,
             by_width={q: (calls.q_counts[q], ms.get(q, 0.0))
                       for q in sorted(calls.q_counts)})
    print(f"long SE {label}: {batch.n} reads, {bases} bases, "
          f"{r['reads_per_s']:.2f} reads/s, {r['bases_per_s']:.0f} bases/s; "
          f"fallback share {r['fallback']:.5f}; tier-1 overflow "
          f"{r['tier1_ovf']}, by field {r['fields']}; tier-2 rows "
          f"{r['tier2_rows']}, tier-3 rows {r['tier3_rows']}; {ovf.buckets} "
          f"length buckets; K1 (launches, device ms) by width "
          f"{ {q: (n, round(t, 3)) for q, (n, t) in r['by_width'].items()} }"
          f", {sum(ms.values()):.3f} ms in all, "
          f"{100 * sum(ms.values()) / 1e3 / r['s']:.2f}% of the batch's "
          f"{r['s']:.3f} s [{card}]", flush=True)
    if r["fields"]["any"] != r["tier1_ovf"]:
        raise AssertionError(f"long SE {label}: {r['fields']['any']} reads "
                             f"flagged at packing, the aligner counts "
                             f"{r['tier1_ovf']}")
    return r


def long_se_stream(alns: dict, batches: dict, runs: dict, card: str) -> dict:
    """Phase 26's stream: align_se_stream of (a) then (b) under bwa's
    defaults, K1's count set to 0 just before and read just after: (a)'s
    SAM byte-equal to its align_se run, which the oracle held, (b)'s to
    the oracle at the defaults."""
    import torch
    from tpubwa_torch.ops import sw
    aln = alns[None]
    order = [batches["a"][0], batches["b"][0]]
    wants = [runs["a"]["sam_digest"], None]
    orc_b = aln.oracle.align_se(order[1], aln.opt, id0=0)
    aln.stats = {"reads": 0, "fallback_reads": 0}
    torch.cuda.synchronize()
    sw.ksw_extend.launches = 0
    t0 = time.perf_counter()
    got = list(aln.align_se_stream([(b, 0) for b in order]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1 = sw.ksw_extend.launches
    if hash_text(got[0]) != wants[0]:
        raise AssertionError("phase 26 stream: (a) differs from its "
                             "align_se run")
    first_diff(got[1], orc_b, "phase 26 stream: (b) at bwa's defaults "
               "against the oracle")
    n = sum(b.n for b in order)
    print(f"long SE stream (a) then (b) at bwa's defaults ({n} reads): both "
          f"byte-equal (to (a)'s align_se run and to the oracle) in "
          f"{dt:.3f} s ({n / dt:.2f} reads/s); fallback share "
          f"{aln.stats['fallback_reads'] / max(aln.stats['reads'], 1):.5f};"
          f" K1 launches {k1} [{card}]", flush=True)
    if k1 <= 0:
        raise AssertionError("phase 26 stream launched no K1")
    return dict(s=dt, reads_per_s=n / dt, k1=k1)


def hash_text(s: str) -> str:
    import hashlib
    return hashlib.sha256(s.encode()).hexdigest()


def long_se_cli(aln, recs, card: str) -> dict:
    """Phase 26's command line: `python -m tpubwa_torch align idx r.fq
    --platform cuda` with the pacbio flags on the first LONG_SE_CLI reads
    of (b): the header's @SQ lines the index's contigs, the file
    byte-equal to the header + Oracle.align_se at the same options, K1
    launched."""
    from tpubwa_torch.io import fastx
    from tpubwa_torch.tools import bench_world
    from tpubwa_torch.tools.option_sets import SETS
    d = smoke_dir()
    fastx.write_fastq(d / "long.fq", recs[:LONG_SE_CLI])
    se = list(fastx.iter_fastq(d / "long.fq"))
    header = aln.sam_header()
    sq = [l for l in header.splitlines() if l.startswith("@SQ")]
    if sq != [f"@SQ\tSN:{a.name}\tLN:{a.length}" for a in aln.idx.anns]:
        raise AssertionError(f"phase 26 CLI: the header's @SQ lines {sq} "
                             "are not the index's contigs")
    want = header + aln.oracle.align_se(fastx.batch_reads(se), aln.opt,
                                        id0=0)
    t0 = time.time()
    err = run_cli(["align", str(bench_world.BUILD /
                                f"smoke_index_{GENOME_LEN}.npz"),
                   str(d / "long.fq"), "-o", str(d / "long.sam"),
                   "--platform", DEVICE, "--batch-size", str(len(se)),
                   *SETS["pacbio"]], "CLI SE long reads at pacbio")
    wall = time.time() - t0
    first_diff((d / "long.sam").read_text(), want, "CLI SE long reads at "
               "pacbio against the header + Oracle.align_se")
    k1, _ = cli_launches(err)
    print(f"long SE CLI ({' '.join(SETS['pacbio'])}): {len(se)} reads of "
          f"(b), {len(sq)} @SQ line(s) the index's, whole file byte-equal "
          f"to the header + Oracle.align_se; the CLI says: "
          f"{cli_line(err, 'total')}; process wall {wall:.1f} s; K1 "
          f"launches {k1} [{card}]", flush=True)
    if k1 <= 0:
        raise AssertionError("the CLI on long reads launched no K1")
    return dict(wall=wall, k1=k1)


def long_se_phase(card: str, aln=None, full: bool = False) -> dict:
    """Phase 26: long single-end reads on the card (the bench world). The
    batches of long_se_batches through long_se_run, each under its option
    set's Aligner(device="cuda") (``aln`` for bwa's defaults when given);
    without ``full`` also the stream and the command line. Checks that K1
    ran at every width of LONG_SE_WIDTHS that the batches hold. Returns
    the runs."""
    t0 = time.time()
    idx = aln.idx if aln is not None else None
    if idx is None:
        from tpubwa_torch.tools import bench_world
        idx = bench_world.get_index()
    batches = long_se_batches(idx, full)
    alns = {None: aln} if aln is not None else {}
    runs = {}
    for k, (batch, _, name) in batches.items():
        if name not in alns:
            alns[name] = long_se_aligner(idx, name)
        runs[k] = long_se_run(alns[name], LONG_SE_LABELS[k], batch, card)
    widths = {q for r in runs.values() for q in r["by_width"]}
    missing = [q for q in LONG_SE_WIDTHS[:1 if full else None]
               if q not in widths]
    if missing:
        raise AssertionError(f"phase 26 ran K1 at no width {missing}")
    if not full:
        runs["stream"] = long_se_stream(alns, batches, runs, card)
        runs["cli"] = long_se_cli(alns["pacbio"], batches["b"][1], card)
    print(f"phase 26 took {time.time() - t0:.1f} s [{card}]", flush=True)
    return runs


def long_se_entries(runs: dict, card: str) -> list:
    """Phase 6 for phase 26: K1 on its first call at each width of
    LONG_SE_WIDTHS that the batches ran (the first batch in letter order
    that holds it), held to its plain version (timed once) and timed
    beside its bound; the launches are K1's at that width over the
    phase's batches."""
    out = []
    for q in LONG_SE_WIDTHS:
        ks = [k for k in sorted(runs) if q in runs[k].get("by_width", {})]
        if not ks:
            continue
        n_l = sum(runs[k]["by_width"][q][0] for k in ks)
        path = (f"SE long reads, Q={q}, generic ring instance (phase 26, "
                f"{', '.join(ks)})")
        args = runs[ks[0]]["calls"].q_first[q]
        if q == max(LONG_SE_WIDTHS):
            # (e)'s reads overflow the seeding caps, so its calls at this
            # width extend no live task: the kernel runs full-width tasks
            args = full_width_tasks(q, LONG_SE_FULL_TASKS, 66)
            path += f", on {LONG_SE_FULL_TASKS} full-width tasks"
        out.append(k1_entry(f"ksw_extend_se{q}", path, args, n_l, card))
    return out


# Phase 27: mate-pair libraries on the bench world (tools/mate_pairs.py).
# Batch letter -> (pairs, read length, mate_pairs keywords, seed): (a) a
# gel-selected library, (b) an unfractionated one with junction reads, (c)
# the same at 2x300 (MiSeq v3), (d) bimodal inserts, whose RF window is
# pestat's widest (T above 32 k); (a)-(c) with 15% FR contamination.
MATE_PAIR = {
    "a": (2048, 150, dict(profile="gel", mean=3000, sd=300, fr_share=0.15,
                          rescue=64), 81),
    "b": (2048, 150, dict(profile="unfractionated", fr_share=0.15,
                          rescue=64, junction_share=0.05), 82),
    "c": (1024, 300, dict(profile="unfractionated", fr_share=0.15,
                          rescue=64), 83),
    "d": (256, 150, dict(profile="bimodal", fr_share=0.0, rescue=32), 84)}
MATE_PAIR_LABELS = {"a": "(a) 2x150 gel 3000 +- 300",
                    "b": "(b) 2x150 unfractionated, junction reads",
                    "c": "(c) 2x300 unfractionated",
                    "d": "(d) 2x150 bimodal"}
MATE_PAIR_CLI = 512         # the command line's pairs of (b), interleaved
FULL_CALL_MATE_PAIR = 256   # the full call: (b) at 256 pairs ...
FULL_CALL_MATE_PAIR_RESCUE = 16   # ... with 16 rescue pairs
# K2's widest windows before the row maxima left shared memory, rounded
# to the rescue's 256: the register instances' (any Q) and the generic
# instance's at Q = 300
OLD_K2_T = {150: 14336, 300: 13056}
WIDE_K2_T = 40960           # past pestat's widest window at max_ins
WIDE_K2_TASKS = 16          # tasks of the T = 40,960 entries
BIMODAL_T = 32768           # (d)'s window passes it


def mate_pair_batches(idx, full: bool) -> dict:
    """Phase 27's batches by letter: (pairs, read length, ReadBatch,
    records); with ``full`` (the full call) only (b), at
    FULL_CALL_MATE_PAIR pairs."""
    import numpy as np
    from tpubwa_torch.io import fastx
    from tpubwa_torch.tools import mate_pairs
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)
    out = {}
    for k, (n, L, kw, seed) in MATE_PAIR.items():
        if full and k != "b":
            continue
        if full:
            n, kw = FULL_CALL_MATE_PAIR, dict(
                kw, rescue=FULL_CALL_MATE_PAIR_RESCUE)
        recs = mate_pairs.mate_pairs(fwd, n, L, seed, **kw)
        out[k] = (n, L, fastx.batch_reads(recs, max_len=L), recs)
    return out


def pestat_line(pes) -> str:
    return "; ".join(f"{r['orientation']} low {r['low']} high {r['high']} "
                     f"failed {r['failed']} (n {r['n']})" for r in pes)


def mate_pair_run(aln, label: str, batch, card: str) -> dict:
    """Phase 27 on one batch: held_run (align_pe, byte-equal to the
    oracle, no rescue result missing) with every launch logged
    (kernel_calls) and the insert histogram kept; prints the properly
    paired share of the records, pestat's low, high and failed for each
    orientation (tools/mate_pairs.py's mirror of native/pe.cpp), the
    rescue calls' T, K2's launches and device ms by (pass, Q, T) and
    K1's. Returns the numbers, the SAM and the log."""
    from tpubwa_torch.tools import mate_pairs
    hists = []
    real = aln._pe_hist

    def keep(ctx):
        hists.append(real(ctx))
        return hists[-1]
    aln._pe_hist = keep
    try:
        with kernel_calls() as calls:
            r = held_run(aln, "PE", batch, f"mate pair {label}", card)
    finally:
        del aln._pe_hist
    if (calls.total("K1"), calls.total("K2 fwd", "K2 rev")) != \
            (r["k1"], r["k2"]):
        raise AssertionError(f"mate pair {label}: the logged launches "
                             f"{calls.counts} are not the wrappers' K1 "
                             f"{r['k1']} and K2 {r['k2']}")
    flags = [int(l.split("\t", 2)[1]) for l in r["sam"].splitlines()]
    proper = sum(f & 0x2 != 0 for f in flags) / max(len(flags), 1)
    supp = sum(f & 0x800 != 0 for f in flags)
    pes = mate_pairs.pestat(hists[0], aln.opt.max_ins)
    ms, k2ms = calls.kernel_ms(), calls.k2_shape_ms()
    k1ms = sum(v for k, v in ms.items() if k.startswith("K1"))
    k2 = {f"{p} Q={q} T={t}": (n, round(k2ms.get((p, q, t), 0.0), 3))
          for (p, q, t), n in sorted(calls.k2_by_shape.items())}
    Ts = sorted({t for _, t in calls.k2_shapes})
    print(f"mate pair {label}: {r['reads_per_s']:.1f} reads/s, fallback "
          f"share {r['fallback']:.5f}, tier1 overflow {r['tier1_ovf']}; "
          f"rescue tasks {r['rescue_tasks']}; properly paired "
          f"{proper:.4f} of {len(flags)} records, {supp} supplementary; "
          f"pestat {pestat_line(pes)}; rescue T {Ts}; K2 (launches, device "
          f"ms) by pass and shape {k2}; K1 {calls.total('K1')} launches "
          f"{calls.by('K1')}, {k1ms:.3f} device ms [{card}]", flush=True)
    r.update(calls=calls, pestat=pes, proper=proper, supp=supp, T=Ts,
             k2_shape=k2)
    return r


def mate_pair_checks(runs: dict, batches: dict):
    """Phase 27's checks on what ran: RF live in pestat in every batch and
    FR in those with contamination; K2 forward and reverse launched in
    every batch; (b) at K=5 past OLD_K2_T[150], (c) in the generic
    instance past OLD_K2_T[300], (d) past BIMODAL_T."""
    from tpubwa_torch.ops import sw_local
    bad = []
    for k, r in runs.items():
        c = r["calls"]
        live = {p["orientation"] for p in r["pestat"] if not p["failed"]}
        fr = MATE_PAIR[k][2]["fr_share"] > 0
        if "RF" not in live or fr != ("FR" in live):
            bad.append(f"{MATE_PAIR_LABELS[k]}: live orientations {live}")
        if not (c.total("K2 fwd") and c.total("K2 rev")):
            bad.append(f"{MATE_PAIR_LABELS[k]}: K2 forward {c.by('K2 fwd')}"
                       f", reverse {c.by('K2 rev')}")
        L = batches[k][1]
        need = {"b": (5, OLD_K2_T[150]), "c": (0, OLD_K2_T[300]),
                "d": (5, BIMODAL_T)}.get(k)
        if need and not any(
                p == "forward" and t > need[1]
                and sw_local.kernel_instance(q) == need[0]
                for p, q, t in c.k2_by_shape):
            bad.append(f"{MATE_PAIR_LABELS[k]}: no K2 forward call of "
                       f"instance {instance_name(need[0])} past T = "
                       f"{need[1]} at Q = {L} ({sorted(c.k2_by_shape)})")
    if bad:
        raise AssertionError("phase 27: " + "; ".join(bad))


def mate_pair_stream(aln, batches: dict, runs: dict, card: str) -> dict:
    """Phase 27's stream: align_pe_stream over (a) and (b), each numbered
    from pair 0, kernel counts set to 0 just before and read just after:
    each batch's SAM byte-equal to its align_pe run, which the oracle
    held; no rescue result missing; K1 and K2 launched."""
    import torch
    from tpubwa_torch.ops import sw, sw_local
    order = [batches[k][2] for k in "ab"]
    lib = aln.oracle._lib
    lib.tb_rescue_miss_reset()
    torch.cuda.synchronize()
    sw.ksw_extend.launches = sw_local.ksw_local.launches = 0
    t0 = time.perf_counter()
    got = list(aln.align_pe_stream([(b, 0) for b in order]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k2 = sw.ksw_extend.launches, sw_local.ksw_local.launches
    misses = lib.tb_rescue_miss_count()
    for k, g in zip("ab", got):
        first_diff(g, runs[k]["sam"], f"phase 27 stream batch ({k}) against "
                   "its align_pe run")
    n = sum(b.n for b in order)
    print(f"mate pair stream (a), (b) ({n} reads): every batch byte-equal "
          f"to align_pe and the oracle in {dt:.3f} s ({n / dt:.1f} "
          f"reads/s); rescue results missing {misses}; K1 launches {k1}, "
          f"K2 {k2} [{card}]", flush=True)
    if misses or k1 <= 0 or k2 <= 0:
        raise AssertionError(f"phase 27 stream: {misses} rescue results "
                             f"missing, K1 {k1}, K2 {k2} launches")
    return dict(s=dt, reads_per_s=n / dt, k1=k1, k2=k2)


def mate_pair_cli(aln, recs, card: str) -> dict:
    """Phase 27's command line: `python -m tpubwa_torch align idx mp.fq
    -p --platform cuda` on the first MATE_PAIR_CLI pairs of (b) in one
    interleaved FASTQ: the header's @SQ lines the index's contigs, the
    file byte-equal to the header + Oracle.align_pe, K1 and K2
    launched."""
    from tpubwa_torch.io import fastx
    from tpubwa_torch.tools import bench_world
    d = smoke_dir()
    fastx.write_fastq(d / "mp.fq", recs[:2 * MATE_PAIR_CLI])
    pe = list(fastx.iter_fastq(d / "mp.fq"))
    header = aln.sam_header()
    sq = [l for l in header.splitlines() if l.startswith("@SQ")]
    if sq != [f"@SQ\tSN:{a.name}\tLN:{a.length}" for a in aln.idx.anns]:
        raise AssertionError(f"phase 27 CLI: the header's @SQ lines {sq} "
                             "are not the index's contigs")
    want = header + aln.oracle.align_pe(
        fastx.batch_reads(pe, max_len=PE_READ_LEN), aln.opt, id0=0)[0]
    t0 = time.time()
    err = run_cli(["align", str(bench_world.BUILD /
                                f"smoke_index_{GENOME_LEN}.npz"),
                   str(d / "mp.fq"), "-p", "-o", str(d / "mp.sam"),
                   "--platform", DEVICE, "--batch-size", str(len(pe))],
                  "CLI PE, mate pairs")
    wall = time.time() - t0
    first_diff((d / "mp.sam").read_text(), want, "CLI PE SAM of mate pairs "
               "against the header + Oracle.align_pe")
    k1, k2 = cli_launches(err)
    print(f"mate pair CLI -p: {len(pe) // 2} pairs of (b), {len(sq)} @SQ "
          f"line(s) the index's, whole file byte-equal to the header + "
          f"Oracle.align_pe; the CLI says: {cli_line(err, 'total')}; "
          f"process wall {wall:.1f} s; K1 launches {k1}, K2 launches {k2} "
          f"[{card}]", flush=True)
    if k1 <= 0 or k2 <= 0:
        raise AssertionError(f"the CLI on mate pairs launched K1 {k1} and "
                             f"K2 {k2} times")
    return dict(wall=wall, k1=k1, k2=k2)


def wide_k2_tasks(n: int, Q: int, T: int, seed: int) -> tuple:
    """n K2 tasks on the card of query width Q and a full target of T
    bases: the query planted near the target's end with 2 errors and
    again far before it with 6 (a second run outside [te - qlen, te +
    qlen], so score2 and te2 are live), the rescue's minimum score."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 4, (n, Q)).astype(np.int32)
    ts = rng.integers(0, 4, (n, T)).astype(np.int32)
    for i in range(n):
        for off, nerr in ((int(rng.integers(T - 3 * Q, T - Q)), 2),
                          (int(rng.integers(Q, T // 2)), 6)):
            hit = qs[i].copy()
            pos = rng.choice(Q, nerr, replace=False)
            hit[pos] = (hit[pos] + 1) % 4
            ts[i, off:off + Q] = hit
    c = lambda a: torch.as_tensor(a, dtype=torch.int32).to(DEVICE)  # noqa
    return (c(qs), c([Q] * n), c(ts), c([T] * n), c([19] * n), c([1] * n))


def mate_pair_phase(card: str, aln=None, full: bool = False) -> dict:
    """Phase 27: mate-pair libraries on the card (the bench world,
    Aligner(idx, device="cuda")). Without ``full``: first K2 on
    WIDE_K2_TASKS tasks at T = 40,960 (wide_entries), then (a)-(d) of
    mate_pair_batches through mate_pair_run, mate_pair_checks, the stream
    of (a) and (b) and the command line on (b); with ``full`` (b) at
    FULL_CALL_MATE_PAIR pairs and its checks. Returns the runs."""
    t0 = time.time()
    wide = [] if full else wide_entries(card)
    if aln is None:
        aln = make_aligner()
    batches = mate_pair_batches(aln.idx, full)
    runs = {k: mate_pair_run(aln, MATE_PAIR_LABELS[k], b[2], card)
            for k, b in batches.items()}
    mate_pair_checks(runs, batches)
    if not full:
        runs["stream"] = mate_pair_stream(aln, batches, runs, card)
        runs["cli"] = mate_pair_cli(aln, batches["b"][3], card)
    for r in runs.values():
        r.pop("sam", None)
    # the T = 40,960 entries count the phase's launches past BIMODAL_T
    runs["wide"] = [e[:4] + (sum(
        n for r in runs.values() if "calls" in r
        for (p, _, t), n in r["calls"].k2_by_shape.items()
        if p == ("forward" if e[6] else "reverse") and t > BIMODAL_T),
        e[5]) for e in wide]
    print(f"phase 27 took {time.time() - t0:.1f} s [{card}]", flush=True)
    return runs


def wide_entries(card: str) -> list:
    """K2 on WIDE_K2_TASKS tasks at T = 40,960 (wide_k2_tasks): the
    forward pass at Q = 150 (K=5) and Q = 300 (generic), the reverse pass
    at Q = 150 on the prefixes the forward results give, each held to its
    plain version (timed once) and timed beside its bound. Each entry
    carries its want_sub last; its launches are filled in later."""
    from tpubwa_torch.ops import sw_local
    out = []
    for Q, want_sub, name in ((150, True, "ksw_local_t40960"),
                              (300, True, "ksw_local_t40960_q300"),
                              (150, False, "ksw_local_t40960_rev")):
        args = wide_k2_tasks(WIDE_K2_TASKS, Q, WIDE_K2_T, 270 + Q)
        if not want_sub:
            args = reverse_pass_args(args, sw_local.ksw_local(
                *args, want_sub=True, **SCORING))
        p = "forward" if want_sub else "reverse"
        out.append(k2_entry(
            name, f"{p} pass at Q={Q}, T={WIDE_K2_T} on {WIDE_K2_TASKS} "
            f"tasks, {instance_name(sw_local.kernel_instance(Q))} (phase "
            f"27; launches: the phase's {p} calls past T={BIMODAL_T})",
            args, 0, card, want_sub=want_sub) + (want_sub,))
    return out


def mate_pair_entries(runs: dict, card: str) -> list:
    """Phase 6 for phase 27: K2's first forward call on (b) (Q = 150, K=5)
    and on (c) (Q = 300, generic) at the batch's widest T, each held to
    its plain version (timed once) and timed beside its bound, with the
    batch's K2 forward launches at that Q; then the T = 40,960 entries of
    wide_entries, if they ran."""
    from tpubwa_torch.ops import sw_local
    out = []
    for k, name in (("b", "ksw_local_mp150"), ("c", "ksw_local_mp300")):
        if k not in runs:
            continue
        c = runs[k]["calls"]
        sk = max((s for s in c.k2_by_shape if s[0] == "forward"),
                 key=lambda s: s[2])
        n_l = sum(n for s, n in c.k2_by_shape.items()
                  if s[0] == "forward" and s[1] == sk[1])
        out.append(k2_entry(
            name, f"PE mate pairs {MATE_PAIR_LABELS[k]}, forward pass at "
            f"T={sk[2]}, {instance_name(sw_local.kernel_instance(sk[1]))} "
            f"(phase 27)", c.k2_first[sk], n_l, card))
    return out + runs["wide"]


def reverse_pass_args(args, fwd) -> tuple:
    """ksw_align_batch's reverse-pass inputs from the forward results: the
    reversed (qe, te) prefixes, qe + 1 and te + 1 long."""
    import torch
    from tpubwa_torch.pair.rescue import _rev_prefix
    q, _, t, _, minsc, valid = args
    score, te, qe = fwd[:, 0], fwd[:, 1], fwd[:, 2]
    need = (valid != 0) & (score >= minsc) & (te >= 0)
    rq = _rev_prefix(q, torch.where(need, qe, 0)).contiguous()
    rt = _rev_prefix(t, torch.where(need, te, 0)).contiguous()
    return (rq, (qe + 1).to(torch.int32), rt, (te + 1).to(torch.int32),
            torch.full_like(minsc, 0x10000), need.to(torch.int32))


def full_width_tasks(Q: int, n: int, seed: int) -> tuple:
    """n K1 tasks of width Q on the card that extend over the whole width:
    a random target of Q + 200 bases, a query cut from it under
    tools/long_reads.py's hifi errors, h0 a seed's score, bwa's default
    band and end bonus."""
    import numpy as np
    import torch
    from tpubwa_torch.tools import long_reads
    rng = np.random.default_rng(seed)
    T = Q + 200
    ta = rng.integers(0, 4, (n, T)).astype(np.int32)
    qa = np.full((n, Q), 4, np.int32)
    for i in range(n):
        q = long_reads.mutate(ta[i], rng, "hifi")[:Q]
        qa[i, :len(q)] = q
    c = lambda a: torch.as_tensor(a, dtype=torch.int32).to(DEVICE)  # noqa
    return (c(qa), c([Q] * n), c(ta), c([T] * n),
            c(rng.integers(20, 60, n)), c([100] * n), c([5] * n),
            c([1] * n))


def k1_entry(name: str, path: str, args, n_l: int, card: str,
             scoring=None, zdrop=100) -> tuple:
    """K1 on a path's first call (``args``), held to its plain version and
    timed beside its bound, at ``scoring`` and ``zdrop`` (bwa's defaults
    unless given); ``n_l`` is the path's launch count."""
    r = k1_measure(args, zdrop=zdrop, generic=True, scoring=scoring)
    print(f"K1 {name} first call N={args[0].shape[0]} "
          f"Q={args[0].shape[1]} T={args[2].shape[1]}: max_abs_err="
          f"{r['max_abs_err']} (tolerance 0) kernel {r['ms']:.4f} ms, "
          f"generic instance {r['generic_ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
          f"({r['bound_by']}: {r['cells']} band cells, {r['bytes']} "
          f"bytes); {n_l} launches on the path [{card}]", flush=True)
    if r["max_abs_err"] != 0:
        raise AssertionError(f"K1 differs from ksw_extend_ref on {name}'s "
                             "inputs")
    return name, path, "ksw_extend.cu", 86, n_l, r


def diag_entry(diag, card: str) -> tuple:
    """Phase 6 for phase 16: K1 on its first call."""
    return k1_entry("ksw_extend_diag", "overflow diagnostics, 4.6 and "
                    f"{SCALE_MBP} Mbp (phase 16)", diag["first"], diag["k1"],
                    card)


def new_path_entries(longr, i64, scale, card: str) -> list:
    """Phase 6 for this slice's paths: K1 on the first call of the long,
    int64 and 64 Mbp paths and K2 on the 64 Mbp PE row's first forward
    call, each held to its plain version and timed beside its bound."""
    out = [k1_entry(*e, card) for e in (
        ("ksw_extend_long", "SE 250 bp and mixed 76-250 bp (phase 13)",
         longr["first"], longr["k1"]),
        ("ksw_extend_int64", "SE + PE, int64 positions (phase 14)",
         i64["first"], i64["k1"]),
        ("ksw_extend_scale", f"SE 100 bp, {SCALE_MBP} Mbp (phase 15)",
         scale["first"], scale["k1"]))]
    out.append(k2_entry("ksw_local_scale", f"PE rescue, forward pass, "
                        f"{SCALE_MBP} Mbp (phase 15)", scale["k2_first"],
                        scale["k2"], card))
    return out


def k2_entry(name: str, path: str, args, n_l: int, card: str,
             scoring=None, want_sub: bool = True) -> tuple:
    """K2 on a path's first forward call (``args``; the first reverse call
    without ``want_sub``), held to its plain version and timed beside its
    bound, at ``scoring`` (bwa's defaults unless given); ``n_l`` is the
    path's launch count."""
    m = k2_measure(args, want_sub, generic=True, scoring=scoring)
    print(f"K2 {name} first {'forward' if want_sub else 'reverse'} call "
          f"N={args[0].shape[0]} "
          f"Q={args[0].shape[1]} T={args[2].shape[1]}: max_abs_err="
          f"{m['max_abs_err']} (tolerance 0) kernel {m['ms']:.4f} ms, "
          f"generic instance {m['generic_ms']:.4f} ms, plain "
          f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.6f} ms "
          f"({m['bound_by']}: {m['cells']} cells, {m['bytes']} bytes); "
          f"{n_l} launches on the path [{card}]", flush=True)
    if m["max_abs_err"] != 0:
        raise AssertionError(f"K2 differs from ksw_local_ref on {name}'s "
                             "inputs")
    return name, path, "ksw_local.cu", 231, n_l, m


def kernel_entry(name, path, src, line, n_l, sweep_err, m) -> dict:
    """One entry of the {"kernels": [...]} line."""
    return {"name": name, "path": path, "route": "cuda",
            "source": f"tpubwa_torch/csrc/{src}",
            "replaces": f"tpubwa/ops/sw_pallas.py:{line}",
            "launches": n_l,
            "max_abs_err": max(sweep_err, m["max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "generic_ms": m["generic_ms"]}


def timed_phase(label: str, fn, *args):
    """Run a phase and print its seconds."""
    t0 = time.time()
    out = fn(*args)
    print(f"phase {label}: {time.time() - t0:.1f} s", flush=True)
    return out


def beside_build(prep, t_prep: float):
    """timed_phase for the phases that run while the 64 Mbp build process
    ``prep`` may still run: after each, whether the build still ran, so
    that the times taken beside it are known."""
    def run(label: str, fn, *args):
        out = timed_phase(label, fn, *args)
        state = ("still running" if prep.poll() is None
                 else f"ended (exit {prep.returncode})")
        print(f"64 Mbp build process: {state} at the end of phase {label}, "
              f"{time.time() - t_prep:.1f} s after its start", flush=True)
        return out
    return run


def stop(proc):
    """End a process this script started, if it still runs."""
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()


def main() -> int:
    t_call = time.time()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "tpubwa_torch" / "csrc" / "ksw_local.cu").exists():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from tpubwa_torch.tools.scale_bench import card_line
    card = card_line()
    print(f"card: {card}", flush=True)
    # the full call and pe_window build the bench world's caches beside
    # phases 1-2
    bprep = start_bench_prepare() \
        if sys.argv[1:] in ([], ["pe_window"], ["options"], ["contigs"],
                            ["long_pe"], ["long_se"], ["mate_pair"]) \
        else None
    atexit.register(stop, bprep)
    timed_phase("1 (build)", build)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if sys.argv[1:] == ["slice"]:
        aln = make_aligner()
        cli_phases(aln, card)
        multihost_phase(aln, card)
        anchor_phase(aln, card)
        dist_phase(aln, card)
        print(f"{card}")
        print(json.dumps({"ok": True, "device": device,
                          "phases": "build and phases 7-12 only"}))
        return 0
    if sys.argv[1:] == ["diag"]:
        prep = start_scale_prepare()
        phase = beside_build(prep, time.time())
        try:
            aln = phase("16 set-up (4.6 Mbp index and LUT)", make_aligner)
            g, aln64, _ = timed_phase("16 set-up (64 Mbp world)",
                                      scale_world, card, prep, "16")
        finally:
            stop(prep)
        diag = timed_phase("16 (diag)", diag_phase, aln, aln64, g, card)
        e = diag_entry(diag, card)
        print(json.dumps({"kernels": [kernel_entry(*e[:5], 0, e[5])]}))
        print(f"{card}")
        print(f"whole call: {time.time() - t_call:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": device,
                          "phases": "build and phase 16 only"}))
        return 0
    if sys.argv[1:] == ["profile"]:
        prep = start_scale_prepare()
        try:
            aln = timed_phase("17 set-up (4.6 Mbp index and LUT)",
                              make_aligner)
            # the 64 Mbp build ends before phase 17, so that no host work
            # runs beside the tools' timings
            _, aln64, _ = timed_phase("18 set-up (64 Mbp world)",
                                      scale_world, card, prep, "17")
        finally:
            stop(prep)
        prof = timed_phase("17 (profile)", profile_phase, aln, card)
        timed_phase("18 (rehearsal)", rehearsal_phase, aln64, card)
        print(json.dumps({"kernels": [kernel_entry(*e[:5], 0, e[5])
                                      for e in profile_entries(prof, card)]}))
        print(f"{card}")
        print(f"whole call: {time.time() - t_call:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": device,
                          "phases": "build and phases 17-18 only"}))
        return 0
    if sys.argv[1:] == ["bench"]:
        timed_phase("19 (bench)", bench_phase, card)
        # after phase 19's subprocess has built the bench world's caches
        timed_phase("21 (stream)", bench_stream_phase, card)
        dry = timed_phase("20 (dryrun)", dryrun_phase, card)
        e = dryrun_entry(dry, card)
        print(json.dumps({"kernels": [kernel_entry(*e[:5], 0, e[5])]}))
        print(f"{card}")
        print(f"whole call: {time.time() - t_call:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": device,
                          "phases": "build and phases 19-21 only"}))
        return 0
    if sys.argv[1:] == ["options"]:
        from tpubwa_torch.tools.option_sets import NAMES
        wait_prepare(bprep, "bench world prepare", card)
        opts = timed_phase("23 (options)", options_phase, card, NAMES, NAMES,
                           OPTION_SE_READS, OPTION_PE_PAIRS)
        print(json.dumps({"kernels": option_kernels(opts, NAMES, card)}))
        print(f"{card}")
        print(f"whole call: {time.time() - t_call:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": device,
                          "phases": "build and phase 23 only"}))
        return 0
    if sys.argv[1:] == ["contigs"]:
        wait_prepare(bprep, "bench world prepare", card)
        ctg = timed_phase("24 (contigs)", contigs_phase, card,
                          CONTIG_SE_READS, CONTIG_PE_PAIRS, CONTIG_EDGES,
                          None, True)
        print(json.dumps({"kernels": [kernel_entry(*e[:5], 0, e[5])
                                      for e in contig_entries(ctg, card)]}))
        print(f"{card}")
        print(f"whole call: {time.time() - t_call:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": device,
                          "phases": "build and phase 24 only"}))
        return 0
    if sys.argv[1:] == ["long_pe"]:
        wait_prepare(bprep, "bench world prepare", card)
        lpe = timed_phase("25 (long PE)", long_pe_phase, card)
        print(json.dumps({"kernels": [kernel_entry(*e[:5], 0, e[5])
                                      for e in long_pe_entries(lpe, card)]}))
        print(f"{card}")
        print(f"whole call: {time.time() - t_call:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": device,
                          "phases": "build and phase 25 only"}))
        return 0
    if sys.argv[1:] == ["long_se"]:
        wait_prepare(bprep, "bench world prepare", card)
        lse = timed_phase("26 (long SE)", long_se_phase, card)
        print(json.dumps({"kernels": [kernel_entry(*e[:5], 0, e[5])
                                      for e in long_se_entries(lse, card)]}))
        print(f"{card}")
        print(f"whole call: {time.time() - t_call:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": device,
                          "phases": "build and phase 26 only"}))
        return 0
    if sys.argv[1:] == ["mate_pair"]:
        wait_prepare(bprep, "bench world prepare", card)
        mpr = timed_phase("27 (mate pairs)", mate_pair_phase, card)
        print(json.dumps({"kernels": [kernel_entry(*e[:5], 0, e[5])
                                      for e in mate_pair_entries(mpr, card)]}))
        print(f"{card}")
        print(f"whole call: {time.time() - t_call:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": device,
                          "phases": "build and phase 27 only"}))
        return 0
    if sys.argv[1:] == ["pe_window"]:
        wait_prepare(bprep, "bench world prepare", card)
        timed_phase("22 (PE window)", pe_window_phase, card)
        print(f"{card}")
        print(f"whole call: {time.time() - t_call:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": device,
                          "phases": "build and phase 22 only"}))
        return 0
    if sys.argv[1:] == ["scale"]:
        prep = start_scale_prepare()
        phase = beside_build(prep, time.time())
        try:
            aln = phase("13 set-up (4.6 Mbp index and LUT)", make_aligner)
            longr = phase("13 (long)", long_phase, aln, card)
            i64 = phase("14 (int64)", int64_phase, aln, card)
            scale = timed_phase("15 (scale)", scale_phase, card, prep)
        finally:
            stop(prep)
        kernels = [kernel_entry(*e[:5], 0, e[5])
                   for e in new_path_entries(longr, i64, scale, card)]
        print(json.dumps({"kernels": kernels}))
        print(f"{card}")
        print(f"whole call: {time.time() - t_call:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": device,
                          "phases": "build and phases 13-15 only"}))
        return 0
    worst = timed_phase("2 (K1 parity)", parity, card)
    worst2 = timed_phase("2 (K2 parity)", parity_k2, card)
    timed_phase("2 (row latency)", row_latency, card)
    if sys.argv[1:] == ["kernels"]:
        print(f"{card}")
        print(json.dumps({"ok": True, "device": device,
                          "phases": "build, parity and row latency only"}))
        return 0
    wait_prepare(bprep, "bench world prepare", card)
    aln, k1_args, launches, rps, (timed_se, wants) = timed_phase(
        "3 (e2e SE)", e2e, card)
    # phase 21, one pass over phase 3's timed batches, before any build
    # process runs beside it and before phase 4's profiler trace
    stream = timed_phase("21 (stream)", stream_phase, aln, timed_se, wants,
                         BATCH, card, (TIMED_BATCHES,), 1, "bd")
    # (a), the stream, over the same batches is phase 3's timed run
    stream[("a", TIMED_BATCHES)] = [BATCH / rps]
    timed_phase("4 (stages)", se_stages, aln, timed_se, card)
    k1_pe_args, k2_fwd, k2_rev, pe_k1, pe_k2, pe_rps = timed_phase(
        "5 (e2e PE)", pe_e2e, aln, card)
    # phase 23, before the 64 Mbp build process starts beside phases 7-14
    from tpubwa_torch.tools.option_sets import NAMES
    opts = timed_phase("23 (options)", options_phase, card, NAMES,
                       FULL_CALL_OPTION_SETS, FULL_CALL_OPTION_SE_READS,
                       FULL_CALL_OPTION_PE_PAIRS, aln.idx, True)
    # phase 24, also before the 64 Mbp build process starts
    ctg = timed_phase("24 (contigs)", contigs_phase, card,
                      FULL_CALL_CONTIG_SE_READS, FULL_CALL_CONTIG_PE_PAIRS,
                      FULL_CALL_CONTIG_EDGES, aln.idx)
    # phase 25's short piece, also before the 64 Mbp build process starts
    lpe = timed_phase("25 (long PE)", long_pe_phase, card, aln, True)
    # phase 26's short piece, also before the 64 Mbp build process starts
    lse = timed_phase("26 (long SE)", long_se_phase, card, aln, True)
    # phase 27's short piece, also before the 64 Mbp build process starts
    mpr = timed_phase("27 (mate pairs)", mate_pair_phase, card, aln, True)
    # the 64 Mbp caches (and phase 20's 2 Mbp ones) build on the host
    # while phases 7-14 run
    prep = start_scale_prepare()
    dprep = start_dryrun_prepare()
    phase = beside_build(prep, time.time())
    try:
        t_new = time.time()
        cli_res = phase("7-9 (CLI)", cli_phases, aln, card, False)
        phase("10 (multihost)", multihost_phase, aln, card)
        anc = phase("11 (anchor)", anchor_phase, aln, card)
        phase("12 (dist)", dist_phase, aln, card)
        print(f"phases 7-12 (CLI, shards, multihost, anchor, dist) took "
              f"{time.time() - t_new:.1f} s", flush=True)
        longr = phase("13 (long)", long_phase, aln, card,
                      FULL_CALL_MIXED_READS)
        i64 = phase("14 (int64)", int64_phase, aln, card, False)
        scale = timed_phase("15 (scale)", scale_phase, card, prep,
                            FULL_CALL_SCALE_READS, FULL_CALL_SCALE_PE_PAIRS,
                            False)
        wait_prepare(dprep, "dryrun --prepare", card)
    finally:
        stop(prep)
        stop(dprep)
    diag = timed_phase("16 (diag)", diag_phase, aln, scale["aln"],
                       scale["g"], card, FULL_CALL_VARIANTS,
                       FULL_CALL_SCALE_VARIANTS, FULL_CALL_TUNE_REPS, False)
    prof = timed_phase("17 (profile)", profile_phase, aln, card,
                       FULL_CALL_REPS, FULL_CALL_PE_PAIRS, False,
                       FULL_CALL_PARITY_READS, FULL_CALL_PROFILE_READS)
    timed_phase("18 (rehearsal)", rehearsal_phase, scale["aln"], card)
    bench = timed_phase("19 (bench)", bench_phase, card,
                        FULL_CALL_BENCH_TIMED, FULL_CALL_BENCH_BATCH)
    dry = timed_phase("20 (dryrun)", dryrun_phase, card,
                      FULL_CALL_LOAD_PER_DEV)
    t6 = time.time()
    r1 = {}
    for path, args, n_l in (("SE", k1_args, launches),
                            ("PE", k1_pe_args, pe_k1)):
        r1[path] = r = k1_measure(args, generic=True)
        print(f"K1 {path} main-path call N={args[0].shape[0]} "
              f"Q={args[0].shape[1]} T={args[2].shape[1]}: max_abs_err="
              f"{r['max_abs_err']} (tolerance 0) kernel {r['ms']:.4f} ms, "
              f"generic instance {r['generic_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}: {r['cells']} band cells, {r['bytes']} "
              f"bytes); {n_l} launches on the {path} path [{card}]",
              flush=True)
        if r["max_abs_err"] != 0:
            raise AssertionError(f"K1 differs from ksw_extend_ref on the "
                                 f"{path} main-path inputs")
    r2 = {}
    for want_sub, args in ((True, k2_fwd), (False, k2_rev)):
        r2[want_sub] = m = k2_measure(args, want_sub, generic=True)
        print(f"K2 main-path {'forward' if want_sub else 'reverse'} call "
              f"N={args[0].shape[0]} Q={args[0].shape[1]} "
              f"T={args[2].shape[1]}: max_abs_err={m['max_abs_err']} "
              f"(tolerance 0) kernel {m['ms']:.4f} ms, generic instance "
              f"{m['generic_ms']:.4f} ms, plain "
              f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.6f} ms "
              f"({m['bound_by']}: {m['cells']} cells, {m['bytes']} bytes); "
              f"{pe_k2[want_sub]} launches on the PE path [{card}]",
              flush=True)
        if m["max_abs_err"] != 0:
            raise AssertionError("K2 differs from ksw_local_ref on the "
                                 "main-path inputs")
    new = new_path_entries(longr, i64, scale, card) + \
        [diag_entry(diag, card)] + profile_entries(prof, card) + \
        [dryrun_entry(dry, card)] + contig_entries(ctg, card) + \
        long_pe_entries(lpe, card) + long_se_entries(lse, card) + \
        mate_pair_entries(mpr, card)
    opt_kernels = option_kernels(opts, FULL_CALL_OPTION_SETS, card)
    print(f"phase 6 (kernels): {time.time() - t6:.1f} s", flush=True)
    # one entry per kernel and path: K1 on the SE and the PE path (other
    # shapes, its own launch count), K2's two template instances, then
    # the later slices' paths: K1 on the long, int64 and 64 Mbp paths, K2
    # on the 64 Mbp PE row, K1 in phase 16, K1 and K2 in phase 17, K1 in
    # phase 20, K1 and K2 in phase 24, K1 and K2 (both passes, and at
    # T >= 2048) at 2x300 in phase 25, K1 at Q = 4096 in phase 26, K2 at
    # Q = 150 past T = 14,336 in phase 27 (then phase 23's)
    kernels = [
        kernel_entry("ksw_extend", "SE", "ksw_extend.cu", 86, launches,
                     worst, r1["SE"]),
        kernel_entry("ksw_extend_pe", "PE", "ksw_extend.cu", 86, pe_k1,
                     worst, r1["PE"]),
        kernel_entry("ksw_local", "PE, forward pass (want_sub)",
                     "ksw_local.cu", 231, pe_k2[True], worst2, r2[True]),
        kernel_entry("ksw_local_rev", "PE, reverse pass", "ksw_local.cu",
                     231, pe_k2[False], worst2, r2[False]),
    ] + [kernel_entry(name, path, src, line, n_l,
                      worst if src == "ksw_extend.cu" else worst2, m)
         for name, path, src, line, n_l, m in new] + opt_kernels
    print(json.dumps({"kernels": kernels}))
    print(f"{card}")
    print("stream s a batch over phase 3's batches: " + ", ".join(
        f"{v} {stream[(v, TIMED_BATCHES)][0]:.4f}" for v in "abd") +
        f" [{card}]")
    print(f"e2e reads/s: SE {rps:.1f}, PE {pe_rps:.1f}; CLI: "
          f"{cli_res['se']['line'].split('] ')[1]} (SE), "
          f"{cli_res['pe']['line'].split('] ')[1]} (PE); anchor seed stage "
          f"{anc['t_anchor'] * 1e3:.1f} ms against LUT "
          f"{anc['t_lut'] * 1e3:.1f} ms; {SCALE_MBP} Mbp: SE "
          f"{scale['se']['value']} reads/s, PE {scale['pe']['value']} "
          f"reads/s, fallback {scale['se']['fallback_pct']}% (SE), "
          f"{scale['pe']['pe_fallback_pct']}% (PE); phase 16: "
          f"{json.dumps(diag['scale']['split'])}; bench_torch.py "
          f"({FULL_CALL_BENCH_TIMED} timed SE batch of "
          f"{FULL_CALL_BENCH_BATCH}): SE "
          f"{bench['line']['value']}, PE "
          f"{bench['line']['pe_150bp_reads_per_s']} reads/s; dry run: "
          f"sharding_overhead_eff "
          f"{dry['scaling']['load_test']['sharding_overhead_eff']}")
    print(f"whole call: {time.time() - t_call:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
