"""End-to-end alignment pipeline (single-end and paired-end): device
worker1 + native finish.

The production data path (ARCHITECTURE.md):
  FASTQ batch -> device: SMEM seeding, chaining, chain filter, batched banded
  extension -> AlnRegs to host -> native C++: dedup/patch, primary marking,
  MAPQ, CIGAR (banded global), SAM text.
Reads whose device caps overflowed (too many SMEMs/seeds/chains/regs) are
re-run on the big-caps tiers (tier-2, tier-3) and, failing those,
re-aligned entirely by the scalar oracle — identical semantics, so caps
trade only throughput, never correctness.

Maps to the reference's FastMap.memSingleEndMapping -> worker1 -> worker2 flow
[ref: FastMap.scala; worker1/BWAMemWorker1.scala; worker2/BWAMemWorker2.scala].

Paired-end batches add, between worker1 and the native finish, the
insert-size histogram and all mate-rescue local alignments of the batch as
one device call (pair/rescue.py)
[ref: FastMap.memPairEndMapping; worker2/MemSamPe.scala].

Device: ``Aligner(idx, device=None)`` runs on the CUDA card and raises when
there is none; tests pass ``device="cpu"``, which runs every stage with
the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import concurrent.futures as cf
import ctypes as C
import dataclasses
import math
import os

import numpy as np
import torch

from .chain.device import ChainConfig
from .dist import multihost
from .dist.mesh import pe_hist_psum, worker1_step
from .extend.worker import ExtendConfig
from .index.builder import FMIndex
from .index.device import DeviceIndex
from .io.fastx import ReadBatch
from .opts import MemOptions
from .oracle import Oracle, sam_args, to_copt
from .pair.rescue import dispatch_rescue_tasks
from .seed.anchor import AnchorSeedConfig
from .seed.lut import KmerLUT, LutSeedConfig
from .utils.profiling import span, synced

REG_FIELDS = ("rb", "re", "qb", "qe", "score", "truesc", "w", "seedcov",
              "seedlen0", "rid")


def configs_from_opts(opt: MemOptions, max_smems=32, max_seeds=128,
                      max_chains=32, max_regs=32, seed_impl="lut",
                      text_len: int | None = None,
                      seed_kw: dict | None = None,
                      sa_dense: int | None = None):
    """The seeding, chaining and extension configs of one set of caps.
    seed_impl "lut" seeds through the k-mer jump table (production),
    "anchor" through bwa's anchor state machine (``seed.anchor``)."""
    if text_len is None:
        text_len = 1 << 23
    if seed_impl == "lut":
        # dense-walk budgets scale with the genome: the k-mer jump table
        # is capped at k0 <= 12, so on a large text most length-k0
        # intervals are still multi-occurrence and the walk must (a) run
        # more full-width lockstep steps before compacting and (b) leave
        # room for the repeat-family lanes that survive indefinitely
        lg4 = math.ceil(math.log(max(text_len, 4)) / math.log(4.0))
        k0 = max(1, min(12, opt.min_seed_len, lg4 + 1))
        fm_full = max(3, lg4 - k0 + 2)
        fm_dense = 16 if text_len < 1 << 30 else 8
        offdiag_dense = 8 if text_len < 1 << 26 else 4
        kw = dict(max_smems=max_smems, min_seed_len=opt.min_seed_len,
                  split_len=opt.split_len, split_width=opt.split_width,
                  fm_full=fm_full, fm_dense=fm_dense,
                  offdiag_dense=offdiag_dense)
        kw.update(seed_kw or {})
        scfg = LutSeedConfig(**kw)
    elif seed_impl == "anchor":
        scfg = AnchorSeedConfig(max_smems=max_smems,
                                min_seed_len=opt.min_seed_len,
                                split_len=opt.split_len,
                                split_width=opt.split_width)
    else:
        raise ValueError(f"seed_impl={seed_impl!r}: 'lut' or 'anchor'")
    big = text_len >= 1 << 30
    if sa_dense is None:
        # the dense SA-walk budget must hold the batch's TOTAL seed count:
        # on repeat-rich Gbp genomes reads carry far more seeds, so there
        # the budget is the per-read cap and can never overflow
        sa_dense = max_seeds if big else 8
    ccfg = ChainConfig(max_seeds=max_seeds, max_chains=max_chains,
                       max_occ=opt.max_occ, max_chain_gap=opt.max_chain_gap,
                       w=opt.w, min_seed_len=opt.min_seed_len,
                       mask_level=opt.mask_level, drop_ratio=opt.drop_ratio,
                       max_chain_extend=min(opt.max_chain_extend, 1 << 30),
                       min_chain_weight=opt.min_chain_weight,
                       sa_dense=sa_dense)
    ecfg = ExtendConfig(max_regs=max_regs, w=opt.w, zdrop=opt.zdrop, a=opt.a,
                        b=opt.b, o_del=opt.o_del, e_del=opt.e_del,
                        o_ins=opt.o_ins, e_ins=opt.e_ins,
                        pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3,
                        full_rounds=2 if big else 1,
                        tail_rows=4 if big else 8,
                        cand_mult=4 if big else 1)
    return scfg, ccfg, ecfg


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Aligner: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the host")
    return device


class Aligner:
    """Holds host+device index state and runs batches end to end."""

    def __init__(self, idx: FMIndex, opt: MemOptions = MemOptions(),
                 rg_id: str = "", seed_impl: str = "lut",
                 lut_cache=None, device=None, **caps):
        self.device = _resolve_device(device)
        self.idx = idx
        self.opt = opt
        self.rg_id = rg_id
        self.seed_impl = seed_impl
        self._explicit_caps = dict(caps)
        self.scfg, self.ccfg, self.ecfg = configs_from_opts(
            opt, seed_impl=seed_impl, text_len=2 * int(idx.l_pac), **caps)
        self.didx = DeviceIndex.from_host(idx, self.device)
        self.oracle = Oracle(idx)
        self.lut = (KmerLUT.build(idx, min_seed_len=opt.min_seed_len,
                                  cache=lut_cache, device=self.device)
                    if seed_impl == "lut" else None)
        self._packed = {}        # length bucket (or tier) -> packed fn
        self._oracle_pool = [self.oracle]   # per-finish-thread handles
        # running workload-honesty counters (reset freely by callers):
        # fallback_reads = reads realigned by the host oracle after a
        # device-cap overflow — the benchmark reports this rate
        self.stats = {"reads": 0, "fallback_reads": 0}

    # regs/read capacity of the compact transfer buffer; reads needing more
    # fall back to the oracle (mean regs/read is ~1 on real data)
    CAP_FACTOR = 4

    # tier-1 caps scale with read length: a 150 bp read legitimately
    # carries ~1.5x the SMEMs/seeds of a 100 bp read; longer reads also
    # carry more 2nd-round reseed candidates
    _CAP_BUCKETS = ((100, {}),
                    (160, dict(max_smems=48, max_seeds=192,
                               max_chains=48, max_regs=48,
                               seed_kw=dict(max_reseed=5, r2_rows=1,
                                            offdiag_dense=4))),
                    (1 << 30, dict(max_smems=63, max_seeds=288,
                                   max_chains=63, max_regs=63,
                                   seed_kw=dict(max_reseed=6, r2_rows=1,
                                                offdiag_dense=4))))

    def _packed_for_len(self, L: int):
        """The packed worker1 whose caps match read length L."""
        if self._explicit_caps or L <= self._CAP_BUCKETS[0][0]:
            if "tier1" not in self._packed:
                self._packed["tier1"] = self._make_packed(
                    self.scfg, self.ccfg, self.ecfg)
            return self._packed["tier1"]
        for bound, caps in self._CAP_BUCKETS[1:]:
            if L <= bound:
                break
        if bound not in self._packed:
            scfg, ccfg, ecfg = configs_from_opts(
                self.opt, seed_impl=self.seed_impl,
                text_len=2 * int(self.idx.l_pac), **caps)
            self._packed[bound] = self._make_packed(scfg, ccfg, ecfg)
        return self._packed[bound]

    def _to_device(self, a) -> torch.Tensor:
        with synced():      # a copy from pageable host memory blocks
            return torch.as_tensor(a).to(self.device).contiguous()

    def worker1_packed(self, seqs, lens) -> torch.Tensor:
        """worker1 with all outputs compacted + bit-packed into ONE int32
        tensor so a single, small host transfer suffices (the (B, R) reg
        grid is ~97% padding at R=32).

        Layout: [counts(B) | regs(cap, 6) row-major], cap = CAP_FACTOR*B.
          counts[b] = n_eff | overflow<<10 | l_rep<<11
          reg words: w0=rb low 32 bits; w1=(re-rb)|qb<<16;
                     w2=(qe-qb)|score<<16; w3=truesc|w<<16;
                     w4=seedcov|seedlen0<<10|rid<<20; w5=rb high bits
                     (0 below 2 Gbp text).
        Regs of read b occupy rows [sum(n_eff[:b]), +n_eff[b]) — offsets are
        recomputed on host from counts. Any read whose fields exceed the bit
        budgets (or whose regs would overflow cap) gets overflow=1, n_eff=0
        and is realigned downstream, so packing never affects output.
        """
        with span("tier1"):
            seqs = self._to_device(seqs)
            return self._packed_for_len(int(seqs.shape[1]))(
                seqs, self._to_device(lens))

    def _make_packed(self, scfg, ccfg, ecfg, cap_factor: int | None = None):
        R = ecfg.max_regs
        if R > 1023:
            raise ValueError("max_regs must fit the 10-bit count field")
        cap_factor = cap_factor if cap_factor is not None else \
            self.CAP_FACTOR

        def packed(seqs, lens):
            seqs = seqs.to(torch.int32)      # uint8 over the wire
            lens = lens.to(torch.int32)
            st = worker1_step(self.didx, seqs, lens, self.lut, scfg=scfg,
                              ccfg=ccfg, ecfg=ecfg)
            with span("pack"):
                return _pack(st, st["l_rep"], R, cap_factor * seqs.shape[0])

        return packed

    def worker1_device(self, seqs: torch.Tensor, lens: torch.Tensor):
        """Device half with the tier-1 configs: the region-state dict of
        ``dist.mesh.worker1_step``."""
        return self.worker1_device_inner(self.didx, seqs, lens)

    def worker1_device_inner(self, didx, seqs, lens, lut=None):
        return worker1_step(didx, seqs, lens,
                            lut if lut is not None else self.lut,
                            scfg=self.scfg, ccfg=self.ccfg, ecfg=self.ecfg)

    @staticmethod
    def _unpack_host(buf: np.ndarray, B: int):
        """Inverse of worker1_packed's packing: returns (n, ovf, l_rep,
        flat regs (total, 10) int64 in REG_FIELDS order)."""
        counts = buf[:B]
        ne = counts & 1023
        ovf = ((counts >> 10) & 1).astype(bool)
        l_rep = counts >> 11
        total = int(ne.sum())
        rows = buf[B:].reshape(-1, 6)[:total].astype(np.int64)
        rb = (rows[:, 5] << 32) | (rows[:, 0] & 0xFFFFFFFF)
        re = rb + (rows[:, 1] & 0xFFFF)
        qb = rows[:, 1] >> 16
        qe = qb + (rows[:, 2] & 0xFFFF)
        score = rows[:, 2] >> 16
        truesc = rows[:, 3] & 0xFFFF
        w = rows[:, 3] >> 16
        seedcov = rows[:, 4] & 0x3FF
        seedlen0 = (rows[:, 4] >> 10) & 0x3FF
        rid = rows[:, 4] >> 20
        flat = np.stack([rb, re, qb, qe, score, truesc, w, seedcov,
                         seedlen0, rid], axis=1).astype(np.int64)
        return ne.astype(np.int32), ovf, l_rep.astype(np.int32), flat

    # ---- tier-2: big-caps device path for reads that overflow the fast
    # tier's static caps (repeat-dense reads: a single max_occ=500 SMEM
    # yields 500 seeds). Only reads overflowing BOTH tiers reach the host
    # oracle, so the common case stays on the small fast kernels.
    TIER2_ROWS = 512          # sub-batch row quantum for the big tier

    def _tier_configs(self, tier: int):
        """(scfg, ccfg, ecfg, cap_factor) of big-caps tier 2 or 3: what
        ``_packed_big_fn`` / ``_packed_big3_fn`` run, and what the overflow
        diagnostics (``tools/diag_tier2.py``) break down."""
        if tier == 2:
            big = dict(max_smems=63, max_seeds=640, max_chains=64,
                       max_regs=63)
            seed_kw = dict(fm_dense=4, offdiag_dense=2, r2_rows=1,
                           max_reseed=8)
            # the task-parallel engine with a 16x candidate budget covers
            # the worst single read (640 seeds) in one flat kernel batch
            ext_kw = dict(tail_rows=1, task_parallel=True, cand_mult=16,
                          retry_rows=2)
            cap_factor = self.CAP_FACTOR
        elif tier == 3:
            # chains AND regions scale together: a multi-repeat-family
            # read forms ~one chain per occurrence, and every kept chain
            # yields a region
            big = dict(max_smems=63, max_seeds=1280, max_chains=512,
                       max_regs=512)
            # full-width dense budgets: a tier-3 batch is ALL repeat
            # monsters
            seed_kw = dict(fm_dense=1, offdiag_dense=1, r2_rows=1,
                           max_reseed=8)
            # ROUND engine here: a mega-repeat read extends hundreds of
            # seeds and the task-parallel engine's optimistic candidate
            # superset degenerates; sequential rounds are exact by
            # construction
            ext_kw = dict(tail_rows=1, task_parallel=False, retry_rows=2)
            cap_factor = 512
        else:
            raise ValueError(f"tier {tier}: the big-caps tiers are 2 and 3")
        scfg, ccfg, ecfg = configs_from_opts(
            self.opt, seed_impl=self.seed_impl,
            text_len=2 * int(self.idx.l_pac), sa_dense=big["max_seeds"],
            **big)
        if isinstance(scfg, LutSeedConfig):
            scfg = dataclasses.replace(scfg, **seed_kw)
        return scfg, ccfg, dataclasses.replace(ecfg, **ext_kw), cap_factor

    def _packed_big_fn(self):
        if "tier2" not in self._packed:
            self._packed["tier2"] = self._make_packed(*self._tier_configs(2))
        return self._packed["tier2"]

    # below this many overflow reads, tier-2 is skipped and the scalar
    # oracle realigns them on the host instead
    TIER2_MIN = 64

    # ---- tier-3: the p99 seed tail (> tier-2's 640 seeds)
    TIER3_ROWS = 128
    TIER3_MIN = 8

    def _packed_big3_fn(self):
        if "tier3" not in self._packed:
            self._packed["tier3"] = self._make_packed(*self._tier_configs(3))
        return self._packed["tier3"]

    def _rerun(self, fn, batch: ReadBatch, rows, quantum: int):
        """Run a big-caps packed fn on the given rows, padded to a multiple
        of `quantum` rows. Returns (rows, rsel, device buffer)."""
        pad = (-len(rows)) % quantum
        rsel = np.concatenate([rows, np.repeat(rows[-1:], pad)])
        return rows, rsel, fn(self._to_device(batch.seqs[rsel]),
                              self._to_device(batch.lens[rsel]))

    def _tier3(self, batch: ReadBatch, n, ovf, l_rep, flat):
        """Re-run remaining overflow reads through the 1280-seed device
        path; anything left after this goes to the oracle."""
        rows = np.flatnonzero(ovf)
        if len(rows) < self.TIER3_MIN:
            return n, ovf, l_rep, flat
        with span("tier3"):
            self.stats["tier3_rows"] = \
                self.stats.get("tier3_rows", 0) + len(rows)
            return self._tier2_merge(batch, n, ovf, l_rep, flat, self._rerun(
                self._packed_big3_fn(), batch, rows, self.TIER3_ROWS))

    def _tier2_dispatch(self, batch: ReadBatch, ovf):
        """Issue the big-caps device call for tier-1-overflow reads, or
        return None when too few reads overflowed (the host oracle is
        cheaper for a handful). Each call is logged in
        ``stats["tier_batches"]``: the batch's first read, its overflow
        count and whether tier 2 fired."""
        rows = np.flatnonzero(ovf)
        self.stats["tier1_ovf"] = self.stats.get("tier1_ovf", 0) + len(rows)
        fired = len(rows) >= max(self.TIER2_MIN, batch.n // 16)
        self.stats.setdefault("tier_batches", []).append(
            {"first_read": batch.names[0], "tier1_ovf": len(rows),
             "tier2": fired})
        if not fired:
            return None
        self.stats["tier2_rows"] = self.stats.get("tier2_rows", 0) + len(rows)
        with span("tier2"):
            return self._rerun(self._packed_big_fn(), batch, rows,
                               self.TIER2_ROWS)

    def _tier2_merge(self, batch: ReadBatch, n, ovf, l_rep, flat, t2):
        """Download a big-tier result and splice the re-run reads' regions
        back in; returns updated (n, ovf, l_rep, flat)."""
        rows, rsel, dev = t2
        with synced():
            buf = dev.cpu().numpy()
        n2, ovf2, lrep2, flat2 = self._unpack_host(buf, len(rsel))
        offs2 = np.concatenate([[0], np.cumsum(n2)])
        offs = np.concatenate([[0], np.cumsum(n)])
        per_read = [flat[offs[b]:offs[b + 1]] for b in range(batch.n)]
        for k, r in enumerate(rows):
            n[r] = n2[k]
            ovf[r] = ovf2[k]
            l_rep[r] = lrep2[k]
            per_read[r] = flat2[offs2[k]:offs2[k + 1]]
        flat = (np.concatenate(per_read, axis=0) if batch.n
                else np.empty((0, len(REG_FIELDS)), np.int64))
        return n, ovf, l_rep, flat

    # read-length bucket granularity: a mixed-length batch is split into
    # per-bucket device calls, each padded to a multiple of BUCKET lanes,
    # and the outputs are re-interleaved into input order before finishing
    BUCKET = 64

    def align_se(self, batch: ReadBatch, id0: int = 0) -> str:
        """Returns SAM body text for the batch (deterministic in id0).

        Mixed-length batches route through per-bucket device calls; padding
        waste per read is < BUCKET lanes instead of (max_len - len).
        """
        return self._finish_se_dispatched(batch, self._dispatch_se(batch),
                                          id0)

    def _dispatch_se(self, batch: ReadBatch):
        """Run worker1 for a batch. Returns a list of (rows, device_buffer,
        n_sub): one entry for a uniform batch, one per length bucket for a
        mixed batch."""
        lens = np.asarray(batch.lens)
        W = batch.seqs.shape[1]
        wb = min(int(np.max(-(-lens // self.BUCKET)) * self.BUCKET), W) \
            if batch.n else W
        if batch.n == 0 or wb >= W:
            # uniform enough: one full-width call
            return [(None, self.worker1_packed(batch.seqs, lens), batch.n)]
        if np.min(lens) > wb - self.BUCKET:
            # single-bucket batch padded wider than its bucket: truncate the
            # device call to the bucket width
            return [(None, self.worker1_packed(batch.seqs[:, :wb], lens),
                     batch.n)]
        parts = []
        wbs = np.minimum((-(-lens // self.BUCKET)) * self.BUCKET, W)
        for w in sorted(set(int(x) for x in wbs)):
            rows = np.flatnonzero(wbs == w)
            pad = (-len(rows)) % 128      # bound distinct batch shapes
            rsel = np.concatenate([rows, np.repeat(rows[-1:], pad)])
            parts.append((rows, self.worker1_packed(
                batch.seqs[rsel, :w], lens[rsel]), len(rsel)))
        return parts

    def _finish_se_dispatched(self, batch: ReadBatch, parts, id0: int):
        if len(parts) == 1 and parts[0][0] is None:
            return self._finish_se_buf(batch, _download(parts[0][1]), id0)
        B = batch.n
        n = np.zeros(B, np.int32)
        ovf = np.zeros(B, bool)
        l_rep = np.zeros(B, np.int32)
        per_read: list = [None] * B
        for rows, dev, n_sub in parts:
            ns, ovfs, lrs, flats = self._unpack_host(_download(dev), n_sub)
            offs = np.concatenate([[0], np.cumsum(ns)])
            for k, r in enumerate(rows):
                n[r] = ns[k]
                ovf[r] = ovfs[k]
                l_rep[r] = lrs[k]
                per_read[r] = flats[offs[k]:offs[k + 1]]
        flat = (np.concatenate(per_read, axis=0) if B
                else np.empty((0, len(REG_FIELDS)), np.int64))
        return self._finish_se_parts(batch, n, ovf, l_rep, flat, id0)

    def align_se_stream(self, batches, id0: int = 0, depth: int = 2):
        """Pipelined SE alignment over an iterable of ReadBatches; yields
        SAM body text per batch, in order, on the calling thread.

        worker1 is dispatched for up to `depth` batches before the oldest
        is finished, in the reference's order. On the card worker1 is a
        host-driven loop of small device calls, so dispatching batch i+1
        ahead of batch i's finish does not overlap the two: the order
        keeps the reference's calls and output, and no second thread
        contends with the one that drives the device. The native finish
        still spreads its chunks over threads (``_finish_threaded``).

        Items may also be (ReadBatch, explicit_id0) pairs, where skipped
        batches leave gaps in the global read numbering.
        """
        pending: list[tuple[ReadBatch, list, int]] = []
        n = id0
        for item in batches:
            b, i0 = item if isinstance(item, tuple) else (item, None)
            if i0 is not None:
                n = i0
            pending.append((b, self._dispatch_se(b), n))
            n += b.n
            if len(pending) >= depth:
                yield self._finish_se_dispatched(*pending.pop(0))
        for bb, parts, i0 in pending:
            yield self._finish_se_dispatched(bb, parts, i0)

    def _finish_se_buf(self, batch: ReadBatch, buf: np.ndarray,
                       id0: int) -> str:
        n, ovf, l_rep, flat = self._unpack_host(buf, batch.n)
        return self._finish_se_parts(batch, n, ovf, l_rep, flat, id0)

    def _finish_se_parts(self, batch: ReadBatch, n, ovf, l_rep, flat,
                         id0: int) -> str:
        return self._finish_threaded(
            batch, *self._tiers(batch, n, ovf, l_rep, flat), id0)

    def _tiers(self, batch: ReadBatch, n, ovf, l_rep, flat):
        """Re-run the reads that overflowed tier 1 on the big-caps tiers;
        returns the merged (n, ovf, l_rep, flat), where ovf marks the reads
        left for the host oracle."""
        self.stats["reads"] += batch.n
        t2 = self._tier2_dispatch(batch, ovf) if ovf.any() else None
        if t2 is not None:
            with span("tier2"):
                n, ovf, l_rep, flat = self._tier2_merge(batch, n, ovf, l_rep,
                                                        flat, t2)
        if ovf.any():
            # mega-repeat reads are exactly where the scalar oracle is
            # slowest, so give the seed-tail tier a chance first
            n, ovf, l_rep, flat = self._tier3(batch, n, ovf, l_rep, flat)
        self.stats["fallback_reads"] += int(ovf.sum())
        return n, ovf, l_rep, flat

    def _finish_threaded(self, batch, n, ovf, l_rep, flat, id0: int) -> str:
        """Native finish over contiguous read chunks, threaded when the
        host has cores to spare (the ctypes calls release the interpreter
        lock and each chunk runs on its own native handle); overflow reads
        are realigned by the oracle. Joined in order — output is
        byte-identical to the serial path."""
        with span("finish"):
            offs_all = np.concatenate([[0], np.cumsum(n)])
            k = min(self._n_finish_threads(), max(batch.n // 256, 1))
            if k <= 1:
                return self._finish_chunk(batch, n, ovf, l_rep, flat,
                                          offs_all, 0, batch.n, id0,
                                          self.oracle)
            bounds = [round(batch.n * t / k) for t in range(k + 1)]
            oracles = self._finish_oracles(k)
            with cf.ThreadPoolExecutor(max_workers=k) as ex:
                futs = [ex.submit(self._finish_chunk, batch, n, ovf, l_rep,
                                  flat, offs_all, bounds[t], bounds[t + 1],
                                  id0, oracles[t])
                        for t in range(k)]
                return "".join(f.result() for f in futs)

    @staticmethod
    def _n_finish_threads() -> int:
        """Leave one core for the thread that drives the device."""
        return max(1, min(8, (os.cpu_count() or 2) - 1))

    def _finish_oracles(self, k: int):
        """Per-thread native handles over the same (kept-alive) index."""
        while len(self._oracle_pool) < k:
            self._oracle_pool.append(Oracle(self.idx))
        return self._oracle_pool[:k]

    def _finish_chunk(self, batch, n, ovf, l_rep, flat, offs_all, lo, hi,
                      id0, oracle) -> str:
        out_parts: list[str] = []
        # group maximal runs of non-overflow reads into single native calls
        i = lo
        while i < hi:
            if ovf[i]:
                out_parts.append(oracle.align_se(
                    _slice_batch(batch, i, i + 1), self.opt, id0=id0 + i,
                    rg_id=self.rg_id))
                i += 1
                continue
            j = i
            while j < hi and not ovf[j]:
                j += 1
            out_parts.append(oracle.finish_se(
                _slice_batch(batch, i, j), self.opt,
                flat[offs_all[i]:offs_all[j]], n[i:j], l_rep[i:j],
                id0=id0 + i, rg_id=self.rg_id))
            i = j
        return "".join(out_parts)

    def align_pe(self, batch: ReadBatch, id0: int = 0) -> str:
        """Paired-end SAM for an interleaved batch (pair i = rows 2i, 2i+1).

        The PE flow [ref: FastMap.memPairEndMapping; bwa: mem_sam_pe]:
          1. device worker1 per end (overflowed reads get host-computed
             regions, identical semantics);
          2. per-pair insert samples (native) -> orientation histogram on
             the device -> pestat from the histogram;
          3. all mate-rescue SW windows of the batch in ONE device
             local-alignment call (pair/rescue.py);
          4. native pairing/flags/TLEN/SAM replay with the device results
             injected.
        """
        buf = _download(self.worker1_packed(batch.seqs, batch.lens))
        return self._finish_pe_buf(batch, buf, id0)

    def align_pe_stream(self, batches, id0: int = 0, depth: int = 2):
        """Pipelined PE alignment. Dispatch ORDER is the whole game: the
        device queue is FIFO, so batch i's small PE calls (histogram,
        rescue kernel) must be enqueued BEFORE batch i+1's worker1 — else
        each waits out a whole worker1 of queue latency. Per batch:
        download worker1 -> stage A (host isize, histogram, native task
        gen, rescue DISPATCH) -> enqueue next worker1 -> stage B (rescue
        download + native pair/SAM, overlapped with the next batch's
        device time). Yields SAM text per batch; items may be (ReadBatch,
        explicit_id0) pairs, id0 counting pairs. One batch is in flight
        whatever ``depth`` says; it is accepted, and not used, as in the
        reference."""
        prev: tuple[ReadBatch, torch.Tensor, int] | None = None
        n = id0
        for item in batches:
            b, i0x = item if isinstance(item, tuple) else (item, None)
            if i0x is not None:
                n = i0x
            if prev is not None:
                bb, dev, i0 = prev
                ctx = self._pe_stage_a(bb, _download(dev), i0)
                devb = self.worker1_packed(b.seqs, b.lens)
                yield self._pe_stage_b(ctx)
            else:
                devb = self.worker1_packed(b.seqs, b.lens)
            prev = (b, devb, n)
            n += b.n // 2
        if prev is not None:
            bb, dev, i0 = prev
            yield self._finish_pe_buf(bb, _download(dev), i0)

    def _finish_pe_buf(self, batch: ReadBatch, buf: np.ndarray,
                       id0: int) -> str:
        return self._pe_stage_b(self._pe_stage_a(batch, buf, id0))

    def _pe_regions(self, batch: ReadBatch, buf: np.ndarray, id0: int):
        """Unpack worker1's buffer and settle every read's pre-dedup
        regions: the big-caps tiers for tier-1 overflows, then the scalar
        oracle's regions for reads that overflow every tier. Returns the
        context the later PE steps share: the batch and its regions as
        contiguous host arrays, and the PE options."""
        n, ovf, l_rep, flat = self._tiers(
            batch, *self._unpack_host(buf, batch.n))
        if ovf.any():
            offs = np.concatenate([[0], np.cumsum(n)])
            parts: list[np.ndarray] = []
            for b in range(batch.n):
                if ovf[b]:
                    rows, lr = self.oracle.regs_pre(
                        batch.seqs[b][: batch.lens[b]], self.opt)
                    parts.append(rows)
                    n[b] = len(rows)
                    l_rep[b] = lr
                else:
                    parts.append(flat[offs[b]:offs[b + 1]])
            flat = np.concatenate(parts, axis=0)
        seqs_h, lens_h, names, quals = sam_args(batch)
        return dict(
            batch=batch, id0=id0,
            copt=to_copt(self.opt.replace(
                flag=self.opt.flag | MemOptions.F_PE)),
            seqs_h=seqs_h, lens_h=lens_h, names=names, quals=quals,
            flat_h=np.ascontiguousarray(flat, np.int64),
            n_h=np.ascontiguousarray(n, np.int32),
            lrep_h=np.ascontiguousarray(l_rep, np.int32))

    def _pe_stage_a(self, batch: ReadBatch, buf: np.ndarray, id0: int):
        """PE finish, part A: unpack + big-caps tiers + native isize
        sampling + pestat histogram + native rescue-task generation +
        rescue kernel DISPATCH. Returns the context for _pe_stage_b with
        the rescue device call in flight (nothing downloads it here), so
        the stream can enqueue the next batch's worker1 behind it."""
        ctx = self._pe_regions(batch, buf, id0)
        with span("pe/isize"):
            ctx["hist_h"] = self._pe_hist(ctx)
        with span("pe/tasks"):
            ctx["tasks"] = self._pe_tasks(ctx)
        # one batched device local-alignment call, dispatched async
        with span("pe/rescue"):
            ctx["res_dev"] = dispatch_rescue_tasks(
                self.didx, batch.seqs, batch.lens, ctx["tasks"], id0,
                self.opt)
        return ctx

    def _pe_hist(self, ctx: dict) -> np.ndarray:
        """pestat input: native per-pair (orientation, insert) samples ->
        device histogram (4, max_ins+1) int64, summed across the hosts of a
        multi-host run (one reduce round per batch; a single process only
        counts the round)."""
        batch = ctx["batch"]
        n_pairs = batch.n // 2
        dirs = np.zeros(max(n_pairs, 1), np.int32)
        isz = np.zeros(max(n_pairs, 1), np.int64)
        self.oracle._lib.tb_pe_isize(
            self.oracle._h, C.byref(ctx["copt"]), ctx["seqs_h"],
            ctx["lens_h"], batch.n, ctx["seqs_h"].shape[1], ctx["flat_h"],
            ctx["n_h"], ctx["lrep_h"], dirs, isz)
        hist = pe_hist_psum(dirs[:n_pairs], isz[:n_pairs], self.opt.max_ins,
                            self.device)
        return np.ascontiguousarray(multihost.hist_allreduce(hist), np.int64)

    def _pe_tasks(self, ctx: dict) -> np.ndarray:
        """Native rescue-task generation: (n_t, 8) int64 rows (pair, end,
        j, dir, is_rev, rb, re, rid), every window the pairing replay
        could ask for."""
        batch = ctx["batch"]
        rowsp = C.POINTER(C.c_int64)()
        n_t = self.oracle._lib.tb_pe_rescue_tasks(
            self.oracle._h, C.byref(ctx["copt"]), ctx["seqs_h"],
            ctx["lens_h"], batch.n, ctx["seqs_h"].shape[1], ctx["flat_h"],
            ctx["n_h"], ctx["lrep_h"],
            ctx["hist_h"].ctypes.data_as(C.c_void_p), self.opt.max_ins,
            ctx["id0"], C.byref(rowsp))
        self.stats["rescue_tasks"] = self.stats.get("rescue_tasks", 0) + n_t
        if not n_t:
            return np.empty((0, 8), np.int64)
        return np.ctypeslib.as_array(rowsp, shape=(n_t * 8,)) \
            .reshape(n_t, 8).copy()

    def _pe_stage_b(self, ctx: dict) -> str:
        """PE finish, part B: download the rescue results (blocks on the
        device) and run the native pairing/flags/TLEN/SAM replay."""
        with span("pe/sam"):
            batch = ctx["batch"]
            tasks = ctx["tasks"]
            n_t = len(tasks)
            tasks_p = res_p = None
            if n_t:
                with synced():
                    res_h = np.ascontiguousarray(
                        ctx["res_dev"].cpu().numpy(), np.int32)
                tasks_p = tasks.ctypes.data_as(C.c_void_p)
                res_p = res_h.ctypes.data_as(C.c_void_p)
            out_len = C.c_int64(0)
            ptr = self.oracle._lib.tb_finish_pe_sam(
                self.oracle._h, C.byref(ctx["copt"]), ctx["seqs_h"],
                ctx["lens_h"], ctx["names"], ctx["quals"], batch.n,
                ctx["seqs_h"].shape[1], ctx["flat_h"], ctx["n_h"],
                ctx["lrep_h"], ctx["hist_h"].ctypes.data_as(C.c_void_p),
                self.opt.max_ins, tasks_p, res_p, n_t, ctx["id0"],
                self.rg_id.encode(), C.byref(out_len))
            return C.string_at(ptr, out_len.value).decode()

    def sam_header(self, extra_pg: str = "tpubwa") -> str:
        lines = [f"@SQ\tSN:{a.name}\tLN:{a.length}" for a in self.idx.anns]
        if self.rg_id:
            lines.append(f"@RG\tID:{self.rg_id}")
        lines.append(f"@PG\tID:{extra_pg}\tPN:{extra_pg}")
        return "\n".join(lines) + "\n"


def _pack(st: dict, l_rep: torch.Tensor, R: int, cap: int) -> torch.Tensor:
    """Bit-pack the (B, R) region state into the worker1_packed layout."""
    B = st["n"].shape[0]
    dev = st["n"].device
    rb, re = st["rb"].to(torch.int64), st["re"].to(torch.int64)
    qb, qe = st["qb"], st["qe"]
    score, truesc = st["score"], st["truesc"]
    w, seedcov = st["w"], st["seedcov"]
    seedlen0, rid = st["seedlen0"], st["rid"]
    ridx = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
    valid0 = ridx < st["n"][:, None]

    def inrange(v, hi):
        return (v >= 0) & (v <= hi)

    ok = (inrange(re - rb, 0xFFFF) & inrange(qb, 0x7FFF)
          & inrange(qe - qb, 0xFFFF) & inrange(score, 0x7FFF)
          & inrange(truesc, 0xFFFF) & inrange(w, 0x7FFF)
          & inrange(seedcov, 0x3FF) & inrange(seedlen0, 0x3FF)
          & inrange(rid, 0x7FF))
    ovf = st["overflow"] | (valid0 & ~ok).any(dim=1)
    ne = torch.where(ovf, 0, st["n"])
    off = torch.cumsum(ne, 0) - ne
    capovf = off + ne > cap
    ovf = ovf | capovf
    ne = torch.where(capovf, 0, ne)

    # low word reinterpreted as a signed int32 (wraps), high word as is
    lo = rb & 0xFFFFFFFF
    rb_lo = torch.where(lo >= 2**31, lo - 2**32, lo).to(torch.int32)
    rb_hi = (rb >> 32).to(torch.int32)
    words = torch.stack([
        rb_lo,
        (re - rb).to(torch.int32) | (qb << 16),
        (qe - qb) | (score << 16),
        truesc | (w << 16),
        seedcov | (seedlen0 << 10) | (rid << 20),
        rb_hi,
    ], dim=-1).reshape(B * R, 6)
    valid = (ridx < ne[:, None]).reshape(-1)
    csum = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32)
    src = torch.searchsorted(csum, torch.arange(
        1, cap + 1, dtype=torch.int32, device=dev))
    rows = torch.where((src < B * R)[:, None],
                       words[src.clamp(0, B * R - 1)], 0)
    counts = ne.to(torch.int32) | (ovf.to(torch.int32) << 10) | \
        (l_rep.to(torch.int32) << 11)
    return torch.cat([counts, rows.reshape(-1)])


def _download(dev: torch.Tensor) -> np.ndarray:
    """worker1's packed buffer on the host: the one blocking download of
    a tier-1 call's result."""
    with span("download"), synced():
        return dev.cpu().numpy()


def _slice_batch(batch: ReadBatch, i: int, j: int) -> ReadBatch:
    return ReadBatch(seqs=batch.seqs[i:j], lens=batch.lens[i:j],
                     names=batch.names[i:j], quals=batch.quals[i:j])
