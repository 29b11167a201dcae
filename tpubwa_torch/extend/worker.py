"""Device seed-extension orchestration — exact mem_chain2aln semantics.

Replicates [bwa: bwamem.c :: mem_chain2aln] over a batch of reads: chains
are visited in filtered order, seeds within a chain longest-first; each
seed is containment-tested against the regions found so far, and
surviving seeds run left/right banded extensions (with bwa's band-doubling
retry) through ``ops.sw.ksw_extend`` — the CUDA kernel for tensors on the
card, its plain version for CPU tensors. [ref: worker1/MemChainToAlign.scala]

Two engines produce identical regions:
  * task-parallel (the default): every candidate extension is computed in
    two flat kernel batches, then the exact visit order is replayed
    without kernels;
  * round engine: one seed per read per round, for the big-caps tier where
    a read may need hundreds of extensions.

Output: per-read AlnReg arrays (push order identical to the oracle),
handed to the native finishing path.

Host syncs: the replay and the round engine's selection/tail loops take
one ``.any()`` per step group; each kernel call on a compacted retry set
takes one.
"""
from __future__ import annotations

import dataclasses

import torch

from ..index.device import DeviceIndex
from ..ops.sw import ksw_extend
from ..ops.window import (query_window_asc, query_window_desc,
                          text_window_asc, text_window_desc)
from ..seed.lut import _compact_rows
from ..utils.profiling import host_any

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ExtendConfig:
    max_regs: int = 32
    w: int = 100
    zdrop: int = 100
    a: int = 1
    b: int = 4
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    pen_clip5: int = 5
    pen_clip3: int = 5
    max_band_try: int = 2     # [bwa: bwamem.c :: MAX_BAND_TRY]
    tail_rows: int = 8        # reads with >1 extension round: B // tail_rows
    full_rounds: int = 1      # full-width extension rounds before the tail
    #                           (2 on repeat-rich large genomes, where most
    #                           reads extend a second chain)
    # -- task-parallel engine (the default): ALL candidate extensions are
    # precomputed in two flat kernel batches and the exact visit order is
    # replayed kernel-free; the round engine remains for the big-caps tier
    task_parallel: bool = True
    cand_rows: int = 1        # candidate task budget: B*cand_mult // cand_rows
    cand_mult: int = 1        # >1 on repeat-rich large genomes
    retry_rows: int = 8       # compacted band-retry sub-batch: B // retry_rows


def _floordiv(x, d: int):
    if isinstance(x, int):
        return x // d
    return torch.div(x, d, rounding_mode="floor")


def cal_max_gap(cfg: ExtendConfig, qlen):
    """[bwa: bwamem.c :: cal_max_gap]; qlen an int or a tensor."""
    l_del = _floordiv(qlen * cfg.a - cfg.o_del, cfg.e_del) + 1
    l_ins = _floordiv(qlen * cfg.a - cfg.o_ins, cfg.e_ins) + 1
    if isinstance(qlen, int):
        return min(max(l_del, l_ins, 1), cfg.w * 2)
    return torch.maximum(l_del, l_ins).clamp(min=1).clamp(max=2 * cfg.w)


def visit_order(seed_rank, len_s, stored, C: int, L: int):
    """The order mem_chain2aln visits a read's seeds in: chain rank
    ascending, then length descending, then slot descending; seeds of a
    dropped chain (rank C) or not stored go last. Returns (pair_order
    (B, S) int32, n_pairs (B,)). The key is int64: at tier 3's caps (512
    chains, 1280 seeds) and 12,288-wide reads an int32 key wraps from
    rank 137 on."""
    S = seed_rank.shape[1]
    s_iota = torch.arange(S, dtype=torch.int64, device=seed_rank.device)
    key = (seed_rank.to(torch.int64) * (L + 1) + (L - len_s)) * S + \
        (S - 1 - s_iota)[None, :]
    visit = stored & (seed_rank < C)
    key = torch.where(visit, key, C * (L + 1) * S)   # above every visit key
    pair_order = torch.argsort(key, dim=1, stable=True).to(_I32)
    return pair_order, visit.sum(dim=1, dtype=_I32)


def _row_pick(arr: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """arr[b, col[b]]."""
    return arr.gather(1, col.to(torch.int64)[:, None])[:, 0]


def extend_chains(didx: DeviceIndex, seqs, lens, seeds: dict, chains: dict,
                  cfg: ExtendConfig, flt: dict, _stop_after: str = ""):
    """Run mem_chain2aln for all kept chains of all reads.

    seqs: (B, L) int32; lens: (B,); seeds/chains/flt from chain.device.
    Returns dict of (B, max_regs) reg tensors + n (B,) + overflow (B,).

    ``_stop_after`` is a debugging exit for stage bisection
    (tools/time_extend.py): "pre" returns the initial state; "sel1",
    "round1" and "sel2" cut the round engine, "tp1", "tp2" and "tp3" the
    task-parallel one (``_extend_taskpar``).
    """
    B, L = seqs.shape
    S = seeds["rbeg"].shape[1]
    C = chains["pos"].shape[1]
    R = cfg.max_regs
    l_pac = didx.l_pac
    dev = seqs.device

    rbeg_s = seeds["rbeg"]
    qbeg_s = seeds["qbeg"]
    len_s = seeds["len"]
    cid_s = chains["chain_id"]                       # (B, S), -1 = unstored
    stored = cid_s >= 0

    # ---- chain rank in filtered order; rank = C for dropped chains ----
    order, kept = flt["order"], flt["kept"]          # (B, C) each
    cio = torch.arange(C, dtype=_I32, device=dev)
    rank_of = torch.full((B, C + 1), C, dtype=_I32, device=dev)
    rank_of.scatter_(1, torch.where(kept > 0, order, C).to(torch.int64),
                     cio[None, :].expand(B, C).contiguous())
    rank_of = rank_of[:, :C]
    cid_c = cid_s.clamp(min=0).to(torch.int64)
    seed_rank = torch.where(stored, rank_of.gather(1, cid_c), C)

    # ---- rmax windows per chain [the max-possible-span computation] ----
    gap_l = cal_max_gap(cfg, qbeg_s)
    gap_r = cal_max_gap(cfg, lens[:, None] - qbeg_s - len_s)
    bnd = rbeg_s - (qbeg_s + gap_l)
    end = rbeg_s + len_s + (lens[:, None] - qbeg_s - len_s) + gap_r
    big = torch.iinfo(bnd.dtype).max // 4
    cid_d = torch.where(stored, cid_c, C)            # column C = dump
    rmax0 = torch.full((B, C + 1), big, dtype=bnd.dtype, device=dev) \
        .scatter_reduce(1, cid_d, bnd, "amin")[:, :C]
    rmax1 = torch.full((B, C + 1), -big, dtype=end.dtype, device=dev) \
        .scatter_reduce(1, cid_d, end, "amax")[:, :C]
    rmax0 = rmax0.clamp(min=0)
    rmax1 = rmax1.clamp(max=2 * l_pac)
    # strand-boundary split, decided by the chain's first seed
    first_rb = chains["first_rb"]
    crosses = (rmax0 < l_pac) & (l_pac < rmax1)
    rmax1 = torch.where(crosses & (first_rb < l_pac), l_pac, rmax1)
    rmax0 = torch.where(crosses & (first_rb >= l_pac), l_pac, rmax0)
    # clip to the sequence holding the first seed, on its strand
    # [bwa: bntseq.c :: bns_fetch_seq]
    ann_end = didx.ann_end
    fpos = torch.where(first_rb >= l_pac, 2 * l_pac - 1 - first_rb, first_rb)
    rid_c = torch.searchsorted(ann_end, fpos.to(ann_end.dtype).contiguous(),
                               right=True)
    seq_b = torch.where(rid_c > 0, ann_end[(rid_c - 1).clamp(min=0)], 0)
    seq_e = ann_end[rid_c.clamp(0, ann_end.shape[0] - 1)]
    is_rev_c = first_rb >= l_pac
    lo = torch.where(is_rev_c, 2 * l_pac - seq_e, seq_b)
    hi = torch.where(is_rev_c, 2 * l_pac - seq_b, seq_e)
    rmax0 = torch.maximum(rmax0, lo)
    rmax1 = torch.minimum(rmax1, hi)

    pair_order, n_pairs = visit_order(seed_rank, len_s, stored, C, L)

    ctx = dict(pair_order=pair_order, n_pairs=n_pairs, qbeg_s=qbeg_s,
               rbeg_s=rbeg_s, len_s=len_s, cid_s=cid_s,
               rmax0=rmax0, rmax1=rmax1, crid=chains["rid"],
               seqs=seqs, lens=lens, seed_rank=seed_rank)

    def zr(dtype=_I32, fill=0):
        return torch.full((B, R), fill, dtype=dtype, device=dev)
    st = dict(
        ptr=torch.zeros((B,), dtype=_I32, device=dev),
        skipped=torch.zeros((B, S), dtype=torch.bool, device=dev),
        n=torch.zeros((B,), dtype=_I32, device=dev),
        overflow=chains["overflow"].clone(),
        rb=zr(rbeg_s.dtype), re=zr(rbeg_s.dtype), qb=zr(), qe=zr(),
        score=zr(), truesc=zr(), w=zr(), seedcov=zr(), seedlen0=zr(),
        cid=zr(fill=-1), rid=zr(fill=-1),
    )

    if _stop_after == "pre":
        return st
    if cfg.task_parallel:
        return _extend_taskpar(didx, cfg, ctx, st, _stop_after)

    eng = _Engine(didx, cfg, ctx)
    # ---- full-width rounds: round 1 extends virtually every read once;
    # on repeat-rich genomes a second round catches the common
    # second-chain extension before the compacted tail ----
    for _ in range(max(cfg.full_rounds, 1)):
        st = eng.select(st)
        if _stop_after == "sel1":
            return st
        if host_any(eng.active(st)):
            st = eng.run_extension(st)
    if _stop_after == "round1":
        return st
    # advance past seeds the full-round regions now contain, so only reads
    # that truly need another EXTENSION enter the tail
    st = eng.select(st)
    if _stop_after == "sel2":
        return st

    # ---- tail rounds: reads with >1 surviving extension task are rare,
    # so the remaining rounds run on a row-compacted sub-batch ----
    Dr = min(max(B // cfg.tail_rows, 32), B)
    active = st["ptr"] < n_pairs
    srcrow, rpos, room, dv = _compact_rows(active, Dr)
    st["overflow"] = st["overflow"] | (active & ~room)
    srcrow = srcrow.to(torch.int64)
    sub_ctx = {k: v[srcrow] for k, v in ctx.items()}
    sub_ctx["n_pairs"] = torch.where(dv, sub_ctx["n_pairs"], 0)
    sub_st = {k: v[srcrow] for k, v in st.items()}
    eng2 = _Engine(didx, cfg, sub_ctx)
    while host_any(sub_st["ptr"] < sub_ctx["n_pairs"]):
        sub_st = eng2.select(sub_st)
        if host_any(eng2.active(sub_st)):
            sub_st = eng2.run_extension(sub_st)
    rp = rpos.clamp(0, Dr - 1).to(torch.int64)
    sel = active & room
    for k2 in st:
        v = sub_st[k2][rp]
        st[k2] = torch.where(sel if st[k2].dim() == 1 else sel[:, None],
                             v, st[k2])
    return st


def _kernel_call(cfg: ExtendConfig, q, ql, t, tl, h, eb: int, aw: int, act):
    """One banded-extension kernel invocation at width q.shape[0]; the
    tensors' device decides between the CUDA kernel and its plain
    version. Returns the six (N,) result columns."""
    N = q.shape[0]
    c = lambda x: x.to(_I32).contiguous()            # noqa: E731
    full = lambda v: torch.full((N,), v, dtype=_I32, device=q.device)  # noqa
    o = ksw_extend(c(q), c(ql), c(t), c(tl), c(h), full(aw), full(eb),
                   c(act), o_del=cfg.o_del, e_del=cfg.e_del,
                   o_ins=cfg.o_ins, e_ins=cfg.e_ins, zdrop=cfg.zdrop,
                   a=cfg.a, b=cfg.b, w_max=aw)
    return tuple(o[:, k] for k in range(6))


def _run_try(cfg: ExtendConfig, q, ql, t, tl, h, eb: int, act, prev0):
    """bwa's band-doubling retry loop: try i+1 runs only if try i changed
    the score (vs the score entering the try) AND its max_off >= aw/2 +
    aw/4. prev0 is the score entering try 0 (-1 for left extension, the
    post-left score for right).

    Retrying lanes are a small minority, so the doubled-band kernel runs
    on a row-compacted sub-batch (B // retry_rows); lanes that don't fit
    are covered by a full-width call (rare)."""
    B = q.shape[0]
    dev = q.device
    aw0 = cfg.w
    sc, qle, tle, gtle, gsc, moff = _kernel_call(cfg, q, ql, t, tl, h, eb,
                                                 aw0, act)
    used_w = torch.full((B,), aw0, dtype=_I32, device=dev)
    prev_sc = prev0
    zeros = lambda n: torch.zeros((n, 6), dtype=_I32, device=dev)  # noqa

    def call(rows, am, aw):
        if rows is None:
            return torch.stack(_kernel_call(cfg, q, ql, t, tl, h, eb, aw, am),
                               dim=1)
        return torch.stack(_kernel_call(cfg, q[rows], ql[rows], t[rows],
                                        tl[rows], h[rows], eb, aw, am), dim=1)
    for i in range(1, cfg.max_band_try):
        aw1 = cfg.w << i
        retry = act & (sc != prev_sc) & (moff >= (aw0 >> 1) + (aw0 >> 2))
        if cfg.retry_rows > 1 and B >= 256:
            Dr = min(max(B // cfg.retry_rows, 32), B)
            srcrow, rpos, room, dv = _compact_rows(retry, Dr)
            srcrow = srcrow.to(torch.int64)
            actc = dv & retry[srcrow]
            resc = call(srcrow, actc, aw1) if host_any(actc) else zeros(Dr)
            back = resc[rpos.clamp(0, Dr - 1).to(torch.int64)]
            covered = retry & room
            left = retry & ~room
            res_f = call(None, left, aw1) if host_any(left) else zeros(B)
            res2 = torch.where(covered[:, None], back, res_f)
        else:
            res2 = call(None, retry, aw1) if host_any(retry) else zeros(B)
        sc2, qle2, tle2, gtle2, gsc2, moff2 = (res2[:, c] for c in range(6))
        prev_sc = sc
        sc = torch.where(retry, sc2, sc)
        qle = torch.where(retry, qle2, qle)
        tle = torch.where(retry, tle2, tle)
        gtle = torch.where(retry, gtle2, gtle)
        gsc = torch.where(retry, gsc2, gsc)
        moff = torch.where(retry, moff2, moff)
        used_w = torch.where(retry, aw1, used_w)
        aw0 = aw1
    return sc, qle, tle, gtle, gsc, used_w


def _compute_ext(didx: DeviceIndex, cfg: ExtendConfig, seqs, lens,
                 sqb, srb, sln, r0, r1, active):
    """Left+right banded extension for one flat task batch (any width).

    A task = (read row, seed, chain rmax window); the result depends ONLY
    on these inputs — never on previously pushed regions — which is what
    makes the precompute+replay engine exact. Mirrors the per-seed body of
    [bwa: bwamem.c :: mem_chain2aln] (left ext with h0 = seedlen*a, right
    ext seeded with the left score, band-doubling retries, clip-vs-to-end
    decision).

    Returns dict: qb, rb, qe, re, score, truesc, w  (per task).
    """
    B, L = seqs.shape
    dev = seqs.device
    WREF = L + 2 * cal_max_gap(cfg, L)
    qi = torch.arange(L, dtype=_I32, device=dev)[None, :]
    ti = torch.arange(WREF, dtype=_I32, device=dev)[None, :]

    # ---- left extension: reversed query prefix / reversed ref window
    do_l = active & (sqb > 0)
    lq_len = torch.where(do_l, sqb, 0)
    # window lengths are < WREF — int32 regardless of position width
    lt_len = torch.where(do_l, srb - r0, 0).to(_I32)
    lq = torch.where(qi < lq_len[:, None],
                     query_window_desc(seqs, sqb, L), 4)
    lt = torch.where(ti < lt_len[:, None],
                     text_window_desc(didx, srb, WREF), 4)
    h0 = sln * cfg.a
    lsc, lqle, ltle, lgtle, lgsc, lw = _run_try(
        cfg, lq, lq_len, lt, lt_len, h0, cfg.pen_clip5, do_l,
        torch.full((B,), -1, dtype=_I32, device=dev))
    to_end_l = do_l & (lgsc > 0) & (lgsc > lsc - cfg.pen_clip5)
    # note bwa: local if gscore <= 0 or gscore <= score - pen_clip
    qb_new = torch.where(do_l, torch.where(to_end_l, 0, sqb - lqle), 0)
    rb_new = torch.where(do_l,
                         torch.where(to_end_l, srb - lgtle, srb - ltle), srb)
    score_l = torch.where(do_l, lsc, sln * cfg.a)
    truesc_l = torch.where(do_l, torch.where(to_end_l, lgsc, lsc),
                           sln * cfg.a)
    aw_l = torch.where(do_l, lw, cfg.w)

    # ---- right extension
    qe0 = sqb + sln
    do_r = active & (qe0 != lens)
    rq_len = torch.where(do_r, lens - qe0, 0)
    rt_len = torch.where(do_r, r1 - (srb + sln), 0).to(_I32)
    rq = torch.where(qi < rq_len[:, None],
                     query_window_asc(seqs, qe0, L), 4)
    rt = torch.where(ti < rt_len[:, None],
                     text_window_asc(didx, srb + sln, WREF), 4)
    rsc, rqle, rtle, rgtle, rgsc, rw = _run_try(
        cfg, rq, rq_len, rt, rt_len, score_l, cfg.pen_clip3, do_r, score_l)
    to_end_r = do_r & (rgsc > 0) & (rgsc > rsc - cfg.pen_clip3)
    # no right extension -> qe = l_query (seed already reaches the end)
    qe_new = torch.where(do_r, torch.where(to_end_r, lens, qe0 + rqle), lens)
    re_new = torch.where(do_r,
                         torch.where(to_end_r, srb + sln + rgtle,
                                     srb + sln + rtle), srb + sln)
    score_f = torch.where(do_r, rsc, score_l)
    truesc_f = truesc_l + torch.where(
        do_r, torch.where(to_end_r, rgsc, rsc) - score_l, 0)
    aw_r = torch.where(do_r, rw, cfg.w)
    return dict(qb=qb_new, rb=rb_new, qe=qe_new, re=re_new, score=score_f,
                truesc=truesc_f, w=torch.maximum(aw_l, aw_r))


def _seedcov(qbeg_r, rbeg_r, len_r, cid_r, scid, qb, qe, rb, re):
    """Sum of lengths of the chain's stored seeds fully inside the region
    box — rows are per task (any width)."""
    incov = (cid_r >= 0) & (cid_r == scid[:, None]) & \
        (qbeg_r >= qb[:, None]) & (qbeg_r + len_r <= qe[:, None]) & \
        (rbeg_r >= rb[:, None]) & (rbeg_r + len_r <= re[:, None])
    return torch.where(incov, len_r, 0).sum(dim=1, dtype=_I32)


def _extend_taskpar(didx: DeviceIndex, cfg: ExtendConfig, ctx: dict, st,
                    _stop_after: str = ""):
    """Precompute-then-replay engine (the production tier-1 path).

    Exactness argument: a seed's extension result depends only on (seed,
    chain rmax) — never on previously pushed regions — so every extension
    the scalar order could need can be computed ahead of the sequential
    walk.  The walk's only sequential decision is WHICH seeds get pushed:
    skip(seed) = contained-in-some-reg & ~rescue, where `contained` is
    monotone INcreasing and `rescue` monotone DEcreasing in (regs so far,
    seeds skipped so far).  Phase 2 therefore evaluates skip against the
    minimal state (round-1 regs only, empty skipped set), which UNDER-
    skips: the candidate set is a superset of the seeds the exact replay
    extends.  Phase 4 replays the exact [bwa: bwamem.c :: mem_chain2aln]
    visit order kernel-free, pushing precomputed results; a missing
    precompute (candidate budget overflow) flags the read for a later
    tier or the host oracle, trading throughput, never correctness.

    Phases:
      1. first-seed extension for every read (one flat kernel batch);
      2. optimistic candidate mask over all (read, seed) pairs;
      3. candidate extensions (second flat kernel batch, row-compacted);
      4. kernel-free exact replay (containment/rescue machinery of
         _Engine + precomputed pushes).

    ``_stop_after`` "tp1", "tp2" or "tp3" returns ``st`` after that phase,
    with a value of the phase folded in so that nothing of it is dead
    work: tp1 adds the first-seed rb to st["rb"], tp2 the candidate count
    a read to st["n"], tp3 a column of the precompute table to st["rb"].
    """
    pair_order, n_pairs = ctx["pair_order"], ctx["n_pairs"]
    qbeg_s, rbeg_s, len_s = ctx["qbeg_s"], ctx["rbeg_s"], ctx["len_s"]
    cid_s = ctx["cid_s"]
    rmax0, rmax1 = ctx["rmax0"], ctx["rmax1"]
    crid = ctx["crid"]
    seqs, lens = ctx["seqs"], ctx["lens"]
    B, L = seqs.shape
    S = qbeg_s.shape[1]
    C = rmax0.shape[1]
    R = cfg.max_regs
    dev = seqs.device
    stored = cid_s >= 0
    rows = torch.arange(B, dtype=torch.int64, device=dev)
    s_iota = torch.arange(S, dtype=_I32, device=dev)[None, :]

    # ---- phase 1: the first seed in processing order, every read ----
    slot0 = pair_order[:, 0].clamp(0, S - 1)
    active0 = n_pairs > 0
    sqb0 = _row_pick(qbeg_s, slot0)
    srb0 = _row_pick(rbeg_s, slot0)
    sln0 = _row_pick(len_s, slot0)
    scid0 = _row_pick(cid_s, slot0)
    scid0c = scid0.clamp(0, C - 1)
    r0_0 = _row_pick(rmax0, scid0c)
    r1_0 = _row_pick(rmax1, scid0c)
    ext0 = _compute_ext(didx, cfg, seqs, lens, sqb0, srb0, sln0,
                        r0_0, r1_0, active0)
    cov0 = _seedcov(qbeg_s, rbeg_s, len_s, cid_s, scid0,
                    ext0["qb"], ext0["qe"], ext0["rb"], ext0["re"])
    rid0 = _row_pick(crid, scid0c)
    if _stop_after == "tp1":
        st = dict(st)
        st["rb"] = st["rb"] + ext0["rb"][:, None]
        return st

    # ---- phase 2: optimistic candidate mask (superset — see above) ----
    # containment of every stored seed vs the round-1 region only
    rb0, re0 = ext0["rb"], ext0["re"]
    qb0, qe0 = ext0["qb"], ext0["qe"]
    w0 = ext0["w"]
    cont = (rbeg_s >= rb0[:, None]) & (rbeg_s + len_s <= re0[:, None]) & \
        (qbeg_s >= qb0[:, None]) & (qbeg_s + len_s <= qe0[:, None])
    len_ok = (len_s - sln0[:, None]) * 10 <= lens[:, None]
    qd = qbeg_s - qb0[:, None]
    rd = rbeg_s - rb0[:, None]
    ww = torch.minimum(cal_max_gap(cfg, torch.minimum(qd, rd)), w0[:, None])
    front = (qd - rd < ww) & (rd - qd < ww)
    qd2 = qe0[:, None] - (qbeg_s + len_s)
    rd2 = re0[:, None] - (rbeg_s + len_s)
    ww2 = torch.minimum(cal_max_gap(cfg, torch.minimum(qd2, rd2)),
                        w0[:, None])
    back = (qd2 - rd2 < ww2) & (rd2 - qd2 < ww2)
    around0 = active0[:, None] & cont & len_ok & (front | back)

    # pairwise rescue scan with the skipped set empty (superset)
    diag = rbeg_s - qbeg_s
    diag_neq = diag[:, :, None] != diag[:, None, :]
    t_len = len_s[:, None, :]
    t_qb = qbeg_s[:, None, :]
    s_ln = len_s[:, :, None]
    s_qb = qbeg_s[:, :, None]
    longer = (t_len > s_ln) | ((t_len == s_ln) &
                               (s_iota[:, None, :] > s_iota[:, :, None]))
    same_chain = stored[:, None, :] & \
        (cid_s[:, None, :] == cid_s[:, :, None])
    c1 = (s_qb <= t_qb) & (s_qb + s_ln - t_qb >= (s_ln >> 2)) & diag_neq
    c2 = (t_qb <= s_qb) & (t_qb + t_len - s_qb >= (s_ln >> 2)) & diag_neq
    thr = t_len * 100 >= s_ln * 95
    rescue0 = (same_chain & longer & thr & (c1 | c2)).any(dim=2)

    seed_rank = ctx["seed_rank"]
    first_oh = active0[:, None] & (s_iota == slot0[:, None])
    cand = stored & (seed_rank < C) & (~around0 | rescue0) & ~first_oh
    if _stop_after == "tp2":
        st = dict(st)
        st["n"] = st["n"] + cand.sum(dim=1, dtype=_I32)
        return st

    # ---- phase 3: flat candidate task batch ----
    K = max(B * cfg.cand_mult // max(cfg.cand_rows, 1), 64)
    flat_cand = cand.reshape(-1)
    cs = torch.cumsum(flat_cand.to(_I32), 0, dtype=_I32)
    tpos = cs - 1
    fits = flat_cand & (tpos < K)
    st = dict(st)
    st["overflow"] = st["overflow"] | \
        (cand & ~fits.reshape(B, S)).any(dim=1)
    src = torch.searchsorted(
        cs, torch.arange(1, K + 1, dtype=_I32, device=dev))
    srcc = src.clamp(0, B * S - 1)
    tvalid = torch.arange(K, dtype=_I32, device=dev) < cs[-1]
    srow = torch.div(srcc, S, rounding_mode="floor")
    sslot = srcc % S
    sqb_t = qbeg_s[srow, sslot]
    sln_t = len_s[srow, sslot]
    scid_t = cid_s[srow, sslot]
    srb_t = rbeg_s[srow, sslot]
    scid_tc = scid_t.clamp(0, C - 1).to(torch.int64)
    r0_t = rmax0[srow, scid_tc]
    r1_t = rmax1[srow, scid_tc]
    rid_t = crid[srow, scid_tc]
    # candidate tasks skew repeat-heavy: band-retry rates are far above
    # the first-seed batch's, so give the compacted retry more rows
    cfg3 = dataclasses.replace(cfg, retry_rows=min(cfg.retry_rows, 4))
    ext3 = _compute_ext(didx, cfg3, seqs[srow], lens[srow], sqb_t, srb_t,
                        sln_t, r0_t, r1_t, tvalid)
    cov3 = _seedcov(qbeg_s[srow], rbeg_s[srow], len_s[srow], cid_s[srow],
                    scid_t, ext3["qb"], ext3["qe"], ext3["rb"], ext3["re"])

    # ---- scatter both phases into the (B*S, 12) precompute table
    # (int64: rb needs the position width) ----
    def pack_rows(ext, cov, sln_v, rid_v, width):
        return torch.stack([
            ext["rb"].to(torch.int64), (ext["re"] - ext["rb"]),
            ext["qb"], ext["qe"], ext["score"], ext["truesc"], ext["w"],
            cov, sln_v, rid_v,
            torch.ones((width,), dtype=_I32, device=dev)],
            dim=1).to(torch.int64)

    rows0 = pack_rows(ext0, cov0, sln0, rid0, B)
    rows3 = pack_rows(ext3, cov3, sln_t, rid_t, K)
    idx0 = torch.where(active0, rows * S + slot0, B * S)
    idx3 = torch.where(tvalid, srcc, B * S)
    pre = torch.zeros((B * S + 1, 11), dtype=torch.int64, device=dev)
    pre[idx0] = rows0
    pre[idx3] = rows3
    pre = pre[:B * S]
    if _stop_after == "tp3":
        # the reference's table keeps rb as int32 halves (rb >> 30, rb &
        # (2**30 - 1)) in its first two columns, where this one keeps it
        # whole: its column 1 is the low half, int32 at either index width
        lo = (pre[:, 0] & ((1 << 30) - 1)).to(_I32)
        st["rb"] = st["rb"] + lo.reshape(B, S)[:, :1]
        return st

    # ---- phase 4: exact kernel-free replay. One step processes ONE seed
    # per read (skip OR push its precomputed region) — exactly the scalar
    # visit semantics — so the loop runs max(n_pairs) steps in total;
    # steps run in groups of 4 per host sync (a step is a no-op for
    # finished reads) ----
    eng = _Engine(didx, cfg, ctx)
    r_iota = torch.arange(R, dtype=_I32, device=dev)[None, :]
    pos_dt = rbeg_s.dtype

    def step(stt):
        p = stt["ptr"].clamp(0, S - 1)
        slot = _row_pick(pair_order, p)
        skip, active = eng.containment_skip(stt)
        stt = dict(stt)
        oh = (s_iota == slot[:, None]) & skip[:, None]
        stt["skipped"] = stt["skipped"] | oh
        do_push = active & ~skip
        fidx = (rows * S + slot).clamp(0, B * S - 1)
        v = pre[fidx]
        have = (v[:, 10] > 0) & do_push
        rb = v[:, 0].to(pos_dt)
        re = rb + v[:, 1]
        room = stt["n"] < R
        do = have & room
        stt["overflow"] = stt["overflow"] | (do_push & ~have) | \
            (have & ~room)
        tgt = torch.where(do, stt["n"], R)
        oh_tgt = r_iota == tgt[:, None]

        def put(name, val):
            stt[name] = torch.where(oh_tgt, val[:, None].to(stt[name].dtype),
                                    stt[name])
        put("rb", rb)
        put("re", re)
        put("qb", v[:, 2])
        put("qe", v[:, 3])
        put("score", v[:, 4])
        put("truesc", v[:, 5])
        put("w", v[:, 6])
        put("seedcov", v[:, 7])
        put("seedlen0", v[:, 8])
        put("cid", _row_pick(cid_s, slot))
        put("rid", v[:, 9])
        stt["n"] = stt["n"] + do.to(_I32)
        stt["ptr"] = stt["ptr"] + active.to(_I32)
        return stt

    while host_any(st["ptr"] < n_pairs):
        for _ in range(4):
            st = step(st)
    return st


class _Engine:
    """The per-round machinery over a row set (full batch or a compacted
    sub-batch): containment-skip advance, one-seed-per-read banded
    extension, and the active predicate. ctx rows define the batch."""

    def __init__(self, didx: DeviceIndex, cfg: ExtendConfig, ctx: dict):
        self.didx, self.cfg, self.ctx = didx, cfg, ctx
        self.S = ctx["qbeg_s"].shape[1]
        self.C = ctx["rmax0"].shape[1]
        dev = ctx["seqs"].device
        self.s_iota = torch.arange(self.S, dtype=_I32, device=dev)[None, :]
        self.r_iota = torch.arange(cfg.max_regs, dtype=_I32,
                                   device=dev)[None, :]

    def cur_slot(self, st):
        p = st["ptr"].clamp(0, self.S - 1)
        return _row_pick(self.ctx["pair_order"], p), \
            st["ptr"] < self.ctx["n_pairs"]

    def active(self, st):
        return st["ptr"] < self.ctx["n_pairs"]

    def containment_skip(self, st):
        """True for reads whose CURRENT seed should be skipped (no SW)."""
        ctx, cfg = self.ctx, self.cfg
        qbeg_s, rbeg_s, len_s = ctx["qbeg_s"], ctx["rbeg_s"], ctx["len_s"]
        cid_s, lens = ctx["cid_s"], ctx["lens"]
        slot, active = self.cur_slot(st)
        sqb = _row_pick(qbeg_s, slot)
        srb = _row_pick(rbeg_s, slot)
        sln = _row_pick(len_s, slot)
        scid = _row_pick(cid_s, slot)
        vr = self.r_iota < st["n"][:, None]
        cont = vr & (srb[:, None] >= st["rb"]) & \
            (srb[:, None] + sln[:, None] <= st["re"]) & \
            (sqb[:, None] >= st["qb"]) & \
            (sqb[:, None] + sln[:, None] <= st["qe"])
        len_ok = (sln[:, None] - st["seedlen0"]) * 10 <= lens[:, None]
        qd = sqb[:, None] - st["qb"]
        rd = srb[:, None] - st["rb"]
        ww = torch.minimum(cal_max_gap(cfg, torch.minimum(qd, rd)), st["w"])
        front = (qd - rd < ww) & (rd - qd < ww)
        qd2 = st["qe"] - (sqb[:, None] + sln[:, None])
        rd2 = st["re"] - (srb[:, None] + sln[:, None])
        ww2 = torch.minimum(cal_max_gap(cfg, torch.minimum(qd2, rd2)),
                            st["w"])
        back = (qd2 - rd2 < ww2) & (rd2 - qd2 < ww2)
        around = (cont & len_ok & (front | back)).any(dim=1)
        # overlapping-seed rescue scan within the same chain [the srt scan]
        t_len, t_qb, t_rb = len_s, qbeg_s, rbeg_s
        longer = (t_len > sln[:, None]) | \
            ((t_len == sln[:, None]) & (self.s_iota > slot[:, None]))
        same_chain = cid_s == scid[:, None]
        c1 = (sqb[:, None] <= t_qb) & \
            (sqb[:, None] + sln[:, None] - t_qb >= (sln[:, None] >> 2)) & \
            (t_qb - sqb[:, None] != t_rb - srb[:, None])
        c2 = (t_qb <= sqb[:, None]) & \
            (t_qb + t_len - sqb[:, None] >= (sln[:, None] >> 2)) & \
            (sqb[:, None] - t_qb != srb[:, None] - t_rb)
        thr = t_len * 100 >= sln[:, None] * 95
        rescue = ((cid_s >= 0) & same_chain & longer & ~st["skipped"] &
                  thr & (c1 | c2)).any(dim=1)
        return active & around & ~rescue, active

    def select(self, st):
        """Advance every read past its skippable seeds (no extension)."""
        while True:
            skip, _ = self.containment_skip(st)
            if not host_any(skip):
                return st
            slot, _ = self.cur_slot(st)
            st = dict(st)
            st["skipped"] = st["skipped"] | \
                ((self.s_iota == slot[:, None]) & skip[:, None])
            st["ptr"] = st["ptr"] + skip.to(_I32)

    def run_extension(self, st):
        """Extend the current seed of every active read and push its
        region."""
        ctx, cfg = self.ctx, self.cfg
        C, R = self.C, cfg.max_regs
        slot, active = self.cur_slot(st)
        sqb = _row_pick(ctx["qbeg_s"], slot)
        srb = _row_pick(ctx["rbeg_s"], slot)
        sln = _row_pick(ctx["len_s"], slot)
        scid_raw = _row_pick(ctx["cid_s"], slot)
        scid = scid_raw.clamp(0, C - 1)
        r0 = _row_pick(ctx["rmax0"], scid)
        r1 = _row_pick(ctx["rmax1"], scid)
        ext = _compute_ext(self.didx, cfg, ctx["seqs"], ctx["lens"], sqb,
                           srb, sln, r0, r1, active)
        seedcov = _seedcov(ctx["qbeg_s"], ctx["rbeg_s"], ctx["len_s"],
                           ctx["cid_s"], scid_raw, ext["qb"], ext["qe"],
                           ext["rb"], ext["re"])

        # ---- push reg
        room = st["n"] < R
        st = dict(st)
        st["overflow"] = st["overflow"] | (active & ~room)
        tgt = torch.where(active & room, st["n"], R)
        oh_tgt = self.r_iota == tgt[:, None]   # all-False when tgt == R

        def put(name, val):
            st[name] = torch.where(oh_tgt, val[:, None].to(st[name].dtype),
                                   st[name])
        put("rb", ext["rb"])
        put("re", ext["re"])
        put("qb", ext["qb"])
        put("qe", ext["qe"])
        put("score", ext["score"])
        put("truesc", ext["truesc"])
        put("w", ext["w"])
        put("seedcov", seedcov)
        put("seedlen0", sln)
        put("cid", scid_raw)
        put("rid", _row_pick(ctx["crid"], scid))
        st["n"] = st["n"] + (active & room).to(_I32)
        st["ptr"] = st["ptr"] + active.to(_I32)
        return st
