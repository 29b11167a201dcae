"""Anchor-based SMEM seeding — bwa's own algorithm, batched as a lockstep
state machine.

A differential-testing oracle: production seeding is ``seed.lut``
(``Aligner(seed_impl="lut")``, the default); this module implements the
SAME semantics by a structurally different algorithm, so the cross-check
tests catch formulation bugs that a single implementation cannot, and
``Aligner(seed_impl="anchor")`` runs the whole pipeline on it.

Exact port of [bwa: bwt.c :: bwt_smem1a (max_intv=0); bwamem.c ::
mem_collect_intv]: per read, anchors advance to the end of the longest
forward match; each anchor runs a bidirectional forward pass (collecting the
interval stack on size changes) and a backward pass (emitting maximal
intervals); round 2 re-seeds long low-occ SMEMs from their midpoint with
min_intv = occ+1. The per-end walk (``seed.device``) does Theta(L^2/2) occ
queries per clean read; this does ~2L.

Every read advances one state-machine step per lockstep iteration:
  PH_ANCHOR: advance x / init the forward pass          (no occ queries)
  PH_FWD:    one forward extension                      (2 occ rows)
  PH_BINIT:  reverse the collected stack                (no occ queries)
  PH_BWD:    extend ALL stack entries left by one base  (2*smax occ rows)
  PH_LOC:    s==1 fast path: SA-locate + one text compare
  PH_R2:     scan for the next round-2 candidate        (no occ queries)
  PH_DONE

Host syncs: one ``.any()`` for "all done" every ``unroll`` steps, and per
step one read of which sections (forward/backward, then locate) have a
read in them; a section no read is in is skipped, which changes nothing
(its masks are all false). Ranks and interval sizes keep the index's
``pos_dtype``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..index.device import DeviceIndex, occ4_all, sa_lookup, sel4, sel_vec
from ..ops.window import query_window_asc, text_window_asc

(PH_ANCHOR, PH_FWD, PH_BINIT, PH_BWD, PH_R2, PH_DONE,
 PH_LOC, PH_CMP) = range(8)
BIG = 2**30


@dataclasses.dataclass(frozen=True)
class AnchorSeedConfig:
    max_smems: int = 32   # global emission capacity per read
    smax: int = 16        # interval-stack capacity (distinct sizes)
    bwd_dense: int = 0    # >0: run backward-extension occ queries on a
    #                       dense (B*bwd_dense,) array instead of (B, smax)
    #                       (entries that do not fit overflow the read);
    #                       0: direct (B, smax) extension
    min_seed_len: int = 19
    split_len: int = 28
    split_width: int = 10
    unroll: int = 1       # state-machine steps between two host checks of
    #                       "all done"
    fast_s1: bool = True  # s==1 forward fast path: once the interval is
    #                       unique, SA-locate it (invPsi walk) and finish the
    #                       match with ONE vectorized text comparison instead
    #                       of ~L sequential FM extensions. k is invariant
    #                       while s==1 (the unique member suffix is fixed)
    #                       and l is dead in the backward pass, so the
    #                       emitted (qb, qe, k, s) are exactly bwt_smem1's.
    row_dense: int = 4    # >0: compact PH_BWD rows to a (B/row_dense, SM)
    #                       dense grid before the occ queries (rows that
    #                       don't fit wait a step); 0: extend the full
    #                       (B, SM) grid every step


def _fwd_ext(didx, k, l, s, c_ext):
    """Forward extension by query base via complement on the l side
    [bwa: bwt_extend is_back=0]. c_ext = 3 - q[i]. Returns k', l', s'."""
    lo = occ4_all(didx, l - 1)                  # (..., 4)
    hi = occ4_all(didx, l - 1 + s)
    s_all = hi - lo
    new_l = sel_vec(didx.L2, c_ext, 4) + 1 + sel4(lo, c_ext)
    sent = ((l <= didx.primary) & (l + s - 1 >= didx.primary)).to(
        torch.int32)
    k3 = k + sent
    k2 = k3 + s_all[..., 3]
    k1 = k2 + s_all[..., 2]
    k0 = k1 + s_all[..., 1]
    new_k = torch.where(c_ext == 3, k3, torch.where(
        c_ext == 2, k2, torch.where(c_ext == 1, k1, k0)))
    return new_k, new_l, sel4(s_all, c_ext)


def _bwd_ext(didx, k, l, s, c):
    """Backward extension by base c [bwa: bwt_extend is_back=1]."""
    lo = occ4_all(didx, k - 1)
    hi = occ4_all(didx, k - 1 + s)
    s_all = hi - lo
    new_k = sel_vec(didx.L2, c, 4) + 1 + sel4(lo, c)
    sent = ((k <= didx.primary) & (k + s - 1 >= didx.primary)).to(
        torch.int32)
    l3 = l + sent
    l2 = l3 + s_all[..., 3]
    l1 = l2 + s_all[..., 2]
    l0 = l1 + s_all[..., 1]
    new_l = torch.where(c == 3, l3, torch.where(
        c == 2, l2, torch.where(c == 1, l1, l0)))
    return new_k, new_l, sel4(s_all, c)


def collect_smems_anchor(didx: DeviceIndex, seqs: torch.Tensor,
                         lens: torch.Tensor, cfg: AnchorSeedConfig):
    """Same output contract as seed.device.collect_smems: dict with
    (B, max_smems) qb/qe/k/s sorted by (qb, qe), n, overflow; and it, the
    number of state-machine steps run."""
    seqs = seqs.to(torch.int32)
    lens = lens.to(torch.int32)
    B, L = seqs.shape
    M, SM = cfg.max_smems, cfg.smax
    dev = seqs.device
    pdt = didx.pos_dtype
    i32 = torch.int32
    sidx = torch.arange(SM, dtype=i32, device=dev)[None, :]
    midx = torch.arange(M, dtype=i32, device=dev)[None, :]
    # row_dense waiting can serialize synchronized backward phases — give
    # those runs extra headroom (the hard stop overflows to the oracle)
    iter_max = (6 + 2 * max(cfg.row_dense - 1, 0)) * L \
        + 16 * (1 + cfg.max_smems // 4)

    def z(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    st = dict(
        ph=torch.where(lens > 0, PH_ANCHOR, PH_DONE).to(i32),
        round1=torch.ones((B,), dtype=torch.bool, device=dev),
        x=z(B), i=z(B), x_ret=z(B),
        min_intv=z(B, dtype=pdt) + 1,
        ik_k=z(B, dtype=pdt), ik_l=z(B, dtype=pdt), ik_s=z(B, dtype=pdt),
        ik_qe=z(B),
        # the interval stack of the current pass
        st_k=z(B, SM, dtype=pdt), st_l=z(B, SM, dtype=pdt),
        st_s=z(B, SM, dtype=pdt), st_qe=z(B, SM), n_st=z(B),
        last_start=z(B) + BIG,
        out_qb=z(B, M), out_qe=z(B, M),
        out_k=z(B, M, dtype=pdt), out_s=z(B, M, dtype=pdt),
        n_out=z(B), n_out_r1=z(B), cand_ptr=z(B),
        overflow=torch.zeros((B,), dtype=torch.bool, device=dev),
        loc_k=z(B, dtype=pdt),             # s==1 fast path: rank to locate
        s1_blk=torch.zeros((B,), dtype=torch.bool, device=dev),
    )

    def seq_at(pos):
        return seqs.gather(1, pos.clamp(0, L - 1).to(torch.int64)[:, None]
                           )[:, 0]

    def row_pick(a, col):
        """a[b, col[b]] for col in range."""
        return a.gather(1, col.to(torch.int64)[:, None])[:, 0]

    def push_stack(st, mask, k, l, s, qe):
        n = st["n_st"]
        st["overflow"] = st["overflow"] | (mask & (n >= SM))
        ok = mask & (n < SM)
        oh = ok[:, None] & (sidx == n[:, None])
        for name, val in (("st_k", k), ("st_l", l), ("st_s", s),
                          ("st_qe", qe)):
            st[name] = torch.where(oh, val[:, None], st[name])
        st["n_st"] = n + ok.to(i32)

    def emit(st, mask, qb, qe, k, s):
        keep = mask & ((qe - qb) >= cfg.min_seed_len)
        n = st["n_out"]
        st["overflow"] = st["overflow"] | (keep & (n >= M))
        ok = keep & (n < M)
        oh = ok[:, None] & (midx == n[:, None])
        for name, val in (("out_qb", qb), ("out_qe", qe), ("out_k", k),
                          ("out_s", s)):
            st[name] = torch.where(oh, val[:, None], st[name])
        st["n_out"] = n + ok.to(i32)

    def bwd_dense(st, act, cb):
        # dense compaction: only live stack entries pay for occ queries
        D = B * cfg.bwd_dense
        fa = act.reshape(-1)
        gpos = torch.cumsum(fa.to(i32), 0, dtype=i32) - 1
        inb = fa & (gpos < D)
        dest = torch.where(inb, gpos, D).to(torch.int64)

        def to_dense(a, fill):
            buf = torch.full((D + 1,), fill, dtype=a.dtype, device=dev)
            return buf.scatter_(0, dest, torch.where(
                inb, a.reshape(-1), fill))[:D]     # D: dump slot
        nk_d, nl_d, ns_d = _bwd_ext(
            didx, to_dense(st["st_k"], 1), to_dense(st["st_l"], 1),
            to_dense(st["st_s"], 1),
            to_dense(cb[:, None].expand(B, SM), 0))
        src = gpos.clamp(0, max(D - 1, 0)).to(torch.int64)
        ok = act & inb.reshape(B, SM)

        def from_dense(d, old):
            v = d[src].reshape(B, SM) if D else old
            return torch.where(ok, v, old)
        st["overflow"] = st["overflow"] | (fa & ~inb).reshape(B, SM).any(1)
        return (from_dense(nk_d, st["st_k"]), from_dense(nl_d, st["st_l"]),
                from_dense(ns_d, torch.zeros_like(st["st_s"])))

    def fwd_section(st, ph):
        # ---------- PH_FWD: lanes that were ALREADY in FWD this step ----
        p1 = (st["ph"] == PH_FWD) & (ph == PH_FWD)
        qi = seq_at(st["i"])
        at_end = p1 & ((st["i"] >= lens) | (qi > 3))
        ext = p1 & ~at_end
        c_ext = torch.where(ext, 3 - qi, 0)
        nk, nl, ns = _fwd_ext(
            didx, torch.where(ext, st["ik_k"], 1),
            torch.where(ext, st["ik_l"], 1),
            torch.where(ext, st["ik_s"], 1), c_ext)
        size_chg = ext & (ns != st["ik_s"])
        push_stack(st, at_end | size_chg, st["ik_k"], st["ik_l"],
                   st["ik_s"], st["ik_qe"])
        small = size_chg & (ns < st["min_intv"])
        to_b = at_end | small
        adv = ext & ~small
        st["ik_k"] = torch.where(adv, nk, st["ik_k"])
        st["ik_l"] = torch.where(adv, nl, st["ik_l"])
        st["ik_s"] = torch.where(adv, ns, st["ik_s"])
        st["ik_qe"] = torch.where(adv, st["i"] + 1, st["ik_qe"])
        st["i"] = torch.where(adv, st["i"] + 1, st["i"])
        st["ph"] = torch.where(to_b, PH_BINIT, st["ph"])
        if cfg.fast_s1:
            # unique interval: switch to SA-locate + direct text compare
            # (only reachable in round 1 — in round 2 min_intv >= 2, so
            # ns==1 takes the `small` exit before `adv`)
            go_loc = adv & (ns == 1) & ~st["s1_blk"]
            st["loc_k"] = torch.where(go_loc, nk, st["loc_k"])
            st["ph"] = torch.where(go_loc, PH_LOC, st["ph"])

        # ---------- PH_BINIT: runs in the same step the forward pass
        # ended, or one step after a PH_LOC finish ----
        p2 = (st["ph"] == PH_BINIT) & (to_b | (ph == PH_BINIT))
        # reverse the stack so the longest match (smallest s) comes first;
        # entries past the count become 0
        rev = st["n_st"][:, None] - 1 - sidx
        inr = rev >= 0
        rev = rev.clamp(0, SM - 1).to(torch.int64)
        for name in ("st_k", "st_l", "st_s", "st_qe"):
            a = st[name]
            r = torch.where(inr, a.gather(1, rev), 0)
            st[name] = torch.where(p2[:, None], r, a)
        st["x_ret"] = torch.where(p2 & st["round1"], st["st_qe"][:, 0],
                                  st["x_ret"])
        st["i"] = torch.where(p2, st["x"] - 1, st["i"])
        st["ph"] = torch.where(p2, PH_BWD, st["ph"])

    def bwd_section(st, ph):
        # ---------- PH_BWD ----------
        p3 = (st["ph"] == PH_BWD) & (ph == PH_BWD)
        qi2 = seq_at(st["i"])
        has_c = p3 & (st["i"] >= 0) & (qi2 < 4)
        cb = torch.where(has_c, qi2, 0)
        in_st = sidx < st["n_st"][:, None]
        act = in_st & has_c[:, None]
        if cfg.row_dense > 0:
            # ROW compaction: only reads taking a backward step this
            # iteration extend their stacks; reads that don't fit into the
            # Dr dense rows WAIT (stay in PH_BWD, stepped next iteration)
            Dr = max(min(B // cfg.row_dense, B), 8)
            rpos = torch.cumsum(has_c.to(i32), 0, dtype=i32) - 1
            room = has_c & (rpos < Dr)
            dest = torch.where(room, rpos, Dr).to(torch.int64)
            srcrow = torch.zeros((Dr + 1,), dtype=torch.int64, device=dev)
            srcrow = srcrow.scatter_(0, dest, torch.arange(
                B, dtype=torch.int64, device=dev))[:Dr]   # Dr: dump slot
            dk = st["st_k"][srcrow]
            dl = st["st_l"][srcrow]
            ds = st["st_s"][srcrow]
            # dead dense rows point at read 0 — their results are never
            # applied (act is False there)
            dact = sidx < st["n_st"][srcrow][:, None]
            nk, nl, ns = _bwd_ext(
                didx, torch.where(dact, dk, 1), torch.where(dact, dl, 1),
                torch.where(dact, ds, 1), cb[srcrow][:, None].expand(Dr, SM))
            rb_i = rpos.clamp(0, Dr - 1).to(torch.int64)
            act = act & room[:, None]
            bk = torch.where(act, nk[rb_i], st["st_k"])
            bl = torch.where(act, nl[rb_i], st["st_l"])
            bs = torch.where(act, ns[rb_i], 0)
            # rows that step this iteration: got a dense slot, or have no
            # base to extend (their entries all fail, no occ query)
            p3 = p3 & (room | ~has_c)
            has_c = has_c & room
        elif cfg.bwd_dense == 0:
            bk, bl, bs = _bwd_ext(
                didx, torch.where(act, st["st_k"], 1),
                torch.where(act, st["st_l"], 1),
                torch.where(act, st["st_s"], 1),
                torch.where(act, cb[:, None], 0))
            bs = torch.where(act, bs, 0)
            bk = torch.where(act, bk, st["st_k"])
            bl = torch.where(act, bl, st["st_l"])
        else:
            bk, bl, bs = bwd_dense(st, act, cb)
        fail = in_st & (~has_c[:, None] | (bs < st["min_intv"][:, None]))
        surv = in_st & ~fail
        # output: first failing entry with no survivor before it
        first_fail = torch.where(fail, sidx, SM).amin(dim=1)
        first_surv = torch.where(surv, sidx, SM).amin(dim=1)
        do_out = p3 & (first_fail < SM) & (first_fail < first_surv) & \
            (st["i"] + 1 < st["last_start"])
        ff = first_fail.clamp(0, SM - 1)
        emit(st, do_out, st["i"] + 1, row_pick(st["st_qe"], ff),
             row_pick(st["st_k"], ff), row_pick(st["st_s"], ff))
        # bwa tracks the last RECORDED entry's start (containment skips do
        # not move it)
        st["last_start"] = torch.where(do_out, st["i"] + 1,
                                       st["last_start"])
        # new stack: survivors, consecutive equal-s deduped (keep first):
        # lastj = the nearest survivor strictly before each entry
        upto = torch.cummax(torch.where(surv, sidx, -1), dim=1).values
        lastj = torch.cat([torch.full((B, 1), -1, dtype=i32, device=dev),
                           upto[:, :-1]], dim=1)
        s_before = torch.where(lastj >= 0, bs.gather(
            1, lastj.clamp(min=0).to(torch.int64)), -1)
        keep = surv & ((bs != s_before) | (lastj < 0))
        kpos = torch.cumsum(keep.to(i32), 1, dtype=i32) - 1
        new_n = keep.sum(dim=1, dtype=i32)
        kdest = torch.where(keep, kpos, SM).to(torch.int64)

        def compact(vals, old):
            arr = torch.zeros((B, SM + 1), dtype=vals.dtype, device=dev)
            arr.scatter_(1, kdest, torch.where(keep, vals, 0))  # SM: dump
            return torch.where(p3[:, None], arr[:, :SM], old)
        st["st_qe"] = compact(st["st_qe"], st["st_qe"])
        st["st_k"] = compact(bk, st["st_k"])
        st["st_l"] = compact(bl, st["st_l"])
        st["st_s"] = compact(bs, st["st_s"])
        st["n_st"] = torch.where(p3, new_n, st["n_st"])
        empty = p3 & (new_n == 0)
        st["i"] = torch.where(p3 & ~empty, st["i"] - 1, st["i"])
        # smem1 finished: round 1 -> next anchor; round 2 -> next candidate
        st["x"] = torch.where(empty & st["round1"], st["x_ret"], st["x"])
        st["ph"] = torch.where(
            empty, torch.where(st["round1"], PH_ANCHOR, PH_R2), st["ph"])

    def loc_section(st):
        # s==1 fast path [bwa: bwt_smem1 forward loop, s invariant]: the
        # unique suffix's text position comes from one SA walk; the rest
        # of the forward match is ONE vectorized window compare instead of
        # ~L sequential FM extensions. k is invariant while every
        # extension succeeds, so the pushed (k, s=1, qe) is exactly what
        # the FM loop would push at its final size change / end-of-query.
        p = st["ph"] == PH_LOC
        pos = sa_lookup(didx, torch.where(p, st["loc_k"], 0), p)
        i = st["i"]
        tstart = pos + (i - st["x"])        # text pos of q[i]'s mate
        qw = query_window_asc(seqs, i, L)   # q[i + j]
        tw = text_window_asc(didx, tstart.clamp(0, 2 * didx.l_pac - 1), L)
        jj = torch.arange(L, dtype=i32, device=dev)[None, :]
        # the window is strand-contiguous only up to the fwd/rev boundary;
        # a match still alive there must bail to FM steps
        bound = torch.where(tstart < didx.l_pac, didx.l_pac,
                            2 * didx.l_pac)
        tcap = bound - tstart
        qcap = lens - i
        okm = (qw == tw) & (qw <= 3) & (jj < tcap[:, None]) & \
            (jj < qcap[:, None])
        m = torch.cumprod(okm.to(i32), dim=1).sum(dim=1, dtype=i32)
        bail = p & (m == tcap) & (m < qcap) & (seq_at(i + m) <= 3)
        fin = p & ~bail
        push_stack(st, fin, st["ik_k"], st["ik_l"], st["ik_s"], i + m)
        st["s1_blk"] = st["s1_blk"] | bail
        st["ph"] = torch.where(fin, PH_BINIT,
                               torch.where(bail, PH_FWD, st["ph"]))

    def body(st, it):
        ph = st["ph"]

        # ---------- PH_ANCHOR: round-1 anchor advance / F init ----------
        p0 = ph == PH_ANCHOR
        qx = seq_at(st["x"])
        r1_done = p0 & (st["x"] >= lens)
        skipN = p0 & ~r1_done & (qx > 3)
        startF = p0 & ~r1_done & ~skipN
        st["x"] = torch.where(skipN, st["x"] + 1, st["x"])

        # ---------- PH_R2: next round-2 candidate ----------
        p4 = ph == PH_R2
        is_cand = (midx >= st["cand_ptr"][:, None]) & \
            (midx < st["n_out_r1"][:, None]) & \
            ((st["out_qe"] - st["out_qb"]) >= cfg.split_len) & \
            (st["out_s"] <= cfg.split_width)
        nxt = torch.where(is_cand, midx, M).amin(dim=1)
        has_cand = p4 & (nxt < M)
        r2_done = p4 & ~has_cand
        nxt_c = nxt.clamp(0, M - 1)
        c_qb = row_pick(st["out_qb"], nxt_c)
        c_qe = row_pick(st["out_qe"], nxt_c)
        c_s = row_pick(st["out_s"], nxt_c)
        mid = (c_qb + c_qe) >> 1
        qmid = seq_at(mid)
        st["cand_ptr"] = torch.where(has_cand, nxt + 1, st["cand_ptr"])
        startF2 = has_cand & (qmid <= 3)
        # a candidate whose midpoint is N: smem1 is a no-op; stay in PH_R2
        st["x"] = torch.where(startF2, mid, st["x"])
        st["min_intv"] = torch.where(startF2, c_s + 1, st["min_intv"])
        st["round1"] = st["round1"] & ~startF2

        # common F init
        fi = startF | startF2
        c0 = torch.where(fi, torch.where(startF, qx, qmid), 0)
        L2c0 = sel_vec(didx.L2, c0, 4)
        L2c1 = sel_vec(didx.L2, c0 + 1, 5)
        st["ik_k"] = torch.where(fi, L2c0 + 1, st["ik_k"])
        st["ik_l"] = torch.where(fi, sel_vec(didx.L2, 3 - c0, 4) + 1,
                                 st["ik_l"])
        st["ik_s"] = torch.where(fi, L2c1 - L2c0, st["ik_s"])
        st["ik_qe"] = torch.where(fi, st["x"] + 1, st["ik_qe"])
        st["i"] = torch.where(fi, st["x"] + 1, st["i"])
        st["n_st"] = torch.where(fi, 0, st["n_st"])
        st["last_start"] = torch.where(fi, BIG, st["last_start"])
        st["s1_blk"] = st["s1_blk"] & ~fi

        st["ph"] = torch.where(r1_done, PH_R2, torch.where(
            fi, PH_FWD, torch.where(r2_done, PH_DONE, ph))).to(i32)

        # the forward/backward sections carry the occ queries; each runs
        # only when some read was in its phase at the start of the step
        run_fwd, run_bwd = torch.stack([
            ((ph == PH_FWD) | (ph == PH_BINIT)).any(),
            (ph == PH_BWD).any()]).tolist()
        if run_fwd:
            fwd_section(st, ph)
        if run_bwd:
            bwd_section(st, ph)
        if bool((st["ph"] == PH_LOC).any()):
            loc_section(st)

        # close round 1 bookkeeping when transitioning to PH_R2 from anchor
        st["n_out_r1"] = torch.where(r1_done, st["n_out"], st["n_out_r1"])
        if it + 1 >= iter_max:
            st["overflow"] = st["overflow"] | (st["ph"] != PH_DONE)
            st["ph"] = torch.full_like(st["ph"], PH_DONE)

    it = 0
    while bool((st["ph"] != PH_DONE).any()):
        for _ in range(cfg.unroll):
            body(st, it)
            it += 1

    # final sort by (qb, qe), stable — matches the oracle's stable sort
    msk = midx < st["n_out"][:, None]
    key = torch.where(msk, st["out_qb"] * (L + 2) + st["out_qe"], BIG)
    order = torch.argsort(key, dim=1, stable=True)

    def take(a):
        return a.gather(1, order)
    return dict(qb=take(st["out_qb"]), qe=take(st["out_qe"]),
                k=take(st["out_k"]), s=take(st["out_s"]), n=st["n_out"],
                overflow=st["overflow"],
                it=torch.tensor(it, dtype=i32, device=dev))
