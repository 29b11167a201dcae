"""Device seed chaining + chain filtering.

Exact vectorised replication of [bwa: bwamem.c :: mem_chain,
test_and_merge, mem_chain_flt, mem_chain_weight] (reference flow
[ref: worker1/MemChain.scala, MemChainFilter.scala]): seeds are visited in
SMEM order x occurrence order; each probes the most-recent chain whose pos
is the greatest <= rbeg (the B-tree "lower" lookup; tie rule pinned in
docs/PARITY.md) and merges or opens a new chain. Chain weights (query/ref
coverage union) are accumulated online, which is exact because seeds
arrive with non-decreasing qbeg/rbeg within a chain.

Everything is (B reads) batch-parallel with a sequential loop over seed
slots (chaining) and chain slots (filter); each loop takes one host sync
for its trip count.
"""
from __future__ import annotations

import dataclasses

import torch

from ..index.device import DeviceIndex, sa_lookup
from ..ops.window import slice_rows

NEG31 = -(2**31) + 1


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    max_seeds: int = 128
    max_chains: int = 32
    max_occ: int = 500
    max_chain_gap: int = 10000
    w: int = 100
    min_seed_len: int = 19
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    max_chain_extend: int = 1 << 30
    min_chain_weight: int = 0
    # budget of SA-resolved seeds per read ON AVERAGE across the batch: the
    # invPsi walk runs on a dense (B*sa_dense,) array so dead lanes cost
    # nothing; batches whose total seed count exceeds the budget overflow
    # the affected reads to a later tier or the host oracle
    sa_dense: int = 8


def _iota(n: int, like: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=like.device)


def pos2rid(didx: DeviceIndex, fwd_pos: torch.Tensor) -> torch.Tensor:
    """[bwa: bntseq.c :: bns_pos2rid] via searchsorted over sequence ends."""
    return torch.searchsorted(didx.ann_end, fwd_pos.to(didx.ann_end.dtype),
                              right=True).to(torch.int32)


def intv2rid(didx: DeviceIndex, rb: torch.Tensor,
             ln: torch.Tensor) -> torch.Tensor:
    """[bwa: bntseq.c :: bns_intv2rid]: -2 if bridging strands, -1 if
    bridging sequences, else the sequence id."""
    l_pac = didx.l_pac
    re = rb + ln
    cross = (rb < l_pac) & (re > l_pac)
    fb = torch.where(rb >= l_pac, 2 * l_pac - 1 - rb, rb)
    fe_pos = re - 1
    fe = torch.where(fe_pos >= l_pac, 2 * l_pac - 1 - fe_pos, fe_pos)
    rid_b = pos2rid(didx, fb)
    rid_e = pos2rid(didx, fe)
    rid = torch.where(rid_b == rid_e, rid_b, -1)
    return torch.where(cross, -2, rid)


def _excl_cummax(x: torch.Tensor) -> torch.Tensor:
    """Exclusive running max along the last axis (NEG31 first)."""
    inc = torch.cummax(x, dim=-1).values
    return torch.cat([torch.full_like(inc[..., :1], NEG31), inc[..., :-1]],
                     dim=-1)


def seeds_from_smems(didx: DeviceIndex, smems: dict, cfg: ChainConfig):
    """Expand SMEM intervals into located seeds (SA-resolved), bwa order.

    Returns dict: rbeg, qbeg, len, rid (B, max_seeds); valid mask; l_rep
    (B,); overflow (B,).
    """
    qb, qe, k, s, n = (smems[x] for x in ("qb", "qe", "k", "s", "n"))
    B, M = qb.shape
    # pos >= 0 marks SMEMs whose (unique) text position is pre-resolved by
    # the seeding stage (seed.lut s==1 shortcut): no SA walk needed; the
    # other seeding paths resolve every SMEM by the SA walk
    pos = smems.get("pos")
    if pos is None:
        pos = torch.full_like(k, -1)
    slot = _iota(M, qb)[None, :]
    vs = slot < n[:, None]
    slen = qe - qb
    # step/cnt are bounded by text/max_occ resp. max_occ — int32 everywhere
    step = torch.where(s > cfg.max_occ,
                       torch.div(s, cfg.max_occ, rounding_mode="floor"),
                       1).to(torch.int32)
    cnt = torch.where(vs, s.clamp(max=cfg.max_occ), 0).to(torch.int32)

    # frac_rep numerator [bwa: bwamem.c :: mem_chain]: union of repetitive
    # SMEM spans; smems are sorted by (qb, qe) so a running max suffices
    big = vs & (s > cfg.max_occ)
    qe_rep = torch.where(big, qe, NEG31)
    prev_max = _excl_cummax(qe_rep).clamp(min=0)
    contrib = torch.where(big, (qe - torch.maximum(qb, prev_max)).clamp(
        min=0), 0)
    l_rep = contrib.sum(dim=1, dtype=torch.int32)

    # flatten (smem, occurrence) pairs into seed slots, preserving order:
    # seed slot sid belongs to the first SMEM whose running end exceeds it
    ends = torch.cumsum(cnt, dim=1, dtype=torch.int32)
    offs = ends - cnt                              # exclusive prefix
    total = cnt.sum(dim=1, dtype=torch.int32)
    S = cfg.max_seeds
    sid = _iota(S, qb)[None, :].expand(B, S).contiguous()
    owner = torch.searchsorted(ends, sid, right=True)
    seed_valid = sid < total[:, None]
    own = owner.clamp(max=M - 1)

    def take(a):
        return torch.where(seed_valid, a.gather(1, own), 0)
    t_offs, t_k, t_step, qbeg, ln, t_pos = (
        take(a) for a in (offs, k, step, qb, slen, pos))
    t = sid - t_offs
    rank = t_k + t * t_step
    # each owned slot copies its SMEM's pos verbatim (s==1 SMEMs have
    # exactly one occurrence, so slot -> position is 1:1)
    t_pos = torch.where(seed_valid, t_pos, -1)
    # --- dense compaction before the invPsi walk: live lanes are row
    # prefixes, so read b's seeds occupy dense rows [rowstart[b], +total[b])
    D = B * cfg.sa_dense
    rowstart = torch.cumsum(total, 0, dtype=torch.int64) - total
    over_budget = rowstart + total > D
    tot_eff = torch.where(over_budget, 0, total)
    rowstart = torch.cumsum(tot_eff, 0, dtype=torch.int64) - tot_eff
    # read owning each dense lane: scatter row starts, then a running max
    mark = torch.full((D + 1,), -1, dtype=torch.int32, device=qb.device)
    mark[torch.where(tot_eff > 0, rowstart, D)] = _iota(B, qb)
    b_for = torch.cummax(mark[:D], dim=0).values
    b_forc = b_for.clamp(0, B - 1).to(torch.int64)
    j_in = _iota(D, qb, torch.int64) - rowstart[b_forc]
    dense_live = (b_for >= 0) & (j_in < tot_eff[b_forc]) & (j_in >= 0)
    flat_idx = (b_forc * S + j_in).clamp(0, B * S - 1)
    dense_rank = torch.where(dense_live, rank.reshape(-1)[flat_idx], 1)
    dense_pos = torch.where(dense_live, t_pos.reshape(-1)[flat_idx], -1)
    walk_live = dense_live & (dense_pos < 0)   # pre-resolved lanes skip
    dense_sa = sa_lookup(didx, torch.where(walk_live, dense_rank, 1),
                         walk_live)
    dense_sa = torch.where(dense_pos >= 0, dense_pos, dense_sa)
    rbeg = slice_rows(dense_sa, rowstart, S)
    seed_valid = seed_valid & ~over_budget[:, None]
    rbeg = torch.where(seed_valid, rbeg, 0)
    rid = intv2rid(didx, rbeg, ln)
    rid = torch.where(seed_valid, rid, -1)
    overflow = smems["overflow"] | (total > S) | over_budget
    return dict(rbeg=rbeg, qbeg=qbeg, len=ln,
                rid=rid, valid=seed_valid & (rid >= 0), l_rep=l_rep,
                overflow=overflow)


def chain_seeds(didx: DeviceIndex, seeds: dict, cfg: ChainConfig):
    """mem_chain: sequential insertion of seeds into pos-keyed chains.

    The loop runs over seed slots up to the last valid seed of the batch;
    a slot is a no-op for reads whose seed there is invalid.
    """
    rbeg, qbeg, ln, valid = (seeds[x] for x in ("rbeg", "qbeg", "len",
                                                "valid"))
    rid_s = seeds["rid"]
    B, S = rbeg.shape
    C = cfg.max_chains
    dev = rbeg.device

    def zi():
        return torch.zeros((B, C), dtype=torch.int32, device=dev)

    def zp():      # text-position fields
        return torch.zeros((B, C), dtype=rbeg.dtype, device=dev)
    st = dict(
        pos=zp(), rid=zi() - 1, first_qb=zi(), first_rb=zp(), last_qb=zi(),
        last_rb=zp(), last_len=zi(), end_q=zi(), w_q=zi(), end_r=zp(),
        w_r=zi(), n=torch.zeros((B,), dtype=torch.int32, device=dev),
        chain_id=torch.full((B, S), -1, dtype=torch.int32, device=dev),
        overflow=seeds["overflow"].clone(),
    )
    l_pac = didx.l_pac
    cidx_row = _iota(C, rbeg)[None, :]

    def body(j):
        sv = valid[:, j]
        rb, qb2, ll, rd = rbeg[:, j], qbeg[:, j], ln[:, j], rid_s[:, j]
        exists = cidx_row < st["n"][:, None]
        cand = exists & (st["pos"] <= rb[:, None])
        has = cand.any(dim=1)
        maxpos = torch.where(cand, st["pos"], NEG31).amax(dim=1)
        tie = cand & (st["pos"] == maxpos[:, None])
        cidx = torch.where(tie, cidx_row, -1).amax(dim=1)   # newest chain
        cidx_c = cidx.clamp(0, C - 1).to(torch.int64)[:, None]

        def g(a):
            return a.gather(1, cidx_c)[:, 0]
        # --- test_and_merge [bwa: bwamem.c :: test_and_merge] ---
        same_rid = rd == g(st["rid"])
        qend = g(st["last_qb"]) + g(st["last_len"])
        rend = g(st["last_rb"]) + g(st["last_len"])
        contained = (qb2 >= g(st["first_qb"])) & (qb2 + ll <= qend) & \
            (rb >= g(st["first_rb"])) & (rb + ll <= rend)
        strand_block = ((g(st["last_rb"]) < l_pac) |
                        (g(st["first_rb"]) < l_pac)) & (rb >= l_pac)
        x = qb2 - g(st["last_qb"])
        y = rb - g(st["last_rb"])
        chainable = (y >= 0) & (x - y <= cfg.w) & (y - x <= cfg.w) & \
            (x - g(st["last_len"]) < cfg.max_chain_gap) & \
            (y - g(st["last_len"]) < cfg.max_chain_gap)
        m_noapp = sv & has & same_rid & contained
        m_app = sv & has & same_rid & ~contained & ~strand_block & chainable
        new = sv & ~(m_noapp | m_app)
        room = st["n"] < C
        nslot = torch.where(new & room, st["n"], -1)
        st["overflow"] = st["overflow"] | (new & ~room)

        upd_at = torch.where(m_app, cidx, nslot)        # -1 = no update
        onehot = cidx_row == upd_at[:, None]            # (B, C)

        def set_field(name, val_app, val_new):
            v = torch.where(m_app, val_app, val_new)
            st[name] = torch.where(onehot, v[:, None], st[name])
        # last seed fields (both merge-append and new chain)
        set_field("last_qb", qb2, qb2)
        set_field("last_rb", rb, rb)
        set_field("last_len", ll, ll)
        # weight accumulators [bwa: bwamem.c :: mem_chain_weight], online
        wq_add = torch.where(qb2 >= g(st["end_q"]), ll,
                             (qb2 + ll - g(st["end_q"])).clamp(min=0))
        wr_add = torch.where(rb >= g(st["end_r"]), ll,
                             (rb + ll - g(st["end_r"])).clamp(min=0)
                             ).to(torch.int32)  # bounded by seed length
        set_field("w_q", g(st["w_q"]) + wq_add, ll)
        set_field("w_r", g(st["w_r"]) + wr_add, ll)
        set_field("end_q", torch.maximum(g(st["end_q"]), qb2 + ll), qb2 + ll)
        set_field("end_r", torch.maximum(g(st["end_r"]), rb + ll), rb + ll)
        # new-chain-only fields
        new_oh = onehot & new[:, None]
        for name, val in (("pos", rb), ("rid", rd), ("first_qb", qb2),
                          ("first_rb", rb)):
            st[name] = torch.where(new_oh, val[:, None], st[name])
        st["n"] = st["n"] + (new & room).to(torch.int32)
        # contained seeds (m_noapp) are absorbed but NOT stored [bwa:
        # test_and_merge returns 1 without pushing], so they get no slot
        assigned = torch.where(m_app, cidx,
                               torch.where(new & room, nslot, -1))
        st["chain_id"][:, j] = torch.where(sv, assigned, -1)

    # slots past the last valid seed in the whole batch are no-ops
    jmax = int(torch.where(valid, _iota(S, rbeg)[None, :] + 1, 0).amax()) \
        if B else 0
    for j in range(jmax):
        body(j)
    st["weight"] = torch.minimum(st["w_q"], st["w_r"]).clamp(max=2**30 - 1)
    return st


def chain_filter(chains: dict, cfg: ChainConfig):
    """mem_chain_flt: weight sort + overlap-based drop/shadow marking.

    Returns: order (B, C) sorted chain indices, kept (B, C) in sorted order
    (0=dropped, 1=shadowed-first, 2=kept-with-overlap, 3=primary-kept).
    """
    B, C = chains["pos"].shape
    dev = chains["pos"].device
    exists = _iota(C, chains["pos"])[None, :] < chains["n"][:, None]
    w = torch.where(exists & (chains["weight"] >= cfg.min_chain_weight),
                    chains["weight"], -1)
    beg = chains["first_qb"]
    end = chains["last_qb"] + chains["last_len"]
    # stable sort: weight desc, then pos, then qbeg (bwa ties are unstable;
    # this total order is mirrored by the oracle) — least significant key
    # first, each pass stable
    order = torch.argsort(beg, dim=1, stable=True)
    for key in (chains["pos"], -w):
        order = order.gather(1, torch.argsort(key.gather(1, order), dim=1,
                                              stable=True))

    def take(a):
        return a.gather(1, order)
    w_s, beg_s, end_s = take(w), take(beg), take(end)
    valid_s = w_s >= max(cfg.min_chain_weight, 0)
    idxs = _iota(C, w_s)[None, :]

    kept = torch.where(valid_s & (idxs == 0), 3, 0).to(torch.int32)
    first = torch.full((B, C), -1, dtype=torch.int32, device=dev)
    lj = end_s - beg_s
    w_drop = w_s.to(torch.float64) * cfg.drop_ratio

    def body(i):
        nonlocal first
        vi = valid_s[:, i]
        wi, bi, ei = w_s[:, i], beg_s[:, i], end_s[:, i]
        in_kept = (idxs < i) & (kept >= 2)
        b_max = torch.maximum(beg_s, bi[:, None])
        e_min = torch.minimum(end_s, ei[:, None])
        li = (ei - bi)[:, None]
        min_l = torch.minimum(li, lj)
        sig = in_kept & (e_min > b_max) & \
            ((e_min - b_max) >= min_l.to(torch.float64) * cfg.mask_level) & \
            (min_l < cfg.max_chain_gap)
        dropc = sig & (wi[:, None] < w_drop) & \
            ((w_s - wi[:, None]) >= 2 * cfg.min_seed_len)
        bpos = torch.where(dropc, idxs, C).amin(dim=1)
        considered = idxs <= bpos[:, None]
        first = torch.where(sig & considered & (first < 0) & vi[:, None],
                            i, first)
        large = (sig & considered).any(dim=1)
        drop = bpos < C
        kept[:, i] = torch.where(vi & ~drop, torch.where(large, 2, 3), 0)

    imax = int(chains["n"].amax()) if B else 0
    for i in range(1, imax):
        body(i)
    # chains pointed at by a kept chain's `first` become shadowed (kept=1),
    # unconditionally, as in bwa
    src = (kept >= 2) & (first >= 0)
    tgt = torch.where(src, first, C).to(torch.int64)  # column C = dump slot
    kept_pad = torch.cat([kept, torch.zeros((B, 1), dtype=torch.int32,
                                            device=dev)], dim=1)
    kept = kept_pad.scatter_(1, tgt, 1)[:, :C]
    # max_chain_extend cap [bwa: the ++k >= opt->max_chain_extend loop]
    shad = ((kept == 1) | (kept == 2)).to(torch.int32)
    cum = torch.cumsum(shad, dim=1)
    kept = torch.where((kept < 3) & (cum >= cfg.max_chain_extend), 0, kept)
    return dict(order=order.to(torch.int32), kept=kept.to(torch.int32))
