"""Per-end SMEM seeding: backward walks from every read end (see
ARCHITECTURE.md).

A differential-testing oracle, and the donor of ``_emit_mask`` to
``seed.lut`` (production seeding): this first-generation walk implements
the b_v(j) formulation independently of both other seeding paths, so the
cross-check tests catch formulation bugs a single implementation cannot.

Replaces the reference's per-read sequential ``bwt_smem1`` anchor loop
[ref: worker1/MemChain.scala :: generateChains; bwa: bwt.c :: bwt_smem1a,
bwamem.c :: mem_collect_intv] with an equivalent massively-parallel
formulation: (B reads x L end positions) independent backward walks in
lockstep. For threshold v, b_v(j) = minimal start such that read[b_v(j), j)
occurs >= v times; the SMEM set is exactly {[b_v(j), j) : b_v(j) <
b_v(j+1)}. Output order (sorted by start, end) matches mem_collect_intv's
sort.

Round 2 re-seeding (long low-occ SMEMs, from the midpoint, v = occ+1) reruns
the same walk with a per-read threshold and coverage mask, capped at
``max_reseed`` candidates; reads exceeding any cap get overflow=True and are
routed to the host oracle (identical semantics, lower throughput).

Host syncs: one ``.any()`` per two walk steps.
"""
from __future__ import annotations

import dataclasses

import torch

from ..index.device import DeviceIndex, backward_ext

NO_END = 2**30


@dataclasses.dataclass(frozen=True)
class SeedConfig:
    max_smems: int = 32      # per read, after both rounds
    max_reseed: int = 2      # round-2 candidates per read
    min_seed_len: int = 19
    split_len: int = 28      # ceil(min_seed_len * split_factor)
    split_width: int = 10


def _per_end_walk(didx: DeviceIndex, seqs: torch.Tensor, lens: torch.Tensor,
                  v: torch.Tensor):
    """For every read b and end j in [1..L]: walk left while occ >= v[b].

    seqs: (B, L) int32 codes 0..4 (pad 4); lens: (B,); v: (B,) threshold.
    Returns b_start, k, s each (B, L+1) indexed by j (entry 0 unused);
    b_start[b, j] == j means "no match of length >= 1".
    """
    B, L = seqs.shape
    dev = seqs.device
    j = torch.arange(1, L + 1, dtype=torch.int32, device=dev)[None, :]
    c0 = seqs       # lane jj <-> end j=jj+1, whose last base is seqs[:, jj]
    valid0 = (j <= lens[:, None]) & (c0 < 4)
    c0c = torch.where(valid0, c0, 0).to(torch.int64)
    k = didx.L2[c0c] + 1
    s = didx.L2[c0c + 1] - didx.L2[c0c]
    ok0 = valid0 & (s >= v[:, None])
    k = torch.where(ok0, k, 0)
    s = torch.where(ok0, s, 0)
    bpos = torch.where(ok0, j - 1, j)        # current start
    live = ok0 & (bpos > 0)

    def body(k, s, bpos, live):
        i = bpos - 1                                   # position to absorb
        c = seqs.gather(1, i.clamp(min=0).to(torch.int64))
        can = live & (c < 4)
        csafe = torch.where(can, c, 0)
        k2, s2 = backward_ext(didx, torch.where(can, k, 1),
                              torch.where(can, s, 1), csafe)
        good = can & (s2 >= v[:, None])
        k = torch.where(good, k2, k)
        s = torch.where(good, s2, s)
        bpos = torch.where(good, i, bpos)
        return k, s, bpos, good & (bpos > 0)

    # body freezes dead lanes, so two steps per host sync are exact
    while bool(live.any()):
        k, s, bpos, live = body(*body(k, s, bpos, live))

    def cat(a):    # prepend a column so arrays index naturally by j
        return torch.cat([torch.zeros((B, 1), dtype=a.dtype, device=dev), a],
                         dim=1)
    return cat(bpos), cat(k), cat(s)


def _emit_mask(bstart: torch.Tensor, lens: torch.Tensor, v_len_min: int,
               cover_mid: torch.Tensor | None = None) -> torch.Tensor:
    """SMEM emission mask over ends j in [1..L].

    bstart: (B, L+1); maximality b(j) < b(j+1) (b(len+1) := +inf), length
    >= v_len_min, and optionally b(j) <= mid < j (round-2 coverage).
    """
    B, L1 = bstart.shape
    L = L1 - 1
    j = torch.arange(1, L + 1, dtype=torch.int32, device=bstart.device)[None]
    b_j = bstart[:, 1:]
    b_next = torch.cat([bstart[:, 2:], torch.full(
        (B, 1), NO_END, dtype=bstart.dtype, device=bstart.device)], dim=1)
    b_next = torch.where(j + 1 > lens[:, None], NO_END, b_next)
    mask = (j <= lens[:, None]) & (b_j < b_next) & (b_j < j)
    mask &= (j - b_j) >= v_len_min
    if cover_mid is not None:
        mask &= (b_j <= cover_mid[:, None]) & (cover_mid[:, None] < j)
    return mask


def _compact(mask: torch.Tensor, arrays, max_out: int):
    """Scatter masked (B, L) entries into (B, max_out) slots in j order.

    Returns compacted arrays (0 past the count), count (B,), overflow (B,).
    """
    B = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int32), 1, dtype=torch.int32) - 1
    count = mask.sum(dim=1, dtype=torch.int32)
    overflow = count > max_out
    slot = torch.where(mask & (pos < max_out), pos, max_out).to(torch.int64)
    outs = []
    for a in arrays:
        out = torch.zeros((B, max_out + 1), dtype=a.dtype, device=a.device)
        out.scatter_(1, slot, torch.where(mask, a, 0))   # max_out: dump slot
        outs.append(out[:, :max_out])
    return outs, count.clamp(max=max_out), overflow


def collect_smems(didx: DeviceIndex, seqs: torch.Tensor, lens: torch.Tensor,
                  cfg: SeedConfig):
    """Both seeding rounds. seqs: (B, L) uint8/int32 codes; lens: (B,).

    Returns dict with (B, max_smems) tensors qb, qe, k, s; n (B,); overflow
    (B,). Exactly matches oracle.Oracle.smems() row order (sorted by (qb,
    qe)).
    """
    seqs = seqs.to(torch.int32)
    lens = lens.to(torch.int32)
    B, L = seqs.shape
    M = cfg.max_smems
    dev = seqs.device
    ones = torch.ones((B,), dtype=torch.int32, device=dev)
    m_iota = torch.arange(M, dtype=torch.int32, device=dev)[None, :]

    # ---- round 1 ----
    b1, k1, s1 = _per_end_walk(didx, seqs, lens, ones)
    m1 = _emit_mask(b1, lens, cfg.min_seed_len)
    j_idx = torch.arange(1, L + 1, dtype=torch.int32,
                         device=dev)[None, :].expand(B, L)
    (qb1, qe1, kk1, ss1), n1, ovf1 = _compact(
        m1, [b1[:, 1:], j_idx, k1[:, 1:], s1[:, 1:]], M)

    # ---- round 2 candidates: long + low-occ round-1 SMEMs ----
    slot_valid = m_iota < n1[:, None]
    cand = slot_valid & ((qe1 - qb1) >= cfg.split_len) & \
        (ss1 <= cfg.split_width)
    # take the first max_reseed candidates in order
    cand_rank = torch.cumsum(cand.to(torch.int32), 1, dtype=torch.int32) - 1
    ovf_cand = cand.sum(dim=1) > cfg.max_reseed

    all_qb, all_qe, all_k, all_s, all_mask = ([qb1], [qe1], [kk1], [ss1],
                                              [slot_valid])
    overflow = ovf1 | ovf_cand
    for r in range(cfg.max_reseed):
        sel = cand & (cand_rank == r)
        has = sel.any(dim=1)
        mid = torch.where(has, torch.where(sel, (qb1 + qe1) >> 1, 0)
                          .amax(dim=1), 0)
        v_r = torch.where(has, torch.where(sel, ss1, 0).amax(dim=1) + 1,
                          NO_END)
        b2, k2, s2 = _per_end_walk(didx, seqs, lens, v_r)
        m2 = _emit_mask(b2, lens, cfg.min_seed_len, cover_mid=mid)
        m2 &= has[:, None]
        (qb2, qe2, kk2, ss2), n2, ovf2 = _compact(
            m2, [b2[:, 1:], j_idx, k2[:, 1:], s2[:, 1:]], M)
        all_qb.append(qb2)
        all_qe.append(qe2)
        all_k.append(kk2)
        all_s.append(ss2)
        all_mask.append(m_iota < n2[:, None])
        overflow |= ovf2

    qb = torch.cat(all_qb, dim=1)
    qe = torch.cat(all_qe, dim=1)
    kk = torch.cat(all_k, dim=1)
    ss = torch.cat(all_s, dim=1)
    msk = torch.cat(all_mask, dim=1)

    # stable sort by (qb, qe), invalid slots last — matches the oracle's
    # stable_sort by info with round order as tiebreak (fits int32: L <= 2^14)
    key = torch.where(msk, qb * (L + 2) + qe, NO_END)
    order = torch.argsort(key, dim=1, stable=True)[:, :M]

    def take(a):
        return a.gather(1, order)
    n_total = msk.sum(dim=1, dtype=torch.int32)
    return dict(qb=take(qb), qe=take(qe), k=take(kk), s=take(ss),
                n=n_total.clamp(max=M), overflow=overflow | (n_total > M))
