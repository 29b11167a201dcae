"""BWA-MEM's paired-end path [bwa: bwamem_pair.c]: insert-size statistics
of a batch, mate rescue by local alignment in the window the statistics
predict, the best pairing, and the two SAM records of a pair."""
from __future__ import annotations

import math

from .ksw import ksw_align
from .mem import (Reg, aln2sam_one, gen_alt_for, mem_approx_mapq_se,
                  mem_mark_primary_se, mem_reg2aln, mem_reg2sam)

MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0


class PeStat:
    __slots__ = ("low", "high", "failed", "avg", "std")

    def __init__(self):
        self.low = self.high = 0
        self.failed = 1
        self.avg = self.std = 0.0


def _raw_mapq(diff, a):
    return int(6.02 * diff / a + .499)


def infer_dir(l_pac, b1, b2):
    """-> (orientation of b2 against b1: 0 FF, 1 FR, 2 RF, 3 RR, dist)."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return ((0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3)), dist


def _cal_sub(opt, r: list) -> int:
    for j in range(1, len(r)):
        b_max = max(r[j].qb, r[0].qb)
        e_min = min(r[j].qe, r[0].qe)
        if e_min > b_max:
            min_l = min(r[j].qe - r[j].qb, r[0].qe - r[0].qb)
            if e_min - b_max >= min_l * opt.mask_level:
                return r[j].score
    return opt.min_seed_len * opt.a


def pestat(opt, l_pac, regs: list) -> list:
    """mem_pestat over a batch's pre-pairing regions (ends 2i, 2i + 1)."""
    isize = [[], [], [], []]
    for i in range(0, len(regs) - 1, 2):
        r0, r1 = regs[i], regs[i + 1]
        if not r0 or not r1:
            continue
        if _cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if _cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        if r0[0].rid != r1[0].rid:
            continue
        d, is_ = infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if 1 <= is_ <= opt.max_ins:
            isize[d].append(is_)
    pes = []
    for d in range(4):
        r = PeStat()
        q = isize[d]
        pes.append(r)
        if len(q) < MIN_DIR_CNT:
            r.failed = 1
            continue
        r.failed = 0
        q.sort()
        n = len(q)
        p25 = q[int(.25 * n + .499)]
        p75 = q[int(.75 * n + .499)]
        r.low = int(p25 - OUTLIER_BOUND * (p75 - p25) + .499)
        if r.low < 1:
            r.low = 1
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + .499)
        avg, x = 0.0, 0
        for v in q:
            if r.low <= v <= r.high:
                avg += float(v)
                x += 1
        avg /= x
        var = 0.0
        for v in q:
            if r.low <= v <= r.high:
                var += (v - avg) * (v - avg)
        r.avg = avg
        r.std = math.sqrt(var / x)
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + .499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + .499)
        if r.low > r.avg - MAX_STDDEV * r.std:
            r.low = int(r.avg - MAX_STDDEV * r.std + .499)
        if r.high < r.avg + MAX_STDDEV * r.std:
            r.high = int(r.avg + MAX_STDDEV * r.std + .499)
        if r.low < 1:
            r.low = 1
    mx = max(len(q) for q in isize)
    for d in range(4):
        if not pes[d].failed and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = 1
    return pes


def _matesw(opt, idx, pes, a: Reg, ms: list, ma: list) -> int:
    """mem_matesw: rescue of the mate ms near region a; adds regions to ma
    (kept in order of score) and returns how many."""
    l_pac = idx.l_pac
    l_ms = len(ms)
    skip = [1 if pes[r].failed else 0 for r in range(4)]
    for m in ma:
        r, dist = infer_dir(l_pac, a.rb, m.rb)
        if pes[r].low <= dist <= pes[r].high:
            skip[r] = 1
    if sum(skip) == 4:
        return 0
    n = 0
    for r in range(4):
        if skip[r]:
            continue
        pe = pes[r]
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if not is_rev:
            rb = a.rb + pe.low if is_larger else a.rb - pe.high
            re = (a.rb + pe.high if is_larger else a.rb - pe.low) + l_ms
        else:
            rb = (a.rb + pe.low if is_larger else a.rb - pe.high) - l_ms
            re = a.rb + pe.high if is_larger else a.rb - pe.low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        rid = -1
        ref = []
        if rb < re:
            rb, re, rid, ref = idx.fetch_seq(rb, (rb + re) >> 1, re)
        if not (rid == a.rid and re - rb >= opt.min_seed_len):
            continue
        seq = [3 - c if c < 4 else 4 for c in reversed(ms)] if is_rev else ms
        sc, te, qe, tb, qb, s2, _ = ksw_align(
            seq, ref, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.min_seed_len * opt.a)
        if sc >= opt.min_seed_len and qb >= 0:
            b = Reg()
            b.rid = a.rid
            b.qb = l_ms - (qe + 1) if is_rev else qb
            b.qe = l_ms - qb if is_rev else qe + 1
            b.rb = (l_pac << 1) - (rb + te + 1) if is_rev else rb + tb
            b.re = (l_pac << 1) - (rb + tb) if is_rev else rb + te + 1
            b.score = b.truesc = sc
            b.csub = s2
            b.secondary = -1
            b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
            b.w = opt.w
            t = 0
            while t < len(ma) and ma[t].score >= b.score:
                t += 1
            ma.insert(t, b)
            n += 1
    return n


def _pair(opt, idx, pes, a):
    """mem_pair -> (score, sub, n_sub, z) of the best pairing; score 0 when
    there is none."""
    l_pac = idx.l_pac
    v = []
    for r in range(2):
        for i, e in enumerate(a[r]):
            fwd = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            x = (e.rid << 32) | (fwd - (idx.offs[e.rid] if e.rid > 0 else 0))
            y = (e.score << 32) | (i << 2) | ((1 if e.rb >= l_pac else 0)
                                              << 1) | r
            v.append((x, y))
    v.sort()
    y = [-1, -1, -1, -1]
    u = []
    for i in range(len(v)):
        for r in range(2):
            d = r << 1 | ((v[i][1] >> 1) & 1)
            if pes[d].failed:
                continue
            which = r << 1 | ((v[i][1] & 1) ^ 1)
            if y[which] < 0:
                continue
            for k in range(y[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[d].high:
                    break
                if dist < pes[d].low:
                    continue
                ns = (dist - pes[d].avg) / pes[d].std
                q = int((v[i][1] >> 32) + (v[k][1] >> 32) +
                        .721 * math.log(2. * math.erfc(abs(ns) *
                                                       math.sqrt(0.5))) *
                        opt.a + .499)
                if q < 0:
                    q = 0
                u.append((q, len(u), k, i))
        y[v[i][1] & 3] = i
    if not u:
        return 0, 0, 0, None
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    u.sort()
    best = u[-1]
    sub = u[-2][0] if len(u) > 1 else 0
    n_sub = sum(1 for t in u[:-1] if t[0] + tmp >= best[0])
    z = [0, 0]
    yi, yk = v[best[3]][1], v[best[2]][1]
    z[yi & 1] = (yi & 0xFFFFFFFF) >> 2
    z[yk & 1] = (yk & 0xFFFFFFFF) >> 2
    return best[0], sub, n_sub, z


def sam_pe(opt, idx, names, pes, pid: int, name, seqs, quals, a) -> list:
    """mem_sam_pe: the SAM records of pair pid -> [end 1's, end 2's];
    a holds both ends' pre-pairing regions and is changed in place."""
    z = [0, 0]
    extra_flag = 1
    l_pac = idx.l_pac
    if not (opt.flag & 0x20):
        b = [[r.copy() for r in a[i] if r.score >= a[i][0].score -
              opt.pen_unpaired] for i in range(2)]
        for i in range(2):
            for j in range(min(len(b[i]), opt.max_matesw)):
                _matesw(opt, idx, pes, b[i][j], seqs[1 - i], a[1 - i])
    n_pri = [0, 0]
    for i in range(2):
        a[i] = mem_mark_primary_se(opt, a[i], (pid << 1) | i)
        n_pri[i] = len(a[i])
    if not (opt.flag & 0x4) and n_pri[0] and n_pri[1]:
        o, subo, n_sub, zz = _pair(opt, idx, pes, a)
        if o > 0:
            z = zz
            is_multi = []
            for i in range(2):
                j = 1
                while j < n_pri[i]:
                    if a[i][j].secondary < 0 and a[i][j].score >= opt.T:
                        break
                    j += 1
                is_multi.append(j < n_pri[i])
            if not is_multi[0] and not is_multi[1]:
                score_un = a[0][0].score + a[1][0].score - opt.pen_unpaired
                sub2 = max(subo, score_un)
                q_pe = _raw_mapq(o - sub2, opt.a)
                if n_sub > 0:
                    q_pe -= int(4.343 * math.log(n_sub + 1.) + .499)
                q_pe = min(max(q_pe, 0), 60)
                q_pe = int(q_pe * (1. - .5 * (a[0][0].frac_rep +
                                              a[1][0].frac_rep)) + .499)
                q_se = [0, 0]
                if o > score_un:
                    for i in range(2):
                        c = a[i][z[i]]
                        if c.secondary >= 0:
                            c.sub = a[i][c.secondary].score
                            c.secondary = -2
                        q_se[i] = mem_approx_mapq_se(opt, c)
                    for i in range(2):
                        q_se[i] = q_se[i] if q_se[i] > q_pe else (
                            q_pe if q_pe < q_se[i] + 40 else q_se[i] + 40)
                        q_se[i] = min(q_se[i], _raw_mapq(
                            a[i][z[i]].score - a[i][z[i]].csub, opt.a))
                    extra_flag |= 2
                else:
                    z = [0, 0]
                    q_se = [mem_approx_mapq_se(opt, a[0][0]),
                            mem_approx_mapq_se(opt, a[1][0])]
                h = []
                for i in range(2):
                    t = mem_reg2aln(opt, idx, seqs[i], a[i][z[i]])
                    t.mapq = q_se[i]
                    t.flag |= (0x40 << i) | extra_flag
                    t.flag &= ~0x100
                    h.append(t)
                for i in range(2):
                    h[i].xa = gen_alt_for(opt, idx, a[i], seqs[i], names,
                                          z[i])
                return [aln2sam_one(opt, names, name[i], seqs[i], quals[i],
                                    h[i], h[1 - i], 0) for i in range(2)]
    h = []
    for i in range(2):
        which = -1
        for j, r in enumerate(a[i]):
            if r.secondary < 0 and r.score >= opt.T:
                which = j
                break
        h.append(mem_reg2aln(opt, idx, seqs[i],
                             a[i][which] if which >= 0 else None))
    if not (opt.flag & 0x4) and h[0].rid == h[1].rid and h[0].rid >= 0 \
            and a[0] and a[1]:
        d, dist = infer_dir(l_pac, a[0][0].rb, a[1][0].rb)
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            extra_flag |= 2
    return [mem_reg2sam(opt, idx, names, name[0], seqs[0], quals[0], a[0],
                        0x41 | extra_flag, h[1]),
            mem_reg2sam(opt, idx, names, name[1], seqs[1], quals[1], a[1],
                        0x81 | extra_flag, h[0])]

