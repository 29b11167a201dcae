"""BWA-MEM's single-end path [bwa: bwamem.c]: chaining, chain filtering,
seed extension, de-duplication and patching of regions, primary marking,
MAPQ, the CIGAR by banded global alignment, and SAM records with their
XA and SA tags. Ties are broken as stable sorts on the keys written here
(bwa leaves some of them open; the aligner's documented rules are the
deployment's stated semantics)."""
from __future__ import annotations

import bisect
import math

from .fm import collect_intv
from .ksw import ksw_extend2, ksw_global2, score_matrix

MASK64 = 0xFFFFFFFFFFFFFFFF
MAX_BAND_TRY = 2
PATCH_MAX_R_BW = 0.15
PATCH_MIN_SC_RATIO = 0.90


class Opt:
    """bwa mem's options (bwa.1 man page defaults unless the configuration
    states others); ``mat`` is the 5 x 5 score matrix."""

    DEFAULTS = dict(
        a=1, b=4, o_del=6, e_del=1, o_ins=6, e_ins=1, pen_unpaired=17,
        pen_clip5=5, pen_clip3=5, w=100, zdrop=100, min_seed_len=19,
        split_factor=1.5, split_width=10, max_occ=500, max_chain_gap=10000,
        max_chain_extend=1 << 30, min_chain_weight=0, mask_level=0.50,
        drop_ratio=0.50, mask_level_redun=0.95, T=30, flag=0,
        mapq_coef_len=50.0, max_ins=10000, max_matesw=50, max_xa_hits=5,
        xa_drop_ratio=0.80)

    def __init__(self, **kw):
        for k, v in {**self.DEFAULTS, **kw}.items():
            if k not in self.DEFAULTS:
                raise ValueError(f"unknown option {k}")
            setattr(self, k, v)
        self.mat = score_matrix(self.a, self.b)

    def replace(self, **kw):
        d = {k: getattr(self, k) for k in self.DEFAULTS}
        d.update(kw)
        return Opt(**d)


def hash_64(key: int) -> int:
    key &= MASK64
    key = (key + (~(key << 32) & MASK64)) & MASK64
    key ^= key >> 22
    key = (key + (~(key << 13) & MASK64)) & MASK64
    key ^= key >> 8
    key = (key + (key << 3)) & MASK64
    key ^= key >> 15
    key = (key + (~(key << 27) & MASK64)) & MASK64
    key ^= key >> 31
    return key


def cal_max_gap(opt, qlen: int) -> int:
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.)
    l = l_del if l_del > l_ins else l_ins
    l = l if l > 1 else 1
    return l if l < opt.w << 1 else opt.w << 1


class Chain:
    __slots__ = ("pos", "rid", "seeds", "w", "kept", "first", "frac_rep")

    def __init__(self, pos, rid, seed):
        self.pos, self.rid, self.seeds = pos, rid, [seed]
        self.w = self.kept = 0
        self.first = -1
        self.frac_rep = 0.0


class Reg:
    """mem_alnreg_t."""
    __slots__ = ("rb", "re", "qb", "qe", "rid", "score", "truesc", "sub",
                 "csub", "sub_n", "w", "seedcov", "secondary",
                 "secondary_all", "seedlen0", "n_comp", "hash", "frac_rep")

    def __init__(self):
        self.rb = self.re = 0
        self.qb = self.qe = 0
        self.rid = -1
        self.score = self.truesc = self.sub = self.csub = self.sub_n = 0
        self.w = self.seedcov = 0
        self.secondary = self.secondary_all = -1
        self.seedlen0 = 0
        self.n_comp = 1
        self.hash = 0
        self.frac_rep = 0.0

    def copy(self):
        r = Reg()
        for k in Reg.__slots__:
            setattr(r, k, getattr(self, k))
        return r


# ---- chaining [bwa: mem_chain, test_and_merge] ----
def _test_and_merge(opt, l_pac, c: Chain, p, seed_rid) -> bool:
    rbeg, qbeg, ln = p
    last = c.seeds[-1]
    first = c.seeds[0]
    qend, rend = last[1] + last[2], last[0] + last[2]
    if seed_rid != c.rid:
        return False
    if qbeg >= first[1] and qbeg + ln <= qend and rbeg >= first[0] and \
            rbeg + ln <= rend:
        return True
    if (last[0] < l_pac or first[0] < l_pac) and rbeg >= l_pac:
        return False
    x = qbeg - last[1]
    y = rbeg - last[0]
    if y >= 0 and x - y <= opt.w and y - x <= opt.w and \
            x - last[2] < opt.max_chain_gap and y - last[2] < opt.max_chain_gap:
        c.seeds.append(p)
        return True
    return False


def mem_chain(opt, idx, q):
    """Seeds (rbeg, qbeg, len) of every SMEM occurrence, chained in order
    of position (the most recent chain at a tied position probed)."""
    n = len(q)
    if n < opt.min_seed_len:
        return []
    mem = collect_intv(opt, idx, q)
    l_rep, b, e = 0, 0, 0
    for p in mem:
        if p[2] <= opt.max_occ:
            continue
        sb, se = p[3] >> 32, p[3] & 0xFFFFFFFF
        if sb > e:
            l_rep += e - b
            b, e = sb, se
        else:
            e = max(e, se)
    l_rep += e - b
    keys: list = []       # sorted (pos, serial)
    chains: list = []     # parallel to keys
    serial = 0
    for p in mem:
        k0, _, s, info = p
        qb = info >> 32
        slen = (info & 0xFFFFFFFF) - qb
        step = s // opt.max_occ if s > opt.max_occ else 1
        k, count = 0, 0
        while k < s and count < opt.max_occ:
            rbeg = idx.sa(k0 + k)
            k += step
            count += 1
            rid = idx.intv2rid(rbeg, rbeg + slen)
            if rid < 0:
                continue
            seed = (rbeg, qb, slen)
            to_add = True
            if keys:
                it = bisect.bisect_right(keys, (rbeg, 1 << 62))
                if it > 0 and _test_and_merge(opt, idx.l_pac, chains[it - 1],
                                              seed, rid):
                    to_add = False
            if to_add:
                key = (rbeg, serial)
                serial += 1
                at = bisect.bisect_right(keys, key)
                keys.insert(at, key)
                chains.insert(at, Chain(rbeg, rid, seed))
    frac = l_rep / n
    for c in chains:
        c.frac_rep = frac
    return chains


# ---- chain filtering [bwa: mem_chain_flt, mem_chain_weight] ----
def _chain_weight(c: Chain) -> int:
    end = w = 0
    for rbeg, qbeg, ln in c.seeds:
        if qbeg >= end:
            w += ln
        elif qbeg + ln > end:
            w += qbeg + ln - end
        end = max(end, qbeg + ln)
    tmp = w
    end = w = 0
    for rbeg, qbeg, ln in c.seeds:
        if rbeg >= end:
            w += ln
        elif rbeg + ln > end:
            w += rbeg + ln - end
        end = max(end, rbeg + ln)
    w = min(w, tmp)
    return w if w < (1 << 30) else (1 << 30) - 1


def _beg(c):
    return c.seeds[0][1]


def _end(c):
    s = c.seeds[-1]
    return s[1] + s[2]


def mem_chain_flt(opt, a: list) -> list:
    for c in a:
        c.first = -1
        c.kept = 0
        c.w = _chain_weight(c)
    a = [c for c in a if c.w >= opt.min_chain_weight]
    if not a:
        return a
    a.sort(key=lambda c: (-c.w, c.pos, _beg(c)))
    kept_idx = [0]
    a[0].kept = 3
    for i in range(1, len(a)):
        large_ovlp = False
        k = 0
        while k < len(kept_idx):
            j = kept_idx[k]
            b_max = max(_beg(a[j]), _beg(a[i]))
            e_min = min(_end(a[j]), _end(a[i]))
            if e_min > b_max:
                li = _end(a[i]) - _beg(a[i])
                lj = _end(a[j]) - _beg(a[j])
                min_l = min(li, lj)
                if e_min - b_max >= min_l * opt.mask_level and \
                        min_l < opt.max_chain_gap:
                    large_ovlp = True
                    if a[j].first < 0:
                        a[j].first = i
                    if a[i].w < a[j].w * opt.drop_ratio and \
                            a[j].w - a[i].w >= opt.min_seed_len << 1:
                        break
            k += 1
        if k == len(kept_idx):
            kept_idx.append(i)
            a[i].kept = 2 if large_ovlp else 3
    for j in kept_idx:
        if a[j].first >= 0:
            a[a[j].first].kept = 1
    i = k = 0
    while i < len(a):
        if not (a[i].kept == 0 or a[i].kept == 3):
            k += 1
            if k >= opt.max_chain_extend:
                break
        i += 1
    while i < len(a):
        if a[i].kept < 3:
            a[i].kept = 0
        i += 1
    return [c for c in a if c.kept != 0]


# ---- seed extension [bwa: mem_chain2aln] ----
def mem_chain2aln(opt, idx, q, c: Chain, av: list):
    if not c.seeds:
        return
    l_query = len(q)
    l_pac = idx.l_pac
    rmax0, rmax1 = l_pac << 1, 0
    for rbeg, qbeg, ln in c.seeds:
        b = rbeg - (qbeg + cal_max_gap(opt, qbeg))
        e = rbeg + ln + ((l_query - qbeg - ln) +
                         cal_max_gap(opt, l_query - qbeg - ln))
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, l_pac << 1)
    if rmax0 < l_pac < rmax1:
        if c.seeds[0][0] < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    rmax0, rmax1, rid, rseq = idx.fetch_seq(rmax0, c.seeds[0][0], rmax1)
    srt = sorted(((s[2] << 32) | i) for i, s in enumerate(c.seeds))
    ns = len(c.seeds)
    DONE = -1
    mat = opt.mat
    for k in range(ns - 1, -1, -1):
        if srt[k] == DONE:
            continue
        s_rbeg, s_qbeg, s_len = c.seeds[srt[k] & 0xFFFFFFFF]
        i = 0
        while i < len(av):
            p = av[i]
            if s_rbeg < p.rb or s_rbeg + s_len > p.re or s_qbeg < p.qb or \
                    s_qbeg + s_len > p.qe:
                i += 1
                continue
            if s_len - p.seedlen0 > .1 * l_query:
                i += 1
                continue
            qd = s_qbeg - p.qb
            rd = s_rbeg - p.rb
            w = min(cal_max_gap(opt, min(qd, rd)), p.w)
            if qd - rd < w and rd - qd < w:
                break
            qd = p.qe - (s_qbeg + s_len)
            rd = p.re - (s_rbeg + s_len)
            w = min(cal_max_gap(opt, min(qd, rd)), p.w)
            if qd - rd < w and rd - qd < w:
                break
            i += 1
        if i < len(av):
            j = k + 1
            while j < ns:
                if srt[j] == DONE:
                    j += 1
                    continue
                t_rbeg, t_qbeg, t_len = c.seeds[srt[j] & 0xFFFFFFFF]
                if t_len < s_len * .95:
                    j += 1
                    continue
                if s_qbeg <= t_qbeg and s_qbeg + s_len - t_qbeg >= s_len >> 2 \
                        and t_qbeg - s_qbeg != t_rbeg - s_rbeg:
                    break
                if t_qbeg <= s_qbeg and t_qbeg + t_len - s_qbeg >= s_len >> 2 \
                        and s_qbeg - t_qbeg != s_rbeg - t_rbeg:
                    break
                j += 1
            if j == ns:
                srt[k] = DONE
                continue
        a = Reg()
        aw0 = aw1 = opt.w
        a.w = opt.w
        a.score = a.truesc = -1
        a.rid = c.rid
        if s_qbeg:
            qs = q[:s_qbeg][::-1]
            tmp = s_rbeg - rmax0
            rs = rseq[:tmp][::-1]
            er = None
            for ii in range(MAX_BAND_TRY):
                prev = a.score
                aw0 = opt.w << ii
                er = ksw_extend2(qs, rs, mat, opt.o_del, opt.e_del, opt.o_ins,
                                 opt.e_ins, aw0, opt.pen_clip5, opt.zdrop,
                                 s_len * opt.a)
                a.score = er[0]
                if a.score == prev or er[5] < (aw0 >> 1) + (aw0 >> 2):
                    break
            if er[4] <= 0 or er[4] <= a.score - opt.pen_clip5:
                a.qb = s_qbeg - er[1]
                a.rb = s_rbeg - er[2]
                a.truesc = a.score
            else:
                a.qb = 0
                a.rb = s_rbeg - er[3]
                a.truesc = er[4]
        else:
            a.score = a.truesc = s_len * opt.a
            a.qb = 0
            a.rb = s_rbeg
        if s_qbeg + s_len != l_query:
            qe = s_qbeg + s_len
            sc0 = a.score
            re = s_rbeg + s_len - rmax0
            er = None
            for ii in range(MAX_BAND_TRY):
                prev = a.score
                aw1 = opt.w << ii
                er = ksw_extend2(q[qe:], rseq[re:rmax1 - rmax0], mat,
                                 opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                                 aw1, opt.pen_clip3, opt.zdrop, sc0)
                a.score = er[0]
                if a.score == prev or er[5] < (aw1 >> 1) + (aw1 >> 2):
                    break
            if er[4] <= 0 or er[4] <= a.score - opt.pen_clip3:
                a.qe = qe + er[1]
                a.re = rmax0 + re + er[2]
                a.truesc += a.score - sc0
            else:
                a.qe = l_query
                a.re = rmax0 + re + er[3]
                a.truesc += er[4] - sc0
        else:
            a.qe = l_query
            a.re = s_rbeg + s_len
        cov = 0
        for t_rbeg, t_qbeg, t_len in c.seeds:
            if t_qbeg >= a.qb and t_qbeg + t_len <= a.qe and \
                    t_rbeg >= a.rb and t_rbeg + t_len <= a.re:
                cov += t_len
        a.seedcov = cov
        a.w = max(aw0, aw1)
        a.seedlen0 = s_len
        a.frac_rep = c.frac_rep
        av.append(a)


# ---- dedup / patch [bwa: mem_sort_dedup_patch, mem_patch_reg] ----
def _patch_reg(opt, idx, q, a: Reg, b: Reg):
    if a.rb < idx.l_pac and b.rb >= idx.l_pac:
        return 0, 0
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return 0, 0
    wl = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if a.re < b.rb or a.qe < b.qb:
        if wl > opt.w << 1 or r >= PATCH_MAX_R_BW:
            return 0, 0
    elif wl > opt.w << 2 or r >= PATCH_MAX_R_BW * 2:
        return 0, 0
    w = min(wl + max(a.w, b.w), opt.w << 2)
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb)) *
              (b.score + a.score) + .499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb)) *
              (b.score + a.score) + .499)
    pred = max(q_s, r_s)
    rb, re, _, rseq = idx.fetch_seq(a.rb, (a.rb + b.re) >> 1, b.re)
    if rb != a.rb or re != b.re:
        return 0, 0
    score, _ = ksw_global2(q[a.qb:b.qe], rseq, opt.mat, opt.o_del,
                           opt.e_del, opt.o_ins, opt.e_ins, w,
                           want_cigar=False)
    if score / pred < PATCH_MIN_SC_RATIO:
        return 0, 0
    return score, w


def mem_sort_dedup_patch(opt, idx, q, a: list) -> list:
    n = len(a)
    if n <= 1:
        return a
    a.sort(key=lambda x: (x.re, x.rb, x.qb))
    for p in a:
        p.n_comp = 1
    for i in range(1, n):
        p = a[i]
        if p.rid != a[i - 1].rid or p.rb >= a[i - 1].re + opt.max_chain_gap:
            continue
        j = i - 1
        while j >= 0 and p.rid == a[j].rid and \
                p.rb < a[j].re + opt.max_chain_gap:
            qq = a[j]
            if qq.qe == qq.qb:
                j -= 1
                continue
            or_ = qq.re - p.rb
            oq = qq.qe - p.qb if qq.qb < p.qb else p.qe - qq.qb
            mr = min(qq.re - qq.rb, p.re - p.rb)
            mq = min(qq.qe - qq.qb, p.qe - p.qb)
            if or_ > opt.mask_level_redun * mr and \
                    oq > opt.mask_level_redun * mq:
                if p.score < qq.score:
                    p.qe = p.qb
                    break
                qq.qe = qq.qb
            elif qq.rb < p.rb:
                score, w = _patch_reg(opt, idx, q, qq, p)
                if score > 0:
                    p.n_comp += qq.n_comp + 1
                    p.seedcov = max(p.seedcov, qq.seedcov)
                    p.sub = max(p.sub, qq.sub)
                    p.csub = max(p.csub, qq.csub)
                    p.qb = qq.qb
                    p.rb = qq.rb
                    p.truesc = p.score = score
                    p.w = w
                    qq.qb = qq.qe
            j -= 1
    a = [x for x in a if x.qe > x.qb]
    a.sort(key=lambda x: (-x.score, x.rb, x.qb))
    for i in range(1, len(a)):
        if a[i].score == a[i - 1].score and a[i].rb == a[i - 1].rb and \
                a[i].qb == a[i - 1].qb:
            a[i].qe = a[i].qb
    return [x for x in a if x.qe > x.qb]


def mem_align1(opt, idx, q) -> list:
    """Pre-pairing regions of one read (codes 0..4)."""
    chains = mem_chain_flt(opt, mem_chain(opt, idx, q))
    regs: list = []
    for c in chains:
        mem_chain2aln(opt, idx, q, c, regs)
    return mem_sort_dedup_patch(opt, idx, q, regs)


# ---- primary marking, MAPQ [bwa: mem_mark_primary_se, mem_approx_mapq_se]
def mem_mark_primary_se(opt, a: list, rid: int) -> list:
    n = len(a)
    if n == 0:
        return a
    for i, r in enumerate(a):
        r.sub = 0
        r.secondary = r.secondary_all = -1
        r.hash = hash_64(rid + i)
    a.sort(key=lambda x: (-x.score, x.hash))
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z = [0]
    for i in range(1, n):
        k = 0
        while k < len(z):
            j = z[k]
            b_max = max(a[j].qb, a[i].qb)
            e_min = min(a[j].qe, a[i].qe)
            if e_min > b_max:
                min_l = min(a[i].qe - a[i].qb, a[j].qe - a[j].qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if a[j].sub == 0:
                        a[j].sub = a[i].score
                    if a[j].score - a[i].score <= tmp:
                        a[j].sub_n += 1
                    break
            k += 1
        if k == len(z):
            z.append(i)
        else:
            a[i].secondary = z[k]
    for r in a:
        r.secondary_all = r.secondary
    return a


def mem_approx_mapq_se(opt, a: Reg) -> int:
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(sub, a.csub)
    if sub >= a.score:
        return 0
    l = max(a.qe - a.qb, a.re - a.rb)
    identity = 1. - (l * opt.a - a.score) / (opt.a + opt.b) / l
    if a.score == 0:
        mapq = 0
    elif opt.mapq_coef_len > 0:
        tmp = 1. if l < opt.mapq_coef_len else \
            math.log(opt.mapq_coef_len) / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + .499)
    else:
        mapq = int(30.0 * (1. - sub / a.score) * math.log(a.seedcov) + .499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1.) + .499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    return int(mapq * (1. - a.frac_rep) + .499)


# ---- region -> alignment [bwa: mem_reg2aln, infer_bw, bwa_gen_cigar2] ----
class Aln:
    __slots__ = ("pos", "rid", "flag", "is_rev", "mapq", "NM", "score",
                 "sub", "cigar", "md", "xa")

    def __init__(self):
        self.pos, self.rid, self.flag, self.is_rev = -1, -1, 0, 0
        self.mapq, self.NM, self.score, self.sub = 0, -1, -1, -1
        self.cigar, self.md, self.xa = [], "", ""

    def copy(self):
        t = Aln()
        for k in Aln.__slots__:
            setattr(t, k, getattr(self, k))
        t.cigar = list(self.cigar)
        return t


def _infer_bw(l1, l2, score, a, q, r):
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.)
    return max(w, abs(l1 - l2))


def _gen_cigar(opt, idx, w_, query, rb, re):
    """-> (score, cigar, NM, MD) or None where no CIGAR is possible."""
    l_query = len(query)
    if l_query <= 0 or rb >= re or (rb < idx.l_pac < re):
        return None
    rseq = idx.get_seq(rb, re)
    query = list(query)
    rlen = re - rb
    if rb >= idx.l_pac:
        query.reverse()
        rseq.reverse()
    mat = opt.mat
    if l_query == rlen and w_ == 0:
        cigar = [l_query << 4]
        score = sum(mat[rseq[i]][query[i]] for i in range(l_query))
    else:
        max_ins = int((((l_query + 1) >> 1) * mat[0][0] - opt.o_ins) /
                      opt.e_ins + 1.)
        max_del = int((((l_query + 1) >> 1) * mat[0][0] - opt.o_del) /
                      opt.e_del + 1.)
        max_gap = max(max_ins, max_del, 1)
        w = (max_gap + abs(rlen - l_query) + 1) >> 1
        w = min(w, w_)
        w = max(w, abs(rlen - l_query) + 3)
        score, cigar = ksw_global2(query, rseq, mat, opt.o_del, opt.e_del,
                                   opt.o_ins, opt.e_ins, w)
    int2base = "ACGTN" if rb < idx.l_pac else "TGCAN"
    x = y = u = n_mm = n_gap = 0
    md = []
    nc = len(cigar)
    for k, c in enumerate(cigar):
        op, ln = c & 0xf, c >> 4
        if op == 0:
            for i in range(ln):
                if query[x + i] != rseq[y + i]:
                    md.append(str(u))
                    md.append(int2base[rseq[y + i]])
                    n_mm += 1
                    u = 0
                else:
                    u += 1
            x += ln
            y += ln
        elif op == 2:
            if 0 < k < nc - 1:
                md.append(str(u))
                md.append("^")
                md.append("".join(int2base[rseq[y + i]] for i in range(ln)))
                u = 0
                n_gap += ln
            y += ln
        elif op == 1:
            x += ln
            n_gap += ln
    md.append(str(u))
    return score, cigar, n_mm + n_gap, "".join(md)


def mem_reg2aln(opt, idx, q, ar: Reg | None) -> Aln:
    a = Aln()
    l_query = len(q)
    if ar is None or ar.rb < 0 or ar.re < 0:
        a.rid, a.pos = -1, -1
        a.flag |= 0x4
        return a
    qb, qe, rb, re = ar.qb, ar.qe, ar.rb, ar.re
    a.mapq = mem_approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    tmp = _infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del)
    w2 = _infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins)
    w2 = max(w2, tmp)
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    last_sc = -(1 << 30)
    cigar, NM, md = [], -1, ""
    for _ in range(3):
        w2 = min(w2, opt.w << 2)
        g = _gen_cigar(opt, idx, w2, q[qb:qe], rb, re)
        if g is None:
            cigar, NM, md, score = [], -1, "", 0
        else:
            score, cigar, NM, md = g
        if score == last_sc or w2 == opt.w << 2:
            break
        last_sc = score
        w2 <<= 1
        if not score < ar.truesc - opt.a:
            break
    a.NM, a.md = NM, md
    pos, is_rev = idx.depos(rb if rb < idx.l_pac else re - 1)
    a.is_rev = 1 if is_rev else 0
    cigar = list(cigar)
    if cigar:
        if (cigar[0] & 0xf) == 2:
            pos += cigar[0] >> 4
            cigar.pop(0)
        elif (cigar[-1] & 0xf) == 2:
            cigar.pop()
    if qb != 0 or qe != l_query:
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            cigar.insert(0, clip5 << 4 | 3)
        if clip3:
            cigar.append(clip3 << 4 | 3)
    a.cigar = cigar
    a.rid = idx.pos2rid(pos)
    a.pos = pos - idx.offs[a.rid]
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    return a


# ---- SAM [bwa: mem_aln2sam, mem_gen_alt, mem_reg2sam] ----
def _rlen(cigar):
    return sum(c >> 4 for c in cigar if (c & 0xf) in (0, 2))


def _cigar_str(cigar):
    return "".join(f"{c >> 4}{'MIDSH'[c & 0xf]}" for c in cigar)


def aln2sam_one(opt, names, name, seq, qual, p_in: Aln, m: Aln | None,
                which: int, list_=None) -> str:
    p = p_in.copy()
    p.flag |= 0x1 if m is not None else 0
    p.flag |= 0x4 if p.rid < 0 else 0
    p.flag |= 0x8 if m is not None and m.rid < 0 else 0
    has_m = m is not None
    mate = m.copy() if has_m else None
    if p.rid < 0 and has_m and mate.rid >= 0:
        p.rid, p.pos, p.is_rev = mate.rid, mate.pos, mate.is_rev
        p.cigar = []
    if has_m and mate.rid < 0 and p.rid >= 0:
        mate.rid, mate.pos, mate.is_rev = p.rid, p.pos, p.is_rev
        mate.cigar = []
    p.flag |= 0x10 if p.is_rev else 0
    p.flag |= 0x20 if has_m and mate.is_rev else 0
    out = [name, "\t",
           str((p.flag & 0xffff) | (0x100 if p.flag & 0x10000 else 0)), "\t"]
    if p.rid >= 0:
        out += [names[p.rid], "\t", str(p.pos + 1), "\t", str(p.mapq), "\t"]
        if p.cigar:
            for c in p.cigar:
                op = c & 0xf
                if not (opt.flag & 0x200) and op in (3, 4):
                    op = 4 if which else 3
                out.append(f"{c >> 4}{'MIDSH'[op]}")
        else:
            out.append("*")
    else:
        out.append("*\t0\t0\t*")
    out.append("\t")
    if has_m and mate.rid >= 0:
        out.append("=" if p.rid == mate.rid else names[mate.rid])
        out += ["\t", str(mate.pos + 1), "\t"]
        if p.rid == mate.rid and p.cigar and mate.cigar:
            p0 = p.pos + (_rlen(p.cigar) - 1 if p.is_rev else 0)
            p1 = mate.pos + (_rlen(mate.cigar) - 1 if mate.is_rev else 0)
            sgn = 1 if p0 > p1 else (-1 if p0 < p1 else 0)
            out.append(str(-(p0 - p1 + sgn)))
        else:
            out.append("0")
    else:
        out.append("*\t0\t0")
    out.append("\t")
    if p.flag & 0x100:
        out.append("*\t*")
    else:
        qb, qe = 0, len(seq)
        if p.cigar and which and not (opt.flag & 0x200):
            if (p.cigar[0] & 0xf) in (3, 4):
                qb += p.cigar[0] >> 4
            if (p.cigar[-1] & 0xf) in (3, 4):
                qe -= p.cigar[-1] >> 4
        if not p.is_rev:
            out.append("".join("ACGTN"[seq[i]] for i in range(qb, qe)))
            out.append("\t")
            out.append(qual[qb:qe] if qual else "*")
        else:
            out.append("".join("ACGTN"[3 - seq[i] if seq[i] < 4 else 4]
                               for i in range(qe - 1, qb - 1, -1)))
            out.append("\t")
            out.append(qual[qb:qe][::-1] if qual else "*")
    if p.cigar:
        out += ["\tNM:i:", str(p.NM), "\tMD:Z:", p.md]
    if p.score >= 0:
        out += ["\tAS:i:", str(p.score)]
    if p.sub >= 0:
        out += ["\tXS:i:", str(p.sub)]
    if not (p.flag & 0x100) and list_:
        others = [i for i, r in enumerate(list_)
                  if i != which and not (r.flag & 0x100)]
        if others:
            out.append("\tSA:Z:")
            for i in others:
                r = list_[i]
                out += [names[r.rid], ",", str(r.pos + 1), ",",
                        "-" if r.is_rev else "+", ",", _cigar_str(r.cigar),
                        ",", str(r.mapq), ",", str(r.NM), ";"]
    if p.xa:
        out += ["\tXA:Z:", p.xa]
    out.append("\n")
    return "".join(out)


def gen_alt(opt, idx, a: list, q, names) -> list:
    def pri_idx(i):
        k = a[i].secondary_all
        if k >= 0 and a[i].score >= a[k].score * opt.xa_drop_ratio:
            return k
        return -1
    cnt = [0] * len(a)
    for i in range(len(a)):
        r = pri_idx(i)
        if r >= 0:
            cnt[r] += 1
    alt = [""] * len(a)
    for i in range(len(a)):
        r = pri_idx(i)
        if r < 0 or cnt[r] > opt.max_xa_hits:
            continue
        t = mem_reg2aln(opt, idx, q, a[i])
        alt[r] += (f"{names[t.rid]},{'-' if t.is_rev else '+'}{t.pos + 1},"
                   f"{_cigar_str(t.cigar)},{t.NM};")
    return alt


def gen_alt_for(opt, idx, a, q, names, pri: int) -> str:
    if opt.flag & 0x8:
        return ""
    alt = gen_alt(opt, idx, a, q, names)
    return alt[pri] if 0 <= pri < len(alt) else ""


def mem_reg2sam(opt, idx, names, name, q, qual, a: list, extra_flag: int,
                mate: Aln | None) -> str:
    XA = gen_alt(opt, idx, a, q, names) if not (opt.flag & 0x8) else []
    aa: list = []
    for k, p in enumerate(a):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and not (opt.flag & 0x8):
            continue
        if p.secondary >= 0 and p.score < a[p.secondary].score * \
                opt.drop_ratio:
            continue
        t = mem_reg2aln(opt, idx, q, p)
        t.xa = XA[k] if XA else ""
        t.flag |= extra_flag
        if p.secondary >= 0:
            t.sub = -1
        if aa and p.secondary < 0:
            t.flag |= 0x10000 if opt.flag & 0x10 else 0x800
        if aa and t.mapq > aa[0].mapq:
            t.mapq = aa[0].mapq
        aa.append(t)
    if not aa:
        t = mem_reg2aln(opt, idx, q, None)
        t.flag |= extra_flag
        return aln2sam_one(opt, names, name, q, qual, t, mate, 0)
    return "".join(aln2sam_one(opt, names, name, q, qual, t, mate, k, aa)
                   for k, t in enumerate(aa))


def align_se(opt, idx, names, name, q, qual, rid: int) -> str:
    """SAM records of one single-end read numbered rid in its run."""
    regs = mem_mark_primary_se(opt, mem_align1(opt, idx, q), rid)
    return mem_reg2sam(opt, idx, names, name, q, qual, regs, 0, None)
