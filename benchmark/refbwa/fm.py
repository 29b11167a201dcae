"""The reference's index: the bidirectional text, its suffix array by prefix
doubling, and the FM-index rows BWA-MEM's SMEM search walks.

Conventions of bwa's index [bwa: bwtindex.c, bwt.c, bntseq.c]: the text is
the forward genome followed by its reverse complement; ambiguous bases
(code 4) are replaced by pseudo-random bases and remembered as holes; the
Burrows-Wheeler matrix has one row per suffix plus the row of the empty
suffix ('$', row 0); the interval of a pattern is a range of rows; an
occurrence count ``occ(k, c)`` counts c among the BWT characters of rows
0..k (the row whose character is '$' counts for nothing).
"""
from __future__ import annotations

import numpy as np

COMP = np.array([3, 2, 1, 0, 4], np.uint8)


def substitute_ambiguous(fwd: np.ndarray, amb_seed: int) -> np.ndarray:
    """The index's text for a genome with N runs: every code-4 base
    replaced by a base from ``numpy.random.default_rng(amb_seed)``'s
    ``integers(0, 4)``, drawn in genome order in one call (the convention
    of the index builder under test, a fixed part of the index's
    definition, as bwa's own lrand48 stream is of its index)."""
    fwd = np.asarray(fwd, np.uint8)
    amb = fwd == 4
    if not amb.any():
        return fwd
    out = fwd.copy()
    rng = np.random.default_rng(amb_seed)
    out[amb] = rng.integers(0, 4, size=int(amb.sum()), dtype=np.uint8)
    return out


def bidirectional_text(fwd: np.ndarray) -> np.ndarray:
    return np.concatenate([fwd, COMP[fwd[::-1]]])


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of ``text`` (codes 0..3), a terminator below every code
    implied at its end: int64 positions in lexicographic order.

    Prefix doubling over the suffixes that are not yet told apart: a rank
    is the number of suffixes whose prefix of the current length is
    smaller, and each round sorts only the groups of equal rank by the
    rank of the suffix h further on."""
    n = len(text)
    if n == 0:
        return np.empty(0, np.int64)
    k0 = 21                        # 3 bits a base in 63 bits
    t1 = text.astype(np.int64) + 1
    key = np.zeros(n, np.int64)
    for j in range(k0):
        key <<= 3
        if j < n:
            key[: n - j] |= t1[j:]
    order = np.argsort(key, kind="stable")
    sk = key[order]
    del key
    pos = np.arange(n, dtype=np.int64)
    new = np.ones(n, bool)
    new[1:] = sk[1:] != sk[:-1]
    del sk
    rank = np.empty(n, np.int64)
    rank[order] = np.maximum.accumulate(np.where(new, pos, 0))
    del new
    h = k0
    while True:
        sr = rank[order]
        same = sr[1:] == sr[:-1]
        del sr
        multi = np.zeros(n, bool)
        multi[1:] |= same
        multi[:-1] |= same
        del same
        P = np.flatnonzero(multi)          # sorted positions still tied
        del multi
        if P.size == 0:
            break
        U = order[P]
        r1 = rank[U]
        nxt = U + h
        r2 = np.full(U.size, -1, np.int64)
        ok = nxt < n
        r2[ok] = rank[nxt[ok]]
        srt = np.lexsort((r2, r1))
        U, r1, r2 = U[srt], r1[srt], r2[srt]
        order[P] = U
        first = np.ones(U.size, bool)
        first[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        rank[U] = np.maximum.accumulate(np.where(first, P, -1))
        h <<= 1
    return order


class RefIndex:
    """FM-index rows of a bidirectional text, held as whole arrays.

    ``text`` (uint8, 2 * l_pac), ``sa`` (suffix array of the text), and
    ``occ`` ((2 * l_pac + 1, 4) int32: occ[k, c] counts c among the BWT
    characters of rows 0..k). Contigs: ``names``, ``offs``, ``lens``."""

    def __init__(self, text, sa, occ, names, offs, lens):
        self.text = text
        self.sa_arr = sa
        self.occ = occ
        self.n = len(text)
        self.l_pac = self.n // 2
        self.names = list(names)
        self.offs = [int(x) for x in offs]
        self.lens = [int(x) for x in lens]
        counts = [int(occ[-1, c]) for c in range(4)]
        self.L2 = [0, counts[0], counts[0] + counts[1],
                   counts[0] + counts[1] + counts[2], sum(counts)]
        # the row whose BWT character is '$': the suffix at text[0]
        self.primary = int(np.flatnonzero(sa == 0)[0]) + 1

    @staticmethod
    def arrays(fwd: np.ndarray):
        """(text, sa, occ) of a forward genome of codes 0..3."""
        text = bidirectional_text(np.asarray(fwd, np.uint8))
        sa = suffix_array(text)
        n = len(text)
        bwt = np.empty(n + 1, np.uint8)
        bwt[0] = text[n - 1]
        prev = sa - 1
        bwt[1:] = np.where(sa > 0, text[np.maximum(prev, 0)], 4)
        del prev
        occ = np.empty((n + 1, 4), np.int32)
        for c in range(4):
            np.cumsum(bwt == c, dtype=np.int32, out=occ[:, c])
        sa_t = sa.astype(np.int32) if n < 2**31 - 1 else sa
        return text, sa_t, occ

    # ---- FM queries [bwa: bwt.c] ----
    def occ4(self, k: int):
        if k < 0:
            return (0, 0, 0, 0)
        return self.occ[k].tolist()

    def set_intv(self, c: int):
        L2 = self.L2
        return [L2[c] + 1, L2[3 - c] + 1, L2[c + 1] - L2[c], 0]

    def extend(self, ik, is_back: bool):
        """bwt_extend: the four intervals of ik extended by one base,
        backward (is_back) or forward; each [k, l, s, info]."""
        k, l, s, info = ik
        xs, xo = (k, l) if is_back else (l, k)
        tk = self.occ4(xs - 1)
        tl = self.occ4(xs - 1 + s)
        L2 = self.L2
        side = [L2[c] + 1 + tk[c] for c in range(4)]
        sz = [tl[c] - tk[c] for c in range(4)]
        p = self.primary
        o3 = xo + (1 if xs <= p <= xs + s - 1 else 0)
        o2 = o3 + sz[3]
        o1 = o2 + sz[2]
        o0 = o1 + sz[1]
        other = (o0, o1, o2, o3)
        if is_back:
            return [[side[c], other[c], sz[c], info] for c in range(4)]
        return [[other[c], side[c], sz[c], info] for c in range(4)]

    def sa(self, k: int) -> int:
        """Text position of BWT row k (k >= 1)."""
        return int(self.sa_arr[k - 1])

    # ---- reference sequence access [bwa: bntseq.c] ----
    def get_seq(self, beg: int, end: int) -> list:
        return self.text[beg:end].tolist()

    def depos(self, pos: int):
        is_rev = pos >= self.l_pac
        return (2 * self.l_pac - 1 - pos if is_rev else pos), is_rev

    def pos2rid(self, fwd_pos: int) -> int:
        if fwd_pos >= self.l_pac:
            return -1
        lo, hi = 0, len(self.offs) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if fwd_pos >= self.offs[mid] + self.lens[mid]:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def intv2rid(self, rb: int, re: int) -> int:
        if rb < self.l_pac < re:
            return -2
        rid_b = self.pos2rid(self.depos(rb)[0])
        rid_e = self.pos2rid(self.depos(re - 1)[0]) if rb < re else rid_b
        return rid_b if rid_b == rid_e else -1

    def fetch_seq(self, beg: int, mid: int, end: int):
        """bns_fetch_seq: [beg, end) clipped to the contig holding mid, on
        mid's strand -> (beg, end, rid, bases)."""
        fm, is_rev = self.depos(mid)
        rid = self.pos2rid(fm)
        sb, se = self.offs[rid], self.offs[rid] + self.lens[rid]
        if not is_rev:
            beg, end = max(beg, sb), min(end, se)
        else:
            beg = max(beg, 2 * self.l_pac - se)
            end = min(end, 2 * self.l_pac - sb)
        return beg, end, rid, self.get_seq(beg, end)


def smem1(idx: RefIndex, q, x: int, min_intv: int):
    """bwt_smem1 from query position x -> (next x, SMEMs), each SMEM
    [k, l, s, info] with info = start << 32 | end."""
    n = len(q)
    mem = []
    if q[x] > 3:
        return x + 1, mem
    if min_intv < 1:
        min_intv = 1
    curr = []
    ik = idx.set_intv(q[x])
    ik[3] = x + 1
    i = x + 1
    while i < n:
        if q[i] < 4:
            c = 3 - q[i]
            ok = idx.extend(ik, False)
            if ok[c][2] != ik[2]:
                curr.append(ik)
                if ok[c][2] < min_intv:
                    break
            ik = ok[c]
            ik[3] = i + 1
        else:
            curr.append(ik)
            break
        i += 1
    if i == n:
        curr.append(ik)
    curr.reverse()
    ret = curr[0][3] & 0xFFFFFFFF
    prev = curr
    i = x - 1
    while i >= -1:
        c = -1 if i < 0 else (q[i] if q[i] < 4 else -1)
        curr = []
        for p in prev:
            ok = idx.extend(p, True) if c >= 0 else None
            if c < 0 or ok[c][2] < min_intv:
                if not curr:
                    if not mem or i + 1 < (mem[-1][3] >> 32):
                        mem.append([p[0], p[1], p[2], p[3] | ((i + 1) << 32)])
            elif not curr or ok[c][2] != curr[-1][2]:
                ok[c][3] = p[3]
                curr.append(ok[c])
        if not curr:
            break
        prev = curr
        i -= 1
    mem.reverse()
    return ret, mem


def collect_intv(opt, idx: RefIndex, q):
    """mem_collect_intv: SMEMs of at least min_seed_len, then re-seeding of
    long, rare SMEMs from their middle; sorted by info (stable)."""
    n = len(q)
    out = []
    split_len = int(opt.min_seed_len * opt.split_factor + .499)
    x = 0
    while x < n:
        if q[x] < 4:
            x, mem1 = smem1(idx, q, x, 1)
            for p in mem1:
                if (p[3] & 0xFFFFFFFF) - (p[3] >> 32) >= opt.min_seed_len:
                    out.append(p)
        else:
            x += 1
    for k in range(len(out)):
        p = out[k]
        start, end = p[3] >> 32, p[3] & 0xFFFFFFFF
        if end - start < split_len or p[2] > opt.split_width:
            continue
        _, mem1 = smem1(idx, q, (start + end) >> 1, p[2] + 1)
        for p2 in mem1:
            if (p2[3] & 0xFFFFFFFF) - (p2[3] >> 32) >= opt.min_seed_len:
                out.append(p2)
    out.sort(key=lambda v: v[3])
    return out
