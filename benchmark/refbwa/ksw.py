"""The three dynamic programs of BWA-MEM [bwa: ksw.c]: banded extension from
a seed (``ksw_extend2``), banded global alignment with a CIGAR
(``ksw_global2``) and local alignment with a sub-optimal score and the
start of the best hit (``ksw_align``, mate rescue). Scores are exact
integers; the 5 x 5 matrix scores N at -1."""
from __future__ import annotations

import numpy as np

MINUS_INF = -0x40000000


def score_matrix(a: int, b: int):
    return [[(a if i == j else -b) if i < 4 and j < 4 else -1
             for j in range(5)] for i in range(5)]


def _profile(query, mat):
    return [[mat[t][c] for c in query] for t in range(5)]


def ksw_extend2(query, target, mat, o_del, e_del, o_ins, e_ins, w,
                end_bonus, zdrop, h0):
    """Extension of query against target from a seed scoring h0 ->
    (score, qle, tle, gtle, gscore, max_off)."""
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    if h0 < 0:
        h0 = 0
    qp = _profile(query, mat)
    eh_h = [0] * (qlen + 1)
    eh_e = [0] * (qlen + 1)
    eh_h[0] = h0
    if qlen > 0:
        eh_h[1] = h0 - oe_ins if h0 > oe_ins else 0
    j = 2
    while j <= qlen and eh_h[j - 1] > e_ins:
        eh_h[j] = eh_h[j - 1] - e_ins
        j += 1
    max_sc = max(max(r) for r in mat)
    max_ins = int((qlen * max_sc + end_bonus - o_ins) / e_ins + 1.)
    max_ins = max(max_ins, 1)
    w = min(w, max_ins)
    max_del = int((qlen * max_sc + end_bonus - o_del) / e_del + 1.)
    max_del = max(max_del, 1)
    w = min(w, max_del)
    mx, max_i, max_j, max_ie, gscore, max_off = h0, -1, -1, -1, -1, 0
    beg, end = 0, qlen
    for i in range(tlen):
        f = 0
        mm = 0
        mj = -1
        q = qp[target[i]]
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        if beg == 0:
            h1 = h0 - (o_del + e_del * (i + 1))
            if h1 < 0:
                h1 = 0
        else:
            h1 = 0
        for j in range(beg, end):
            M = eh_h[j]
            e = eh_e[j]
            eh_h[j] = h1
            M = M + q[j] if M else 0
            h = M if M > e else e
            if f > h:
                h = f
            h1 = h
            if h >= mm:
                mm = h
                mj = j
            t = M - oe_del
            if t < 0:
                t = 0
            e -= e_del
            eh_e[j] = e if e > t else t
            t = M - oe_ins
            if t < 0:
                t = 0
            f -= e_ins
            if t > f:
                f = t
        eh_h[end] = h1
        eh_e[end] = 0
        if (end if beg < end else beg) == qlen:
            if not gscore > h1:
                max_ie = i
                gscore = h1
        if mm == 0:
            break
        if mm > mx:
            mx, max_i, max_j = mm, i, mj
            d = mj - i if mj > i else i - mj
            if d > max_off:
                max_off = d
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if mx - mm - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if mx - mm - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        j = beg
        while j < end and eh_h[j] == 0 and eh_e[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and eh_h[j] == 0 and eh_e[j] == 0:
            j -= 1
        end = j + 2 if j + 2 < qlen else qlen
    return mx, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off


def _push(c, op, ln):
    if c and (c[-1] & 0xf) == op:
        c[-1] += ln << 4
    else:
        c.append(ln << 4 | op)


def ksw_global2(query, target, mat, o_del, e_del, o_ins, e_ins, w,
                want_cigar=True):
    """Banded global alignment -> (score, cigar as len << 4 | op with
    op 0 = M, 1 = I, 2 = D)."""
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    cigar = []
    if qlen == 0 or tlen == 0:
        if qlen:
            _push(cigar, 1, qlen)
        if tlen:
            _push(cigar, 2, tlen)
        return 0, cigar
    NEG = MINUS_INF
    n_col = min(qlen, 2 * w + 1)
    z = [] if want_cigar else None
    qp = _profile(query, mat)
    eh_h = [NEG] * (qlen + 1)
    eh_e = [NEG] * (qlen + 1)
    eh_h[0] = 0
    j = 1
    while j <= qlen and j <= w:
        eh_h[j] = -(o_ins + e_ins * j)
        j += 1
    for i in range(tlen):
        f = NEG
        q = qp[target[i]]
        beg = i - w if i > w else 0
        end = i + w + 1 if i + w + 1 < qlen else qlen
        h1 = -(o_del + e_del * (i + 1)) if beg == 0 else NEG
        zi = [0] * n_col if want_cigar else None
        for j in range(beg, end):
            mv = eh_h[j]
            e = eh_e[j]
            eh_h[j] = h1
            mv += q[j]
            d = 0 if mv >= e else 1
            h = mv if mv >= e else e
            if not h >= f:
                d = 2
                h = f
            h1 = h
            t = mv - oe_del
            e -= e_del
            if e > t:
                d |= 4
            else:
                e = t
            eh_e[j] = e
            t = mv - oe_ins
            f -= e_ins
            if f > t:
                d |= 32
            else:
                f = t
            if want_cigar:
                zi[j - beg] = d
        eh_h[end] = h1
        eh_e[end] = NEG
        if want_cigar:
            z.append(zi)
    score = eh_h[qlen]
    if want_cigar:
        rc = []
        i = tlen - 1
        which = 0
        k = (i + w + 1 if i + w + 1 < qlen else qlen) - 1
        while i >= 0 and k >= 0:
            tmp = z[i][k - (i - w if i > w else 0)]
            which = (tmp >> (which << 1)) & 3
            if which == 0:
                _push(rc, 0, 1)
                i -= 1
                k -= 1
            elif which == 1:
                _push(rc, 2, 1)
                i -= 1
            else:
                _push(rc, 1, 1)
                k -= 1
        if i >= 0:
            _push(rc, 2, i + 1)
        if k >= 0:
            _push(rc, 1, k + 1)
        cigar = rc[::-1]
    return score, cigar


def _local_fwd(query, target, mat, o_del, e_del, o_ins, e_ins, minsc):
    """Forward local alignment (row maxima kept for the sub-optimal score)
    -> (score, te, qe, score2, te2). One target row a step, the query as
    a NumPy vector; the insertion chain F as a running maximum."""
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    matn = np.asarray(mat, np.int64)
    qp = matn[:, np.asarray(query, np.int64)]          # (5, qlen)
    H = np.zeros(qlen + 1, np.int64)
    E = np.zeros(qlen + 1, np.int64)
    jj = np.arange(qlen, dtype=np.int64)
    ramp = e_ins * jj
    best, te, qe = 0, -1, -1
    runs = []                                          # [max, pos]
    tgt = list(target)
    for i in range(tlen):
        q = qp[tgt[i]]
        hd = H[:-1] + q                                # H(i-1, j-1) + s
        np.maximum(hd, 0, out=hd)
        g = np.maximum(hd, E[1:])                      # before F
        # F(j) = max(0, max_{j' < j} g(j') - oe_ins - (j - 1 - j') e_ins)
        a = g - oe_ins + ramp
        f = np.empty(qlen, np.int64)
        f[0] = 0
        if qlen > 1:
            # the chain F(j+1) = max(F(j) - e_ins, h(j) - oe_ins, 0): where
            # F wins at j, h(j) - oe_ins is below F(j) - e_ins, so g serves
            f[1:] = np.maximum.accumulate(a[:-1]) - ramp[:-1]
            np.maximum(f, 0, out=f)
        h = np.maximum(g, f)
        H[1:] = h
        E[1:] = np.maximum(np.maximum(E[1:] - e_del, h - oe_del), 0)
        j = int(h.argmax())
        imax = int(h[j])
        if imax > best:
            best, te, qe = imax, i, j
        if imax >= minsc:
            if not runs or runs[-1][1] + 1 != i:
                runs.append([imax, i])
            elif runs[-1][0] < imax:
                runs[-1] = [imax, i]
    score2, te2 = 0, -1
    low, high = te - qlen, te + qlen
    for m, p in runs:
        if (p < low or p > high) and m > score2:
            score2, te2 = m, p
    return best, te, qe, score2, te2


def ksw_align(query, target, mat, o_del, e_del, o_ins, e_ins, xtra_minsc):
    """Local alignment with the start of the best hit -> (score, te, qe,
    tb, qb, score2, te2)."""
    sc, te, qe, s2, te2 = _local_fwd(query, target, mat, o_del, e_del,
                                     o_ins, e_ins,
                                     xtra_minsc if xtra_minsc > 0 else 0x10000)
    if sc < xtra_minsc or te < 0:
        return sc, te, qe, -1, -1, s2, te2
    rq = list(query[: qe + 1])[::-1]
    rt = list(target[: te + 1])[::-1]
    _, gte, gqe, _, _ = _local_fwd(rq, rt, mat, o_del, e_del, o_ins, e_ins,
                                   0x10000)
    return sc, te, qe, te - gte, qe - gqe, s2, te2
