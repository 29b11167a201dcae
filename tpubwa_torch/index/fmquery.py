"""Host-side (numpy) FM-index queries — the scalar reference semantics for
occ / bidirectional extension / SA resolution, mirrored 1:1 by the device
seeding paths in ``seed/``. Semantics follow [bwa: bwt.c :: bwt_occ, bwt_2occ4,
bwt_extend, bwt_sa, bwt_invPsi] exactly (see builder.py for the layout).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .builder import BASES_PER_WORD, OCC_INTERVAL, FMIndex


@dataclasses.dataclass(frozen=True)
class BiInterval:
    """Bidirectional SA interval {x0=k, x1=l, x2=s} [bwa: bwt.h :: bwtintv_t].

    ``info`` packs (start<<32|end) query coordinates like bwa does.
    """
    k: int
    l: int
    s: int
    info: int = 0


def bwt_base(idx: FMIndex, j: int) -> int:
    """Stored-BWT base at position j (post-sentinel-removal index)."""
    word = idx.bwt_words[j // BASES_PER_WORD]
    return int((word >> (2 * (j % BASES_PER_WORD))) & 3)


def occ1(idx: FMIndex, k: int, c: int) -> int:
    """#occurrences of base c in stored-BWT[0..k] inclusive, conceptual index k.

    [bwa: bwt.c :: bwt_occ] — occ(-1) = 0; indices past the sentinel row shift
    down by one because $ is not stored.
    """
    if k < 0:
        return 0
    if k >= idx.primary:
        k -= 1
    if k < 0:
        return 0
    cp = int(idx.occ_cp[k // OCC_INTERVAL, c])
    base_start = (k // OCC_INTERVAL) * OCC_INTERVAL
    cnt = 0
    for j in range(base_start, k + 1):
        if bwt_base(idx, j) == c:
            cnt += 1
    return cp + cnt


def occ4(idx: FMIndex, k: int) -> np.ndarray:
    """occ of all 4 bases at conceptual index k (inclusive)."""
    return np.array([occ1(idx, k, c) for c in range(4)], dtype=np.int64)


def bwt_extend(idx: FMIndex, ik: BiInterval, is_back: bool) -> list[BiInterval]:
    """Extend a bidirectional interval by each of the 4 bases.

    [bwa: bwt.c :: bwt_extend]. is_back=False: extend the pattern on the
    *right* (operates on the l-side interval, i.e. the revcomp pattern's
    backward extension); is_back=True: extend on the left.

    Returns ok[c] for c in 0..3 where, for is_back=False, ok[c] is the interval
    of pattern P+base(3-c)... — exactly bwa's convention: the caller indexes
    ok[3 - base] for forward extension and ok[base] for backward.
    """
    x = [ik.k, ik.l, ik.s]
    side = 1 if not is_back else 0    # !is_back in C: index where occ runs
    other = 1 - side
    tk = occ4(idx, x[side] - 1)
    tl = occ4(idx, x[side] - 1 + x[2])
    ok_k = [0] * 4   # new value for x[side]
    ok_s = [0] * 4
    for c in range(4):
        ok_k[c] = int(idx.L2[c]) + 1 + int(tk[c])
        ok_s[c] = int(tl[c] - tk[c])
    ok_other = [0] * 4
    # sentinel contributes to ok[3]'s other-side start
    sentinel = 1 if (x[side] <= idx.primary and x[side] + x[2] - 1 >= idx.primary) else 0
    ok_other[3] = x[other] + sentinel
    ok_other[2] = ok_other[3] + ok_s[3]
    ok_other[1] = ok_other[2] + ok_s[2]
    ok_other[0] = ok_other[1] + ok_s[1]
    out = []
    for c in range(4):
        kk = ok_k[c] if side == 0 else ok_other[c]
        ll = ok_other[c] if side == 0 else ok_k[c]
        out.append(BiInterval(k=kk, l=ll, s=ok_s[c], info=ik.info))
    return out


def init_interval(idx: FMIndex, base: int) -> BiInterval:
    """Interval of the single-base pattern [bwa: bwt.h :: bwt_set_intv]."""
    k = int(idx.L2[base]) + 1
    s = int(idx.L2[base + 1] - idx.L2[base])
    l = int(idx.L2[3 - base]) + 1
    return BiInterval(k=k, l=l, s=s)


def bwt_invPsi(idx: FMIndex, k: int) -> int:
    """LF step on conceptual rank k [bwa: bwt.c :: bwt_invPsi]."""
    if k == idx.primary:
        return 0
    x = k - (1 if k > idx.primary else 0)
    c = bwt_base(idx, x)
    return int(idx.L2[c]) + occ1(idx, k, c)


def bwt_sa(idx: FMIndex, k: int) -> int:
    """Text position of the suffix at conceptual rank k [bwa: bwt.c :: bwt_sa]."""
    sa = 0
    mask = idx.sa_intv - 1
    while k & mask:
        sa += 1
        k = bwt_invPsi(idx, k)
    return sa + int(idx.sa_samples[k // idx.sa_intv])
