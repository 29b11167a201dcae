"""Per-end SMEM seeding with a k-mer jump table and an s==1 SA shortcut.

Seeding in O(10) lockstep iterations per batch:

  1. **k-mer jump table**: the bidirectional FM interval (k, s) of every
     length-k0 string is precomputed host-side (plus, for unique k-mers,
     the resolved text position).  Every (read, end) walk starts at length
     k0 with ONE row gather instead of k0 sequential FM extensions.
  2. **per-end walks**: for threshold v, b_v(j) = minimal start such that
     read[b_v(j), j) occurs >= v times; the SMEM set is exactly
     {[b_v(j), j) : b_v(j) < b_v(j+1), length >= min_seed_len} (see
     ARCHITECTURE.md for the equivalence proof vs [bwa: bwt.c::bwt_smem1a,
     bwamem.c::mem_collect_intv]).  All B x L ends extend in lockstep.
  3. **s==1 shortcut**: once an interval is unique its text position is
     known (from the jump table, or one batched SA walk), and the rest of
     the walk is ONE vectorised text comparison instead of per-base FM
     extensions.

Exactness with a truncated table (k0 <= min_seed_len): an end whose k0-mer
is absent (or below threshold) has b(j) > j-k0 >= j-min_seed_len, so it can
never emit; and the only other consumer of b(j) is end j-1's maximality
test b(j-1) < b(j), where an emitting j-1 has b(j-1) <= j-1-min_seed_len
< j-k0+1 <= b(j), so the test's outcome is exact no matter what in-range
placeholder we store.  We store b(j) := j ("no match") for such lanes.

Every phase runs on a compacted live set with a fixed budget (the
``LutSeedConfig`` dense fields); reads that do not fit a budget, or whose
s==1 text comparison would cross the forward/reverse strand boundary, are
flagged overflow and realigned by a later tier or the host oracle,
preserving exactness. The budgets are part of the result: they decide
which reads overflow, so they match the reference package's exactly.

Host syncs: the dense FM loop takes one ``.any()`` per two FM steps.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..index.builder import FMIndex
from ..index.device import DeviceIndex, backward_ext, sa_lookup
from ..ops.window import shift_left, text_window_asc, text_window_desc
from ..utils.files import write_atomic
from ..utils.profiling import host_any
from .device import _emit_mask

BIG = 2**30


# --------------------------------------------------------------------------
# host-side jump-table construction
# --------------------------------------------------------------------------

def _popcount32_np(x: np.ndarray) -> np.ndarray:
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int64)


def _occ1_vec(idx: FMIndex, k: np.ndarray, c: int) -> np.ndarray:
    """Vectorized [bwa: bwt.c :: bwt_occ]: count of base c in
    stored-BWT[0..k] inclusive, conceptual (sentinel-aware) index k."""
    k = k.astype(np.int64)
    n = np.where(k < 0, 0, k + 1 - (k >= idx.primary))
    n = np.maximum(n, 0)
    r = np.maximum(n - 1, 0) >> 6
    cp = idx.occ_cp[r, c].astype(np.int64)
    m = n - r * 64
    w = idx.bwt_words[(r * 4)[:, None] + np.arange(4)]          # (N, 4)
    pat = np.uint32(c * 0x55555555)
    x = w ^ pat
    neq = (x | (x >> np.uint32(1))) & np.uint32(0x55555555)
    eq = neq ^ np.uint32(0x55555555)
    valid = np.clip(m[:, None] - np.arange(4) * 16, 0, 16)
    sh = np.where(valid >= 16, 0, 2 * valid).astype(np.uint32)
    mask = np.where(valid >= 16, np.uint32(0xFFFFFFFF),
                    (np.uint32(1) << sh) - np.uint32(1))
    return cp + _popcount32_np(eq & mask).sum(axis=1)


def _invpsi_vec(idx: FMIndex, k: np.ndarray) -> np.ndarray:
    """Vectorized [bwa: bwt.c :: bwt_invPsi] (LF step on conceptual rank)."""
    x = k - (k > idx.primary)
    word = idx.bwt_words[x >> 4]
    c = ((word >> (2 * (x & 15)).astype(np.uint32)) & np.uint32(3)).astype(
        np.int64)
    # occ of c in stored-BWT[0..x] inclusive (x is a stored index already)
    r = x >> 6
    cp = idx.occ_cp[r, c].astype(np.int64)
    m = (x & 63) + 1
    w = idx.bwt_words[(r * 4)[:, None] + np.arange(4)]
    pat = (c.astype(np.uint32) * np.uint32(0x55555555))[:, None]
    y = w ^ pat
    neq = (y | (y >> np.uint32(1))) & np.uint32(0x55555555)
    eq = neq ^ np.uint32(0x55555555)
    valid = np.clip(m[:, None] - np.arange(4) * 16, 0, 16)
    sh = np.where(valid >= 16, 0, 2 * valid).astype(np.uint32)
    mask = np.where(valid >= 16, np.uint32(0xFFFFFFFF),
                    (np.uint32(1) << sh) - np.uint32(1))
    cnt = _popcount32_np(eq & mask).sum(axis=1)
    res = idx.L2[c] + cp + cnt
    return np.where(k == idx.primary, 0, res)


def default_k0(idx: FMIndex, min_seed_len: int) -> int:
    """Table depth: ~log4 of the text so the average surviving interval is
    O(1), capped by memory (12 -> 256 MB) and by min_seed_len (exactness)."""
    text_len = max(2 * idx.l_pac, 4)
    by_genome = int(np.ceil(np.log(text_len) / np.log(4.0)))
    return max(1, min(12, min_seed_len, by_genome + 1))


def build_kmer_lut_arrays(idx: FMIndex, k0: int):
    """(K, S, P) int32 arrays of size 4^k0: backward-search interval
    (k, s) of every k0-mer (code: leftmost base = highest digit), and for
    unique k-mers (s == 1) the resolved text position P (else -1)."""
    L2 = idx.L2.astype(np.int64)
    K = (L2[:4] + 1).astype(np.int64)
    S = (L2[1:5] - L2[:4]).astype(np.int64)
    for m in range(2, k0 + 1):
        n_prev = 4 ** (m - 1)
        Kn = np.empty(4 * n_prev, np.int64)
        Sn = np.empty(4 * n_prev, np.int64)
        alive = S > 0
        kq = np.where(alive, K, 1)
        sq = np.where(alive, S, 1)
        for c in range(4):
            lo = _occ1_vec(idx, kq - 1, c)
            hi = _occ1_vec(idx, kq - 1 + sq, c)
            s2 = hi - lo
            Kn[c * n_prev:(c + 1) * n_prev] = np.where(alive, L2[c] + 1 + lo, 0)
            Sn[c * n_prev:(c + 1) * n_prev] = np.where(
                alive & (s2 > 0), s2, 0)
        K, S = Kn, Sn

    # resolve unique entries' positions: batched bwt_sa walk
    P = np.full(K.shape[0], -1, np.int64)
    u = np.flatnonzero(S == 1)
    if u.size:
        kk = K[u].copy()
        steps = np.zeros(u.size, np.int64)
        intv = idx.sa_intv
        live = (kk % intv) != 0
        while live.any():
            kk[live] = _invpsi_vec(idx, kk[live])
            steps[live] += 1
            live = live & ((kk % intv) != 0)
        P[u] = steps + idx.sa_samples[kk // intv]
    dt = np.int32 if 2 * idx.l_pac < 2**31 else np.int64
    return K.astype(dt), S.astype(dt), P.astype(dt)


@dataclasses.dataclass
class KmerLUT:
    """k-mer jump table, one (B-gatherable) row per k-mer: field0 = text
    position when s == 1 (k is then never needed: the occurrence is
    known), else the interval rank k; field1 = s."""
    k0: int
    ksp: torch.Tensor          # pos_dtype[4^k0, 2]

    @staticmethod
    def build(idx: FMIndex, k0: int | None = None,
              min_seed_len: int = 19,
              cache: str | Path | None = None, *, device) -> "KmerLUT":
        if k0 is None:
            k0 = default_k0(idx, min_seed_len)
        # index identity: a stale cache built from a DIFFERENT genome at the
        # same path would silently return wrong intervals — fingerprint by
        # l_pac, primary and a strided occ-table checksum
        stride = max(1, idx.occ_cp.shape[0] // 1024)
        fp = np.array([idx.l_pac, idx.primary,
                       int(idx.occ_cp[::stride].sum(dtype=np.uint64))],
                      dtype=np.int64)
        ksp = None
        if cache is not None:
            cache = Path(cache)
            if cache.exists():
                z = np.load(str(cache))
                if (int(z["k0"]) == k0 and z["ksp"].shape[1] == 2
                        and "fp" in z and np.array_equal(z["fp"], fp)):
                    ksp = z["ksp"]
        if ksp is None:
            K, S, P = build_kmer_lut_arrays(idx, k0)
            ksp = np.stack([np.where(S == 1, P, K), S], axis=1)
            if cache is not None:
                # written whole or not at all: --multihost processes share
                # the cache, and the reference loads it by the same name
                write_atomic(cache, lambda tmp: np.savez(
                    tmp, k0=k0, ksp=ksp, fp=fp), suffix=".npz")
        return KmerLUT(k0, torch.as_tensor(ksp).to(device))

    def to(self, device) -> "KmerLUT":
        """This table on ``device``: itself where it lies there already,
        else a copy."""
        device = torch.device(device)
        if self.ksp.device == device:
            return self
        return KmerLUT(self.k0, self.ksp.to(device))


# --------------------------------------------------------------------------
# device walk
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LutSeedConfig:
    max_smems: int = 32      # per read, after both rounds
    max_reseed: int = 3      # round-2 candidates per read
    min_seed_len: int = 19
    split_len: int = 28
    split_width: int = 10
    # dense-domain budgets: live work is compacted before the loops, and
    # lanes/reads that do not fit a budget overflow their read to a later
    # tier or the host oracle
    fm_full: int = 3         # full-width lockstep FM steps before compacting
    fm_dense: int = 32       # FM-loop survivor lanes: B*L // fm_dense
    offdiag_dense: int = 8   # off-diagonal fallback lanes: B*L // offdiag_dense
    r2_rows: int = 2         # round-2 candidate reads: B // r2_rows


def _arange(n: int, like: torch.Tensor, start: int = 0,
            dtype=torch.int32) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=dtype, device=like.device)


def _kmer_codes(seqs: torch.Tensor, lens: torch.Tensor, k0: int,
                min_len: int):
    """Per end j (lane jj = j-1): code of read[j-k0, j) with the leftmost
    base as the highest base-4 digit; valid iff the window is in-read and
    N-free.

    Ends j < min_len are excluded: they can never emit (length < min_len),
    and the only consumer of their b(j) is end j-1's maximality test,
    which is exact for any placeholder > j-1-min_len (we store b=j).
    Lanes jj < k0-1 (incomplete windows) are masked invalid."""
    B, L = seqs.shape
    base = torch.where(seqs > 3, 0, seqs).to(torch.int32)
    isn = seqs > 3
    code = torch.zeros_like(base)
    bad = torch.zeros_like(isn)
    for d in range(min(k0, L)):
        code[:, d:] += base[:, :L - d] << (2 * d)
        bad[:, d:] |= isn[:, :L - d]
    jj = _arange(L, seqs)[None, :]
    valid = (jj >= max(k0, min_len) - 1) & (jj + 1 <= lens[:, None]) & ~bad
    return code, valid


def _compact_rows(mask_b: torch.Tensor, Dr: int):
    """Compact rows with mask into Dr dense slots.

    Returns (srcrow (Dr,), rpos (B,), room (B,), dense_valid (Dr,)):
    dense row r maps to read srcrow[r]; read b (if room) maps to dense row
    rpos[b]."""
    B = mask_b.shape[0]
    rpos = torch.cumsum(mask_b.to(torch.int32), 0, dtype=torch.int32) - 1
    room = mask_b & (rpos < Dr)
    dest = torch.where(room, rpos, Dr).to(torch.int64)
    srcrow = torch.zeros(Dr + 1, dtype=torch.int32, device=mask_b.device)
    srcrow[dest] = _arange(B, mask_b)
    srcrow = srcrow[:Dr]
    n = (rpos[-1] + 1).clamp(max=Dr) if B else 0
    dense_valid = _arange(Dr, mask_b) < n
    return srcrow, rpos, room, dense_valid


def _dense_src(cs: torch.Tensor, D: int, n_all: int) -> torch.Tensor:
    """Source lane of each of D dense slots, from the inclusive count cs
    of the live lanes (clipped to a valid lane past the live count)."""
    src = torch.searchsorted(cs, _arange(D, cs, start=1))
    return src.clamp(0, n_all - 1)


# Elements of the (lanes, L) windows that the off-diagonal fallback
# compares at once: its dense set holds B * L // offdiag_dense lanes, so
# whole windows take B * L**2 // offdiag_dense elements (16 GiB of int64
# indices at 512 reads of 4096 bp); the lanes go through in slices.
WINDOW_ELEMS = 1 << 26


def _match_run(didx: DeviceIndex, revq: torch.Tensor, rows: torch.Tensor,
               shift: torch.Tensor, p: torch.Tensor, L: int) -> torch.Tensor:
    """Per lane: how many leading bases of the reversed read revq[rows],
    shifted left by ``shift``, equal the text read backward from ``p``
    (bases, not N, on both sides). Lanes in slices of WINDOW_ELEMS // L."""
    step = max(WINDOW_ELEMS // max(L, 1), 1)
    out = []
    for a in range(0, rows.shape[0], step):
        qw = shift_left(revq[rows[a:a + step]], shift[a:a + step], L, 4)
        tw = text_window_desc(didx, p[a:a + step], L).to(torch.int8)
        eq = (qw == tw) & (qw >= 0) & (qw <= 3)
        out.append(torch.cumprod(eq.to(torch.int32), dim=1).sum(
            dim=1, dtype=torch.int32))
    return torch.cat(out)


def _walk_lut(didx: DeviceIndex, lut: KmerLUT, seqs: torch.Tensor,
              lens: torch.Tensor, v: torch.Tensor, shortcut: bool,
              cfg: LutSeedConfig, codes=None, lane_min=None,
              _stop_after: str = ""):
    """Per-end walk from the k0-mer start.  seqs (B, L) int32, v (B,).

    Returns (bstart, k, s, pos) each (B, L+1) indexed by end j (entry 0
    unused; pos >= 0 only for s==1-resolved lanes), overflow (B,) — reads
    that exceeded a dense budget or whose text comparison hit the strand
    boundary — and the dense FM loop's step count.

    Structure (every phase on a compacted live set):
      LUT start -> dense-lane FM loop (only s>=2 lanes) -> batched SA walk
      for lanes that became unique mid-loop -> per-READ diagonal text
      comparison (one genome window per read finishes ALL its unique
      lanes) -> compacted per-lane fallback for off-diagonal lanes.

    ``_stop_after`` ("lut", "fm1", "fm2" or "diag") is a debugging exit for
    stage bisection (tools/time_stages.py): the walk returns after that
    phase, as ``_stopped`` says.
    """
    B, L = seqs.shape

    def cat(a):
        return torch.cat([torch.zeros((B, 1), dtype=a.dtype,
                                      device=a.device), a], dim=1)

    def _stopped(*arrs):
        # the given arrays left-padded by one column, int32 zeros for the
        # rest (int32 even where k is int64, as in the reference), no
        # overflow, step count 0
        z = torch.zeros((B, L + 1), dtype=torch.int32, device=seqs.device)
        out = [z, z, z, z]
        out[:len(arrs)] = [cat(a) for a in arrs]
        return (*out, torch.zeros((B,), dtype=torch.bool,
                                  device=seqs.device), 0)
    k0 = lut.k0
    l_pac = didx.l_pac
    j = _arange(L, seqs, start=1)[None, :]
    jj = _arange(L, seqs)[None, :]

    if codes is not None and len(codes) == 3:
        valid, f0, sl = codes          # pre-gathered LUT rows (round 2)
    else:
        code, valid = (codes if codes is not None
                       else _kmer_codes(seqs, lens, k0, cfg.min_seed_len))
        row = lut.ksp[code.clamp(0, lut.ksp.shape[0] - 1).to(torch.int64)]
        f0, sl = row[..., 0], row[..., 1]
    if lane_min is not None:
        # round-2 re-seeding emits only SMEMs covering mid (b <= mid < j),
        # so ends j <= mid never emit and never feed a needed maximality
        # test — drop their lanes entirely
        valid = valid & (j > lane_min[:, None])
    kl = torch.where(sl == 1, 0, f0)     # rank (unused when unique)
    pl = torch.where(sl == 1, f0, -1)    # position (unique entries only)
    okv = valid & (sl >= v[:, None]) & (sl > 0)
    bpos = torch.where(okv, j - k0, j)
    k = torch.where(okv, kl, 0)
    s = torch.where(okv, sl, 0)

    if shortcut:
        v1 = (v == 1)[:, None]
        sa_now = okv & (s == 1) & v1
        pos1 = torch.where(sa_now, pl, -1)
    else:
        sa_now = torch.zeros((B, L), dtype=torch.bool, device=seqs.device)
        pos1 = torch.full((B, L), -1, dtype=torch.int32, device=seqs.device)
    fm = okv & ~sa_now & (bpos > 0)
    overflow = torch.zeros((B,), dtype=torch.bool, device=seqs.device)
    sa_mid = torch.zeros((B, L), dtype=torch.bool, device=seqs.device)
    v_b = v[:, None]
    v1_b = v_b == 1
    if _stop_after == "lut":
        return _stopped(bpos, k)

    # ---- FM stage 1: a few full-width lockstep steps. Live lanes all
    # start together and stop forever on failure, so at step t the next
    # base is a STATIC diagonal slice of seqs.
    padded = torch.cat([torch.full((B, L), 4, dtype=torch.int32,
                                   device=seqs.device),
                        seqs.to(torch.int32)], dim=1)
    for t in range(max(0, min(cfg.fm_full, L - k0))):
        c = padded[:, L - k0 - t: 2 * L - k0 - t]
        can = fm & (c < 4)
        k2, s2 = backward_ext(didx, torch.where(can, k, 1),
                              torch.where(can, s, 1), torch.where(can, c, 0))
        good = can & (s2 >= v_b)
        k = torch.where(good, k2, k)
        s = torch.where(good, s2, s)
        bpos = torch.where(good, bpos - 1, bpos)
        if shortcut:
            new_sa = good & (s2 == 1) & v1_b
            sa_mid = sa_mid | new_sa
        else:
            new_sa = torch.zeros_like(good)
        fm = good & ~new_sa & (bpos > 0)
    if _stop_after == "fm1":
        return _stopped(bpos, k, s)

    # ---- FM stage 2: compact the (few) survivors and loop to completion
    BL = B * L
    D = max(BL // cfg.fm_dense, 256)
    fm_f = fm.reshape(-1)
    cs = torch.cumsum(fm_f.to(torch.int32), 0, dtype=torch.int32)
    dpos = cs - 1
    overflow |= (fm & (dpos.reshape(B, L) >= D)).any(dim=1)
    srcc = _dense_src(cs, D, BL)
    dvalid = _arange(D, seqs) < cs[-1]
    kd = k.reshape(-1)[srcc]
    sd = s.reshape(-1)[srcc]
    bd = bpos.reshape(-1)[srcc]
    b_of = torch.div(srcc, L, rounding_mode="floor")
    vd = v[b_of]
    v1d = vd == 1
    seqs_f = seqs.reshape(-1).to(torch.int32)

    def fm_body(kd, sd, bd, live, sad):
        i = bd - 1
        c = seqs_f[(b_of * L + i).clamp(0, BL - 1)]
        can = live & (c < 4) & (i >= 0)
        k2, s2 = backward_ext(didx, torch.where(can, kd, 1),
                              torch.where(can, sd, 1),
                              torch.where(can, c, 0))
        good = can & (s2 >= vd)
        kd = torch.where(good, k2, kd)
        sd = torch.where(good, s2, sd)
        bd = torch.where(good, bd - 1, bd)
        if shortcut:
            new_sa = good & (s2 == 1) & v1d
            sad = sad | new_sa
        else:
            new_sa = torch.zeros_like(good)
        live = good & ~new_sa & (bd > 0)
        return kd, sd, bd, live, sad

    # 2 FM steps per host sync: fm_body freezes dead lanes, so the double
    # step is exact
    it = 0
    st = (kd, sd, bd, dvalid & fm_f[srcc],
          torch.zeros((D,), dtype=torch.bool, device=seqs.device))
    while it < L and host_any(st[3]):
        st = fm_body(*fm_body(*st))
        it += 2
    kd, sd, bd, _, sad = st

    # write-back: one packed row gather (B*L, 4)
    packed = torch.stack([kd, sd.to(kd.dtype), bd.to(kd.dtype),
                          sad.to(kd.dtype)], dim=1)
    back = packed[dpos.clamp(0, D - 1)].reshape(B, L, 4)
    took = fm & (dpos.reshape(B, L) < D)
    k = torch.where(took, back[..., 0], k)
    s = torch.where(took, back[..., 1], s)
    bpos = torch.where(took, back[..., 2].to(torch.int32), bpos)
    if _stop_after == "fm2":
        return _stopped(bpos, k, s)
    if shortcut:
        # mid-walk unique lanes carry a rank but NOT a position; most are
        # finished by the diagonal comparison below without any SA walk
        sa_mid = sa_mid | (took & (back[..., 3] > 0))
        sa_all = sa_now | sa_mid

        # ---- per-READ diagonal text comparison: one genome window per
        # read + a cummax over the mismatch mask finishes every unique
        # lane whose occurrence lies on the read's reference diagonal.
        # The reference diagonal comes from a position-known (LUT-unique)
        # lane; reads with none resolve ONE lane by a (B,)-sized SA walk.
        first_k = torch.where(sa_now, jj, L).amin(dim=1)
        has_k = first_k < L
        oh_k = sa_now & (jj == first_k[:, None])
        diag_known = torch.where(oh_k, pos1 - bpos, 0).sum(
            dim=1, dtype=pos1.dtype)
        first_m = torch.where(sa_mid, jj, L).amin(dim=1)
        has_m = (first_m < L) & ~has_k
        oh_m = sa_mid & (jj == first_m[:, None])
        k_first = torch.where(oh_m, k, 0).sum(dim=1, dtype=k.dtype)
        b_first = torch.where(oh_m, bpos, 0).sum(dim=1, dtype=bpos.dtype)
        pos_first = sa_lookup(didx, torch.where(has_m, k_first, 1), has_m)
        ref_diag = torch.where(has_k, diag_known, pos_first - b_first)
        has_sa = has_k | has_m
        floor = torch.where(ref_diag >= l_pac, l_pac, 0)
        ceil = torch.where(ref_diag >= l_pac, 2 * l_pac, l_pac)
        diag_ok = has_sa & (ref_diag >= floor) & (ref_diag + lens <= ceil)
        tw = text_window_asc(didx, ref_diag.clamp(0, 2 * l_pac - 1), L)
        mism = (seqs != tw) | (seqs > 3) | (jj >= lens[:, None])
        lastm = torch.cummax(torch.where(mism, jj, -1), dim=1).values
        b_diag = lastm + 1
        # a lane is on-diagonal if its known position says so, or (rank-
        # only lanes) if its matched segment [bpos, j) matches the diagonal
        # — then the s==1 occurrence IS the diagonal one, exactly
        ondiag = diag_ok[:, None] & (
            (sa_now & (pos1 - bpos == ref_diag[:, None]))
            | (sa_mid & (b_diag <= bpos)))
        offdiag = sa_all & ~ondiag
        bpos = torch.where(ondiag, b_diag, bpos)
        pos1 = torch.where(ondiag, ref_diag[:, None] + b_diag, pos1)
        if _stop_after == "diag":
            return _stopped(bpos, k, s, pos1)

        # ---- off-diagonal fallback: per-lane SA resolve + window compare
        # on a dense lane set (off-diagonal lanes are a few % of B*L —
        # error-aliased k-mers with a random unique hit elsewhere)
        off_f = offdiag.reshape(-1)
        cs3 = torch.cumsum(off_f.to(torch.int32), 0, dtype=torch.int32)
        D3 = max(BL // cfg.offdiag_dense, 256)
        dpos3 = cs3 - 1
        overflow |= (offdiag & (dpos3.reshape(B, L) >= D3)).any(dim=1)
        src3c = _dense_src(cs3, D3, BL)
        live3 = _arange(D3, seqs) < cs3[-1]
        b_of3 = torch.div(src3c, L, rounding_mode="floor")
        bp3 = torch.where(live3, bpos.reshape(-1)[src3c], 0)
        p3 = torch.where(live3, pos1.reshape(-1)[src3c], 1)
        need3 = live3 & (p3 < 0)       # rank-only lanes: resolve here
        k3 = torch.where(need3, k.reshape(-1)[src3c], 1)
        p3 = torch.where(need3, sa_lookup(didx, k3, need3), p3)
        e_raw = _match_run(didx, seqs.flip(1).to(torch.int8), b_of3,
                           L - bp3, p3.clamp(1, 2 * l_pac), L)
        tcap = torch.where(p3 >= l_pac, p3 - l_pac, p3)
        e3 = torch.minimum(torch.minimum(e_raw, bp3), tcap).to(torch.int32)
        e3 = torch.where(live3, e3, 0)
        crossed3 = live3 & (tcap < bp3) & (e_raw >= tcap)
        packed3 = torch.stack([e3.to(p3.dtype), crossed3.to(p3.dtype), p3],
                              dim=1)
        back3 = packed3[dpos3.clamp(0, D3 - 1)].reshape(B, L, 3)
        took3 = offdiag & (dpos3.reshape(B, L) < D3)
        e3b = back3[..., 0].to(torch.int32)
        bpos = torch.where(took3, bpos - e3b, bpos)
        pos1 = torch.where(took3, back3[..., 2] - e3b, pos1)
        overflow |= (took3 & (back3[..., 1] > 0)).any(dim=1)

        sa_now = sa_all
        s = torch.where(sa_now, 1, s)
        k = torch.where(sa_now, -1, k)

    pos_out = pos1 if shortcut else torch.full_like(k, -1)
    return cat(bpos.to(torch.int32)), cat(k), cat(s), cat(pos_out), \
        overflow, it


def _compact_sorted(mask: torch.Tensor, arrays, max_out: int):
    """Compact masked lanes (already in emission = end-j order) into the
    first slots. Returns compacted arrays (B, max_out) in their input
    dtypes (0 past the count), count, overflow."""
    B, L = mask.shape
    pos = torch.cumsum(mask.to(torch.int32), 1, dtype=torch.int32) - 1
    count = mask.sum(dim=1, dtype=torch.int32)
    overflow = count > max_out
    sel = mask & (pos < max_out)
    dest = torch.where(sel, pos, max_out).to(torch.int64)
    outs = []
    for a in arrays:
        o = torch.zeros((B, max_out + 1), dtype=a.dtype, device=a.device)
        outs.append(o.scatter_(1, dest, a)[:, :max_out])
    n = count.clamp(max=max_out)
    slot_ok = _arange(max_out, mask)[None, :] < n[:, None]
    return [torch.where(slot_ok, o, 0) for o in outs], n, overflow


def collect_smems_lut(didx: DeviceIndex, lut: KmerLUT, seqs: torch.Tensor,
                      lens: torch.Tensor, cfg: LutSeedConfig):
    """Both seeding rounds [bwa: bwamem.c :: mem_collect_intv].

    Returns dict with (B, max_smems) tensors qb, qe, k, s, pos; n (B,);
    overflow (B,).  pos >= 0 marks s==1 SMEMs whose text position is
    already resolved (k is -1 there); downstream seed resolution uses pos
    directly and walks the SA only for s >= 2 entries.
    Row order matches oracle.Oracle.smems() (sorted by (qb, qe), stable).
    """
    seqs = seqs.to(torch.int32)
    lens = lens.to(torch.int32)
    B, L = seqs.shape
    M = cfg.max_smems
    ones = torch.ones((B,), dtype=torch.int32, device=seqs.device)
    j_idx = _arange(L, seqs, start=1)[None, :].expand(B, L)

    # ---- round 1 (the LUT rows are gathered ONCE and reused by every
    # round-2 walk)
    code, cvalid = _kmer_codes(seqs, lens, lut.k0, cfg.min_seed_len)
    lrow = lut.ksp[code.clamp(0, lut.ksp.shape[0] - 1).to(torch.int64)]
    lrows = (cvalid, lrow[..., 0], lrow[..., 1])
    b1, k1, s1, p1, ovf_w, _ = _walk_lut(didx, lut, seqs, lens, ones, True,
                                         cfg, lrows)
    m1 = _emit_mask(b1, lens, cfg.min_seed_len)
    (qb1, qe1, kk1, ss1, pp1), n1, ovf1 = _compact_sorted(
        m1, [b1[:, 1:], j_idx, k1[:, 1:], s1[:, 1:], p1[:, 1:]], M)
    # round-1 compaction is in end (j) order — the order the oracle visits
    # candidates for round-2 re-seeding

    # ---- round 2: long low-occ round-1 SMEMs re-seeded from the midpoint.
    slot_valid = _arange(M, seqs)[None, :] < n1[:, None]
    cand = slot_valid & ((qe1 - qb1) >= cfg.split_len) & \
        (ss1 <= cfg.split_width)
    cand_rank = torch.cumsum(cand.to(torch.int32), 1, dtype=torch.int32) - 1
    n_cand = cand.sum(dim=1, dtype=torch.int32)
    ovf_cand = n_cand > cfg.max_reseed

    all_qb, all_qe, all_k, all_s, all_p = ([qb1], [qe1], [kk1], [ss1], [pp1])
    all_n = [n1]
    overflow = ovf1 | ovf_cand | ovf_w
    no_v = torch.iinfo(ss1.dtype).max // 2
    for r in range(cfg.max_reseed):
        sel = cand & (cand_rank == r)
        has = sel.any(dim=1)
        mid = torch.where(has, torch.where(sel, (qb1 + qe1) >> 1, 0)
                          .amax(dim=1), 0)
        v_r = torch.where(has, torch.where(sel, ss1, 0).amax(dim=1) + 1,
                          no_v)
        # candidate #1: nearly every read; #2: ~1/4 of reads; #3+: rare —
        # later candidates run on a row-compacted sub-batch
        Dr = B if r == 0 else max(B // (cfg.r2_rows * (4 ** (r - 1))), 8)
        if r == 0:
            srcrow = _arange(B, seqs)
            rpos = srcrow
            room = torch.ones((B,), dtype=torch.bool, device=seqs.device)
            dv = torch.ones((Dr,), dtype=torch.bool, device=seqs.device)
        else:
            srcrow, rpos, room, dv = _compact_rows(has, Dr)
            overflow |= has & ~room
        srcrow = srcrow.to(torch.int64)
        j_idx_d = _arange(L, seqs, start=1)[None, :].expand(Dr, L)
        codes_r = (lrows if r == 0 else tuple(a[srcrow] for a in lrows))
        b2, k2, s2, p2, ovf2w, _ = _walk_lut(
            didx, lut, seqs[srcrow], lens[srcrow], v_r[srcrow], False, cfg,
            codes_r, lane_min=mid[srcrow])
        m2 = _emit_mask(b2, lens[srcrow], cfg.min_seed_len,
                        cover_mid=mid[srcrow])
        m2 &= dv[:, None] & has[srcrow][:, None]
        (qb2d, qe2d, kk2d, ss2d, pp2d), n2d, ovf2d = _compact_sorted(
            m2, [b2[:, 1:], j_idx_d, k2[:, 1:], s2[:, 1:], p2[:, 1:]], M)
        rp = rpos.clamp(0, Dr - 1).to(torch.int64)
        ok = has & room

        def exp(d, fill=0):
            return torch.where(ok[:, None], d[rp], fill)
        all_qb.append(exp(qb2d))
        all_qe.append(exp(qe2d))
        all_k.append(exp(kk2d))
        all_s.append(exp(ss2d))
        all_p.append(exp(pp2d, -1))
        all_n.append(torch.where(ok, n2d[rp], 0))
        overflow |= ok & (ovf2d | ovf2w)[rp]

    qb = torch.cat(all_qb, dim=1)
    qe = torch.cat(all_qe, dim=1)
    kk = torch.cat(all_k, dim=1)
    ss = torch.cat(all_s, dim=1)
    pp = torch.cat(all_p, dim=1)
    m_iota = _arange(M, seqs)[None, :]
    msk = torch.cat([m_iota < n[:, None] for n in all_n], dim=1)

    # final stable sort by (qb, qe) with round order as tiebreak — matches
    # the oracle's ordering (fits int32: L <= 2^14)
    key = torch.where(msk, qb * (L + 2) + qe, BIG)
    order = torch.argsort(key, dim=1, stable=True)[:, :M]

    def take(a):
        return a.gather(1, order)
    n_total = msk.sum(dim=1, dtype=torch.int32)
    overflow = overflow | (n_total > M)
    n_out = n_total.clamp(max=M)
    return dict(qb=take(qb), qe=take(qe), k=take(kk), s=take(ss),
                pos=take(pp), n=n_out, overflow=overflow)
