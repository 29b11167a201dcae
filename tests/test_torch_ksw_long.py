"""Banded extension at long-read widths.

* ksw_extend_ref (the plain version the CUDA kernel is held to) equals the
  reference's vectorised ksw_extend_batch, array for array, on tasks of
  query width 4,096 and 8,192 made from a numpy seed: long queries cut
  from their targets with a long-read profile's errors, at bwa's default
  scores and at the pacbio set's;
* the generic instance's ring design (ops/sw.py::ring_cols; the row's
  live band in a ring of P columns, slot j & (P - 1), three passes a row
  over the band split in 32 contiguous lane chunks), written out here in
  Python with the lanes as loops, equals ksw_extend_ref on tasks whose
  band wraps the ring many times;
* the launch rule: every Q up to 32,768 (the packed row's query begin)
  launches at every band the options give (-w of each option set, doubled
  by the band retries), and a band whose ring passes a block's shared
  memory raises ValueError naming Q and w.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.extend.jax_extend import ksw_extend_batch
from tpubwa.opts import MemOptions as JOptions
from tpubwa_torch.extend.worker import ExtendConfig
from tpubwa_torch.ops import cubuild, sw
from tpubwa_torch.tools import long_reads, option_sets

MAX_Q = 0x8000          # the packed row's query begin: qb <= 0x7FFF


def long_tasks(Q: int, n: int, seed: int, profile: str, w: int):
    """n extension tasks of query width Q: a target of Q + 200 random
    bases and a query cut from it under ``profile``'s errors (full width,
    shorter, one with N bases), plus one random query; h0 a seed's score;
    the band w."""
    rng = np.random.default_rng(seed)
    T = Q + 200
    ta = rng.integers(0, 4, (n, T)).astype(np.int32)
    qa = np.full((n, Q), 4, np.int32)
    ql = np.zeros(n, np.int32)
    for i in range(n):
        q = long_reads.mutate(ta[i], rng, profile)[:Q]
        if i == n - 1:
            q = rng.integers(0, 4, Q)
        if i == 1:
            q = q[:Q // 2 + 17]
        qa[i, :len(q)] = q
        ql[i] = len(q)
    qa[2, rng.integers(0, ql[2], 5)] = 4
    tl = np.full(n, T, np.int32)
    h0 = rng.integers(20, 60, n).astype(np.int32)
    return (qa, ql, ta, tl, h0, np.full(n, w, np.int32),
            np.full(n, 5, np.int32), np.ones(n, np.int32))


@pytest.mark.parametrize("Q,name,profile", [(4096, None, "hifi"),
                                            (8192 + 40, "pacbio", "clr")])
def test_ref_matches_reference_batch_at_long_widths(Q, name, profile):
    opt = option_sets.options(name) if name else JOptions()
    jopt = JOptions(**{k: getattr(opt, k) for k in
                       ("a", "b", "o_del", "e_del", "o_ins", "e_ins")})
    arrs = long_tasks(Q, 4, Q + 3, profile, opt.w)
    t = [torch.tensor(a) for a in arrs]
    ref = sw.ksw_extend_ref(*t, zdrop=opt.zdrop, **option_sets.scores(opt))
    j = [jnp.asarray(a) for a in arrs]
    batch = np.stack([np.asarray(x) for x in ksw_extend_batch(
        *j[:7], j[7].astype(bool), jnp.asarray(jopt.scmat.astype(np.int32)),
        None, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop)],
        axis=1)
    np.testing.assert_array_equal(ref.numpy(), batch)
    # the planted tasks extend over most of the query, past 3,584 columns
    assert ref[0, 1] > 3584 and ref[0, 0] > 0


def ring_extend(args, P: int, o_del, e_del, o_ins, e_ins, zdrop, a, b):
    """csrc/ksw_extend.cu's generic (ring) instance, one task at a time,
    its 32 lanes as loops: the rows' live band in slots j & (P - 1) of
    arrays that start out holding garbage."""
    qa, qls, ta, tls, h0s, ws, ebs, valid = (np.asarray(x) for x in args)
    N, Q = qa.shape
    T = ta.shape[1]
    neg = -(2**30)
    out = np.zeros((N, 6), np.int64)
    mask = P - 1
    for k in range(N):
        qlen, tlen, h0 = int(qls[k]), int(tls[k]), int(h0s[k])
        max_sc = max(a, -b, -1)
        w = min(int(ws[k]), max((qlen * max_sc + int(ebs[k]) - o_ins)
                                // e_ins + 1, 1),
                max((qlen * max_sc + int(ebs[k]) - o_del) // e_del + 1, 1))
        assert P >= Q + 1 or 2 * w + 2 <= P
        R = min(P, Q + 1)
        sq, eh, ee, hr = ([-12345] * R for _ in range(4))
        beg, end, mx, max_i, max_j, max_ie = 0, qlen, h0, -1, -1, -1
        gscore, max_off, hiw = -1, 0, -1
        done = not valid[k] or qlen <= 0 or tlen <= 0
        i = 0
        while not done and i < tlen:
            bg, en = max(beg, i - w), min(end, i + w + 1, qlen)
            tc = min(max(int(ta[k, min(i, T - 1)]), 0), 4)
            for j in range(max(hiw + 1, bg), en + 1):       # entering
                eh[j & mask] = h0 if j == 0 else max(h0 - o_ins - e_ins * j,
                                                     0)
                ee[j & mask] = 0
                sq[j & mask] = min(max(int(qa[k, j]), 0), 4) if j < Q else 4
            hiw = max(hiw, en)
            kc = (max(en - bg, 0) + 31) // 32
            chunks = [range(bg + L * kc, min(bg + (L + 1) * kc, en))
                      for L in range(32)]

            def m_of(j):
                mp, qc = eh[j & mask], sq[j & mask]
                sc = -1 if tc > 3 or qc > 3 else (a if tc == qc else -b)
                return mp + sc if mp != 0 else 0
            amax = [max([max(m_of(j) - o_ins - e_ins, 0) + e_ins * j
                         for j in c], default=neg) for c in chunks]
            lm, lj = [0] * 32, [-1] * 32
            for L, c in enumerate(chunks):                  # pass 2
                carry = max(amax[:L], default=neg)
                for j in c:
                    m, e = m_of(j), ee[j & mask]
                    f = max(carry - e_ins * (j - 1), 0) if j > bg else 0
                    carry = max(carry, max(m - o_ins - e_ins, 0) + e_ins * j)
                    h = max(m, e, f)
                    hr[j & mask] = h
                    ee[j & mask] = max(m - o_del - e_del, 0, e - e_del)
                    if h > lm[L] or (h == lm[L] and h > 0):
                        lm[L], lj[L] = h, j
            mm = max(lm)
            mj = max(j if m == mm and mm > 0 else -1 for m, j in zip(lm, lj))
            h1 = max(h0 - (o_del + e_del * (i + 1)), 0) if bg == 0 else 0
            h1_last = hr[(en - 1) & mask] if en > bg else h1
            lo, hi = 2**31, -1
            for j in range(bg, en + 1):                     # pass 3
                v = h1 if j == bg else hr[(j - 1) & mask]
                eh[j & mask] = v
                e = 0 if j == en else ee[j & mask]
                ee[j & mask] = e
                if v or e:
                    lo, hi = (min(lo, j) if j < en else lo), j
            beg2 = min(lo, en)
            last = max(hi if hi >= beg2 else beg2 - 1, -1)
            if en == qlen:
                if h1_last >= gscore:
                    max_ie = i
                gscore = max(gscore, h1_last)
            done = mm == 0
            if mm > mx:
                max_off = max(max_off, abs(mj - i))
                mx, max_i, max_j = mm, i, mj
            elif zdrop > 0:
                di, dj = i - max_i, mj - max_j
                pen = (di - dj) * e_del if di > dj else (dj - di) * e_ins
                done = done or mx - mm - pen > zdrop
            beg, end = beg2, min(last + 2, qlen)
            i += 1
        out[k] = (mx, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off)
    return out


@pytest.mark.parametrize("Q,w,P,name", [(600, 7, 16, None),
                                        (300, 15, 32, "pacbio"),
                                        (400, 100, 256, None)])
def test_ring_design_matches_plain(Q, w, P, name):
    """P = 16 and 32 put 2w + 2 at the ring's size (the tightest fit);
    P = 256 < Q + 1 is the ring ops/sw.py sizes for the default band."""
    opt = option_sets.options(name) if name else JOptions()
    arrs = long_tasks(Q, 6, Q + w, "hifi", w)
    t = [torch.tensor(x) for x in arrs]
    kw = dict(option_sets.scores(opt), zdrop=opt.zdrop)
    want = sw.ksw_extend_ref(*t, **kw).numpy()
    np.testing.assert_array_equal(ring_extend(arrs, P, **kw), want)
    assert want[0, 2] > P              # the band wrapped the ring


def option_bands() -> set:
    """Every band the options give K1: each option set's -w (and bwa's
    default), doubled by the band retries up to max_band_try."""
    tries = ExtendConfig().max_band_try
    ws = {JOptions().w} | {option_sets.options(n).w
                           for n in option_sets.NAMES}
    return {w << i for w in ws for i in range(tries)}


def test_every_width_launches_at_the_options_bands():
    bands = option_bands()
    assert {100, 200, 20, 40} <= bands
    for Q in list(range(1, 4097)) + list(range(4097, MAX_Q + 1, 61)) + \
            [MAX_Q]:
        inst = sw.kernel_instance(Q)
        for w in bands:
            assert sw.kernel_instance(Q, w) == inst
            assert sw.smem_bytes(Q, w) <= cubuild.SMEM_MAX
    # the ring follows the band, not Q
    assert sw.smem_bytes(MAX_Q, 100) == sw.smem_bytes(4096, 100) == \
        cubuild.WARPS * 4 * 4 * 256
    assert sw.smem_bytes(300, 100) == cubuild.WARPS * 4 * 4 * 256
    assert sw.smem_bytes(200, 100) == 0          # a register instance


def test_ring_bound_is_stated():
    """The widest band that launches at any Q is 1,023 (a ring of 2,048
    columns); below Q = 3,632 the block holds the whole row, at any band."""
    assert sw.ring_cols(MAX_Q, 1023) == 2048
    assert sw.kernel_instance(MAX_Q, 1023) == 0
    with pytest.raises(ValueError, match=r"Q=32768 at band w=1024"):
        sw.kernel_instance(MAX_Q, 1024)
    assert sw.kernel_instance(3631, 10**6) == 0
    with pytest.raises(ValueError, match="shared memory"):
        sw.kernel_instance(3632, 10**6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Q,w", [(4096, 100), (12288, 200), (MAX_Q, 100),
                                 (5000, 1023)])
def test_kernel_matches_plain_at_long_widths(cuda_device, Q, w):
    t = [torch.tensor(a).to(cuda_device)
         for a in long_tasks(Q, 8, Q + w, "hifi", w)]
    before = sw.ksw_extend.launches
    got = sw.ksw_extend(*t, zdrop=100, w_max=w, **option_sets.scores(
        JOptions()))
    assert sw.ksw_extend.launches == before + 1
    want = sw.ksw_extend_ref(*t, zdrop=100, **option_sets.scores(JOptions()))
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
