"""K2 (the mate rescue's local alignment) at the windows of mate-pair
libraries, T up to 40,960.

* the launch rule: every Q up to 320 (the PE path's widest mates, and a
  lane's slack) launches at every T up to 40,960 in both passes; the
  block's shared memory depends on Q alone and the row maxima of the
  forward pass take a device-memory workspace of T ints a task; Q past the
  generic instance's shared memory and T past MAX_T raise ValueError
  naming Q and T;
* the widest rescue window bwa's pestat (native/pe.cpp ``pestat_core``,
  mirrored by tools/mate_pairs.py::pestat) can give at ``max_ins`` =
  10000 is within that bound: high <= p75 + 3 IQR <= 39,997, low >= 1;
* ksw_local_ref (the plain version the CUDA kernel is held to) equals the
  reference's ksw_local_batch in all five outputs at T = 18,688 (the
  probe's 2x150 mate-pair window) and 40,960, on tasks with two planted
  hits, the second outside [te - qlen, te + qlen], so that score2 and te2
  are not trivial;
* the kernel's row-maxima layout and replay (lane i & 31 gathers row i's
  maximum, the warp stores 32 rows at once to the workspace, the replay
  reads them back 32 at a time and skips a chunk with no row at minsc),
  written out here in numpy with the lanes as an array axis, equals
  ksw_local_ref.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.extend.jax_extend import ksw_local_batch
from tpubwa.pair.rescue import _scmat_tuple
from tpubwa_torch.ops import cubuild, sw_local
from tpubwa_torch.opts import MemOptions
from tpubwa_torch.tools import mate_pairs

OPT = MemOptions()
KW = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
          e_ins=OPT.e_ins, a=OPT.a, b=OPT.b)
MINSC = OPT.min_seed_len * OPT.a
WIDEST_T = 40960        # past pestat's widest window for mates to 320 bp
NEG = -(1 << 30)        # the kernel's kNeg


@pytest.mark.parametrize("want_sub", [True, False])
def test_every_width_launches(want_sub):
    Ts = sorted(set(range(256, WIDEST_T + 1, 256)) | {1, 31, 33, 14337,
                                                      40959})
    for Q in range(1, 321):
        smem = sw_local.smem_bytes(Q)
        assert smem <= cubuild.SMEM_MAX
        assert smem == (0 if Q <= 32 * sw_local.MAX_K
                        else cubuild.WARPS * 4 * 4 * 32 * (-(-Q // 32)))
        for T in Ts:
            sw_local.check_launch(Q, T)
            sw_local.check_launch(Q, T, 0)
            assert sw_local.workspace_bytes(3, T, want_sub) == \
                (12 * T if want_sub else 0)


def test_launch_bound_is_stated():
    """Past the bound: the generic instance's four query rows over a
    block's shared memory (Q > 3,616), or T > MAX_T (int32 row counts)."""
    sw_local.check_launch(3616, 256)
    sw_local.check_launch(150, sw_local.MAX_T)
    with pytest.raises(ValueError, match="Q=3617, T=256"):
        sw_local.check_launch(3617, 256)
    with pytest.raises(ValueError, match=f"Q=150, T={sw_local.MAX_T + 1}"):
        sw_local.check_launch(150, sw_local.MAX_T + 1)
    with pytest.raises(ValueError, match="Q=300"):
        sw_local.check_launch(300, sw_local.MAX_T + 1, 0)


def test_widest_pestat_window_is_within_the_bound():
    """Half the samples at 1 bp and half at max_ins: p25 = 1, p75 =
    max_ins, so high = p75 + 3 IQR = 39,997 and low = 1, the most the
    native arithmetic allows (avg + 4 sd <= 10,000 + 4 x 4,999.5 is
    less); 500 random histograms over [1, max_ins] stay under it."""
    M = OPT.max_ins
    hist = np.zeros((4, M + 1), np.int64)
    hist[2, 1] = hist[2, M] = 50
    r = mate_pairs.pestat(hist, M)[2]
    assert (r["failed"], r["low"], r["high"]) == (0, 1, 4 * M - 3)
    for l_ms in (150, 300, 320):
        T = mate_pairs.rescue_T([r], l_ms)
        assert T == -(-(4 * M - 4 + l_ms) // 256) * 256 <= WIDEST_T
        sw_local.check_launch(l_ms, T)
    rng = np.random.default_rng(17)
    for _ in range(500):
        h = np.zeros((4, M + 1), np.int64)
        k = int(rng.integers(10, 60))
        np.add.at(h[1], rng.integers(1, M + 1, k), 1)
        r = mate_pairs.pestat(h, M)[1]
        assert r["low"] >= 1 and r["high"] <= 4 * M - 3


def wide_tasks(n: int, Q: int, T: int, seed: int):
    """n tasks of query width Q and target width T from a numpy seed: the
    query planted near the target's end with 2 errors (the best hit) and
    again far before it with 6 (a run outside [te - qlen, te + qlen]),
    on every task but the last two: a random pair, and an invalid row."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 4, (n, Q)).astype(np.int32)
    ts = rng.integers(0, 4, (n, T)).astype(np.int32)
    qlen = np.full(n, Q, np.int32)
    tlen = np.full(n, T, np.int32)
    tlen[1] = T - 77                        # a part chunk of rows at the end
    for i in range(n - 2):
        for off, nerr in ((int(rng.integers(T - 3 * Q, T - Q - 77)), 2),
                          (int(rng.integers(Q, T // 2)), 6)):
            hit = qs[i].copy()
            pos = rng.choice(Q, nerr, replace=False)
            hit[pos] = (hit[pos] + 1) % 4
            ts[i, off:off + Q] = hit
    valid = np.ones(n, np.int32)
    valid[-1] = 0
    minsc = np.full(n, MINSC, np.int32)
    return qs, qlen, ts, tlen, minsc, valid


def plain(args, want_sub=True):
    t = [torch.tensor(a) for a in args]
    return sw_local.ksw_local_ref(*t, want_sub=want_sub, **KW).numpy()


@pytest.mark.parametrize("Q,T", [(150, 18688), (150, 40960), (300, 40960)])
def test_ref_matches_reference_batch_at_mate_pair_windows(Q, T):
    args = wide_tasks(5, Q, T, Q + T)
    qs, qlen, ts, tlen, minsc, valid = args
    got = plain(args)
    want = np.stack([np.asarray(x) for x in ksw_local_batch(
        jnp.asarray(qs), jnp.asarray(qlen), jnp.asarray(ts),
        jnp.asarray(tlen), jnp.asarray(valid != 0), jnp.asarray(minsc),
        _scmat_tuple(OPT.a, OPT.b), OPT.o_del, OPT.e_del, OPT.o_ins,
        OPT.e_ins, True)], axis=1)
    np.testing.assert_array_equal(got, want)
    # the planted hits: the best near the end, a second run far before it
    live = got[:3]
    assert (live[:, 0] >= Q - 12).all() and (live[:, 1] > T - 3 * Q).all()
    assert (live[:, 3] >= MINSC).all()
    assert (np.abs(live[:, 4] - live[:, 1]) > qlen[:3]).all()
    assert list(got[-1]) == [0, -1, -1, 0, -1]


def row_maxima(qs, qlen, ts, tlen, valid):
    """(N, T) row maxima and the forward outputs score, te, qe of the
    DP, one target row a step over every task, in numpy; rows past a
    task's tlen are 0."""
    N, Q = qs.shape
    T = ts.shape[1]
    oe_del, oe_ins = OPT.o_del + OPT.e_del, OPT.o_ins + OPT.e_ins
    e_del, e_ins = OPT.e_del, OPT.e_ins
    jj = np.arange(Q)[None, :]
    inq = jj < qlen[:, None]
    H = np.zeros((N, Q), np.int64)
    E = np.zeros((N, Q), np.int64)
    rmax = np.zeros((N, T), np.int64)
    best = np.zeros(N, np.int64)
    te = np.full(N, -1)
    qe = np.full(N, -1)
    for i in range(T):
        live = (valid != 0) & (i < tlen)
        tc = ts[:, i:i + 1]
        S = np.where((tc > 3) | (qs > 3), -1, np.where(tc == qs, OPT.a,
                                                       -OPT.b))
        hd = np.concatenate([np.zeros((N, 1), np.int64), H[:, :-1]], 1)
        G = np.maximum(np.maximum(hd + S, 0), E)
        A = G - oe_ins + e_ins * jj
        carry = np.concatenate([np.full((N, 1), NEG),
                                np.maximum.accumulate(A, 1)[:, :-1]], 1)
        Hn = np.where(inq, np.maximum(G, carry - e_ins * (jj - 1)), 0)
        En = np.where(inq, np.maximum(np.maximum(E - e_del, Hn - oe_del), 0),
                      0)
        mm = Hn.max(1)
        first = np.where(Hn == mm[:, None], jj, Q).min(1)
        better = live & (mm > best)
        best = np.where(better, mm, best)
        te = np.where(better, i, te)
        qe = np.where(better, first, qe)
        H = np.where(live[:, None], Hn, H)
        E = np.where(live[:, None], En, E)
        rmax[:, i] = np.where(live, mm, 0)
    return rmax, best, te, qe


def layout_and_replay(rmax, tn, te, qlen, minsc):
    """The kernel's want_sub tail for one task, lanes as an axis: the row
    maxima gathered in a register of lane i & 31 and stored 32 rows at a
    time into the workspace (the part chunk after the loop), then the
    replay over chunks of 32 read back by lane, skipping a chunk with no
    row at minsc. Returns (score2, te2)."""
    lanes = np.arange(32)
    ws = np.full(max(tn, 1), -7)           # what the allocator left there
    rm = np.zeros(32, np.int64)
    for i in range(tn):
        rm[i & 31] = rmax[i]               # lane == (i & 31) takes mm
        if (i & 31) == 31:
            ws[i - 31 + lanes] = rm        # one coalesced store
    base = tn & ~31
    tail = base + lanes < tn
    ws[(base + lanes)[tail]] = rm[tail]
    lo, hi = te - qlen, te + qlen
    bf, bs, score2, te2 = 0, -2, 0, -1
    for c in range(0, tn, 32):
        v = np.where(c + lanes < tn, ws[np.minimum(c + lanes, tn - 1)], NEG)
        if not (v >= minsc).any():
            continue
        for r in range(min(32, tn - c)):
            im, i = int(v[r]), c + r
            if im < minsc:
                continue
            if bs + 1 != i:
                if bs >= 0 and (bs < lo or bs > hi) and bf > score2:
                    score2, te2 = bf, bs
                bf, bs = im, i
            elif im > bf:
                bf, bs = im, i
    if bs >= 0 and (bs < lo or bs > hi) and bf > score2:
        score2, te2 = bf, bs
    return score2, te2


@pytest.mark.parametrize("minsc", [0, MINSC, 40])
def test_workspace_layout_and_replay_match_plain(minsc):
    """Tasks of 1 to 700 rows (whole and part chunks of 32), two planted
    runs, repeats that split runs, an empty and an invalid row."""
    rng = np.random.default_rng(1700 + minsc)
    n, Q, T = 24, 90, 700
    args = list(wide_tasks(n, Q, T, minsc))
    qs, qlen, ts, tlen, _, valid = args
    tlen[:] = rng.integers(1, T + 1, n)
    tlen[2], tlen[3], tlen[4], qlen[5] = 32, 33, 1, 0
    for i in range(6, 12):                  # repeats of one short motif
        m = rng.integers(0, 4, 25)
        qs[i, :25] = m
        for off in range(40, T - 25, 90):
            ts[i, off:off + 25] = m
    args[4] = np.full(n, minsc, np.int32)
    want = plain(args)
    rmax, best, te, qe = row_maxima(qs, qlen, ts, tlen, valid)
    np.testing.assert_array_equal(np.stack([best, te, qe], 1), want[:, :3])
    for k in range(n):
        tn = int(tlen[k]) if valid[k] and qlen[k] > 0 else 0
        got = layout_and_replay(rmax[k], tn, int(te[k]), int(qlen[k]),
                                minsc)
        assert got == tuple(want[k, 3:]), k
    assert (want[:, 3] > 0).sum() >= 2       # score2 not trivial
