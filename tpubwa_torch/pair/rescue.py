"""Device mate-rescue: batched ksw_align + rescue-task orchestration.

Replacement for the per-pair mate-rescue SW
[bwa: bwamem_pair.c :: mem_matesw; ksw.c :: ksw_align2 with
KSW_XSTART|KSW_XSUBO].

Design: the native PE finisher extracts every rescue window a batch COULD
run (a superset — the per-call skip logic only prunes), all windows run as
one batched device local alignment (forward pass for score/end/subopt,
reverse pass on the (qe, te) prefixes for the start), and the scalar
pairing logic replays with the precomputed results injected. Identical
semantics to the sequential scalar loop because window coordinates depend
only on the pre-rescue region lists and the insert-size stats, never on
earlier rescues.

The local alignment is ``ops.sw_local.ksw_local``: the tensors' device
decides between the CUDA kernel and its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.sw_local import ksw_local
from ..ops.window import shift_left, text_window_asc
from ..utils.profiling import synced

_I32 = torch.int32


def _rev_prefix(rows: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """out[r, j] = rows[r, end[r] - j] (j <= end), else 4 — the reversed
    prefix used by ksw_align's start-extraction pass."""
    W = rows.shape[1]
    return shift_left(rows.flip(1), W - 1 - end, W, 4)


def ksw_align_batch(query, qlen, target, tlen, minsc, valid,
                    o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                    e_ins: int = 1, a_sc: int = 1,
                    b_sc: int = 4) -> torch.Tensor:
    """Batched [bwa: ksw.c :: ksw_align2(XSTART|XSUBO)].

    query: (N, Q) int codes; target: (N, T); qlen/tlen/minsc/valid: (N,).
    a_sc / b_sc are the match score and mismatch penalty.
    Returns (N, 7) int32: score, tb, te, qb, qe, score2, te2 (tb/qb = -1
    when score < minsc, matching the scalar no-start-extraction path).
    """
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins, a=a_sc,
              b=b_sc)
    query = query.to(_I32).contiguous()
    target = target.to(_I32).contiguous()
    qlen, tlen, minsc = qlen.to(_I32), tlen.to(_I32), minsc.to(_I32)
    valid = valid.to(_I32)
    fwd = ksw_local(query, qlen, target, tlen, minsc, valid, want_sub=True, **kw)
    score, te, qe, score2, te2 = fwd.unbind(1)

    need = (valid != 0) & (score >= minsc) & (te >= 0)
    rq = _rev_prefix(query, torch.where(need, qe, 0))
    rt = _rev_prefix(target, torch.where(need, te, 0))
    rev = ksw_local(rq, qe + 1, rt, te + 1,
                    torch.full_like(minsc, 0x10000), need.to(_I32),
                    want_sub=False, **kw)
    tb = torch.where(need, te - rev[:, 1], -1)
    qb = torch.where(need, qe - rev[:, 2], -1)
    return torch.stack([score, tb, te, qb, qe, score2, te2], dim=1)


def rescue_windows(didx, seqs, lens, mate_row, is_rev, rb, wlen, T: int):
    """Assemble the rescue tasks' inputs on the device: the query is the
    mate read (reverse-complemented when the orientation demands it, codes
    above 3 becoming 4), the target the predicted text window; both are
    filled with 4 beyond their lengths. Returns (q (N, L), qlen, t (N, T))
    int32."""
    seqs = seqs.to(_I32)
    L = seqs.shape[1]
    mate_row = mate_row.to(torch.int64)
    q0 = seqs[mate_row]
    la = lens.to(_I32)[mate_row]
    rq = shift_left(q0.flip(1), L - la, L, 4)
    rq = torch.where(rq <= 3, 3 - rq, 4)
    q = torch.where(is_rev[:, None] != 0, rq, q0)
    jq = torch.arange(L, dtype=_I32, device=seqs.device)[None, :]
    q = torch.where(jq < la[:, None], q, 4)
    t = text_window_asc(didx, rb, T)
    jt = torch.arange(T, dtype=_I32, device=seqs.device)[None, :]
    t = torch.where(jt < wlen[:, None], t, 4)
    return q, la, t


def _rescue_batch_device(didx, seqs, lens, mate_row, is_rev, rb, wlen,
                         T: int, minsc: int, kw: dict) -> torch.Tensor:
    """Assemble + run all rescue windows of a batch on device.

    seqs: (B, L) the batch reads; mate_row/is_rev/rb/wlen: (N,) task
    tensors from native mem_rescue_tasks. Returns (N, 7) int32 ksw_align
    rows."""
    q, la, t = rescue_windows(didx, seqs, lens, mate_row, is_rev, rb, wlen,
                              T)
    n = q.shape[0]
    return ksw_align_batch(
        q, la, t, wlen, torch.full((n,), minsc, dtype=_I32, device=q.device),
        torch.ones(n, dtype=_I32, device=q.device), **kw)


def task_arrays(tasks: np.ndarray, id0: int):
    """Host-side decoding of native task rows (n, 8) int64 (pair, end, j,
    dir, is_rev, rb, re, rid): returns (mate_row, is_rev, rb, wlen, T),
    with T the window width rounded up to a multiple of 256."""
    p_local = (tasks[:, 0] - id0).astype(np.int64)
    mate_row = (2 * p_local + (1 - tasks[:, 1])).astype(np.int32)
    is_rev = tasks[:, 4].astype(np.int32)
    rb = tasks[:, 5]
    wlen = (tasks[:, 6] - tasks[:, 5]).astype(np.int32)
    T = max(256, int(-(-int(wlen.max()) // 256)) * 256)
    return mate_row, is_rev, rb, wlen, T


def dispatch_rescue_tasks(didx, batch_seqs, batch_lens, tasks, id0, opt):
    """Enqueue the rescue device call WITHOUT blocking. Returns the (n, 7)
    device tensor, or None when there are no tasks — download with
    ``.cpu().numpy()`` when the result is actually needed (the PE stream
    overlaps this with the next batch's worker1). The device is the
    index's.

    The reference pads the task count to a power of two so that its
    compiler sees few shapes; a CUDA kernel compiles once, so here the
    tasks go as they are and the result has exactly n rows."""
    if len(tasks) == 0:
        return None
    dev = didx.pac_rows.device
    mate_row, is_rev, rb, wlen, T = task_arrays(tasks, id0)

    def up(a, dtype=_I32):
        return torch.as_tensor(a).to(dev).to(dtype)
    kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins, a_sc=opt.a, b_sc=opt.b)
    with synced(6):     # six uploads from pageable host memory
        args = (torch.as_tensor(batch_seqs).to(dev),
                torch.as_tensor(batch_lens).to(dev), up(mate_row),
                up(is_rev), up(rb.astype(np.int64), didx.pos_dtype),
                up(wlen))
    return _rescue_batch_device(didx, *args, T,
                                int(opt.min_seed_len * opt.a), kw)


def run_rescue_tasks(didx, batch_seqs, batch_lens, tasks, id0, opt):
    """Blocking form: task rows (n, 8) int64 (pair, end, j, dir, is_rev,
    rb, re, rid) -> (n, 7) int32 ksw_align results via one device call."""
    dev = dispatch_rescue_tasks(didx, batch_seqs, batch_lens, tasks, id0,
                                opt)
    if dev is None:
        return np.zeros((0, 7), np.int32)
    return dev.cpu().numpy().astype(np.int32)
