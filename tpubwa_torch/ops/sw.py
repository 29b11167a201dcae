"""Batched banded affine-gap seed extension (exact ksw_extend2 semantics).

Two implementations of one function, decided by the tensors' device:

* ``ksw_extend_ref`` — the plain PyTorch version: one DP row per loop step
  as an (N, Q+1) tensor op, the insertion chain F as an exclusive running
  max, band bookkeeping (clip, live-shrink, z-drop, early break) matching
  the scalar kernel [bwa: ksw.c :: ksw_extend2] bit for bit. The CPU path
  and the yardstick the CUDA kernel is held to.
* ``ksw_extend`` — the wrapper: CPU tensors go to ``ksw_extend_ref``; CUDA
  tensors go to the hand-written kernel in ``csrc/ksw_extend.cu`` (built
  with nvcc at first use, bound with ctypes) or raise. There is no
  fallback from the kernel to the plain version. The kernel has register
  instances (a lane keeps K columns of the DP row in registers) for
  Q <= 288 and a generic instance beyond; the query width alone decides
  (``kernel_instance``). The generic instance keeps only the live band of
  the DP rows, in a ring of ``ring_cols(Q, w)`` columns in shared memory,
  so its block's memory (``smem_bytes``) follows the band w and not Q:
  every Q launches at the options' bands (Q up to 32,768, the packed
  row's query begin, at w up to 1,023 and beyond at narrower Q). A band
  whose ring does not fit a block raises ValueError naming Q and w.

Both return (N, 6) int32: score, qle, tle, gtle, gscore, max_off, with the
bwa 5x5 matrix (match a, mismatch -b, N scores -1).
"""
from __future__ import annotations

import ctypes as C
import threading

import torch

from .cubuild import SMEM_MAX, WARPS, KernelLib, check_task_args

NEG = -(2**30)
_I32 = torch.int32

_KERNEL = KernelLib("ksw_extend")
_count_lock = threading.Lock()
# must match csrc/ksw_extend.cu: the largest register instance (columns a
# lane owns)
MAX_K = 9


def _scmat(a: int, b: int, device) -> torch.Tensor:
    m = torch.full((5, 5), -1, dtype=_I32, device=device)
    m[:4, :4] = -b
    m[range(4), range(4)] = a
    return m


def ksw_extend_ref(query, qlen, target, tlen, h0, w, end_bonus, valid, *,
                   o_del: int, e_del: int, o_ins: int, e_ins: int,
                   zdrop: int, a: int, b: int,
                   stats: dict | None = None) -> torch.Tensor:
    """Plain version, vectorised over tasks. query (N, Q), target (N, T)
    int codes; the other arguments (N,). With ``stats``, adds the number
    of DP cells the band covered to ``stats["cells"]``."""
    N, Q = query.shape
    T = target.shape[1]
    dev = query.device
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    col = lambda x: x.to(_I32)[:, None]          # noqa: E731  (N, 1)
    qlen, tlen, h0 = col(qlen), col(tlen), col(h0)
    w_in, eb = col(w), col(end_bonus)
    jj = torch.arange(Q + 1, dtype=_I32, device=dev)[None, :]
    jq = jj[:, :-1]
    scmat = _scmat(a, b, dev)
    max_sc = max(a, -b, -1)

    # band clip [bwa: the max_ins/max_del adjustment]; floor division is
    # equivalent to bwa's double math after the max(.,1) clamp
    max_ins = (torch.div(qlen * max_sc + eb - o_ins, e_ins,
                         rounding_mode="floor") + 1).clamp(min=1)
    max_del = (torch.div(qlen * max_sc + eb - o_del, e_del,
                         rounding_mode="floor") + 1).clamp(min=1)
    w = torch.minimum(torch.minimum(w_in, max_ins), max_del)

    # first row of eh (index shifted: eh_h[j] holds H(i-1, j-1))
    eh_h = torch.where(jj == 0, h0, (h0 - o_ins - e_ins * jj).clamp(min=0))
    eh_h = torch.where(jj <= qlen, eh_h, 0)
    eh_e = torch.zeros((N, Q + 1), dtype=_I32, device=dev)
    qcode = query.to(torch.int64).clamp(0, 4)
    tgt = target.to(torch.int64).clamp(0, 4)

    z = torch.zeros((N, 1), dtype=_I32, device=dev)
    i, beg, end, mx = z.clone(), z.clone(), qlen.clone(), h0.clone()
    max_i, max_j, max_ie, gscore, max_off = z - 1, z - 1, z - 1, z - 1, z
    done = (~col(valid).bool()) | (qlen <= 0) | (tlen <= 0)

    while True:
        live = ~done & (i < tlen)
        if not bool(live.any()):
            break
        beg_r = torch.maximum(beg, i - w)
        end_r = torch.minimum(torch.minimum(end, i + w + 1), qlen)
        if stats is not None:
            stats["cells"] = stats.get("cells", 0) + int(
                torch.where(live, (end_r - beg_r).clamp(min=0), 0).sum())
        tc = tgt.gather(1, i.clamp(0, T - 1).to(torch.int64))
        S = scmat[tc, qcode]                      # (N, Q)
        in_band = (jq >= beg_r) & (jq < end_r)

        Mprev = eh_h[:, :-1]                      # H(i-1, j-1) at column j
        M = torch.where(Mprev != 0, Mprev + S, 0)
        M = torch.where(in_band, M, NEG)
        h1_init = torch.where(
            beg_r == 0, (h0 - (o_del + e_del * (i + 1))).clamp(min=0), 0)
        e = torch.where(in_band, eh_e[:, :-1], NEG)
        # F chain: F(j) = max_{beg<=j'<j} (g(j') - e_ins*(j-1-j')), >= 0
        g = torch.where(in_band, (M - oe_ins).clamp(min=0), NEG)
        A = g + e_ins * jq
        excl = torch.cat([torch.full_like(A[:, :1], NEG),
                          torch.cummax(A, dim=1).values[:, :-1]], dim=1)
        f = excl - e_ins * (jq - 1)
        f = torch.where(jq > beg_r, f, 0).clamp(min=0)
        f = torch.where(in_band, f, 0)
        h = torch.maximum(torch.maximum(M, e), f)
        h = torch.where(in_band, h, NEG)
        e_next = torch.maximum((M - oe_del).clamp(min=0), e - e_del)
        e_next = torch.where(in_band, e_next, eh_e[:, :-1])

        # row max, LAST argmax [ksw tie rule: mj updates when h >= m]
        mm = torch.where(in_band, h, 0).amax(dim=1, keepdim=True) \
            .clamp(min=0)
        is_max = in_band & (h == mm) & (mm > 0)
        mj = torch.where(is_max, jq, -1).amax(dim=1, keepdim=True)

        # write-back with the index shift: eh_h[j+1] = H(i, j); eh_h[beg]=h1
        h_sh = torch.cat([z, h], dim=1)
        upd_h = (jj >= beg_r) & (jj <= end_r)
        eh_h_n = torch.where(upd_h, torch.where(jj == beg_r, h1_init, h_sh),
                             eh_h)
        upd_e = (jq >= beg_r) & (jq < end_r)
        eh_e_n = torch.cat([torch.where(upd_e, e_next, eh_e[:, :-1]),
                            eh_e[:, -1:]], dim=1)
        eh_e_n = torch.where(jj == end_r, 0, eh_e_n)

        # to-query-end score
        h_end = h.gather(1, (end_r - 1).clamp(0, Q - 1).to(torch.int64))
        h1_last = torch.where(end_r > beg_r, h_end, h1_init)
        reach = end_r == qlen
        # ksw tie rule: max_ie updates when h1 >= gscore
        new_ie = torch.where(reach & (h1_last >= gscore), i, max_ie)
        new_gs = torch.where(reach, torch.maximum(gscore, h1_last), gscore)

        # break / max update / z-drop [exact ksw_extend2 order]
        done_now = mm == 0
        better = mm > mx
        di = i - max_i
        dj = mj - max_j
        zd = torch.where(di > dj, mx - mm - (di - dj) * e_del > zdrop,
                         mx - mm - (dj - di) * e_ins > zdrop)
        done_now = done_now | (~better & (zdrop > 0) & zd)
        new_off = torch.where(better, torch.maximum(max_off, (mj - i).abs()),
                              max_off)

        # live-band shrink over UPDATED eh in [beg, end]
        alive = (eh_h_n != 0) | (eh_e_n != 0)
        scan_lo = alive & (jj >= beg_r) & (jj < end_r)
        beg2 = torch.where(scan_lo, jj, end_r).amin(dim=1, keepdim=True)
        beg2 = torch.minimum(beg2, end_r)
        scan_hi = alive & (jj >= beg2) & (jj <= end_r)
        last_live = torch.where(scan_hi, jj, beg2 - 1).amax(
            dim=1, keepdim=True).clamp(min=-1)
        end2 = torch.minimum(last_live + 2, qlen)

        # freeze finished tasks
        def upd(new, old):
            return torch.where(live, new, old)
        eh_h, eh_e = upd(eh_h_n, eh_h), upd(eh_e_n, eh_e)
        max_i, max_j = upd(torch.where(better, i, max_i), max_i), \
            upd(torch.where(better, mj, max_j), max_j)
        mx = upd(torch.where(better, mm, mx), mx)
        max_off, max_ie, gscore = upd(new_off, max_off), \
            upd(new_ie, max_ie), upd(new_gs, gscore)
        beg, end = upd(beg2, beg), upd(end2, end)
        done = done | (live & done_now)
        i = upd(i + 1, i)

    return torch.cat([mx, max_j + 1, max_i + 1, max_ie + 1, gscore,
                      max_off], dim=1).to(_I32)


def _declare(lib: C.CDLL) -> None:
    lib.ksw_extend_launch.restype = C.c_int
    lib.ksw_extend_launch.argtypes = \
        [C.c_void_p] * 9 + [C.c_int] * 12 + [C.c_void_p]


def kernel_instance(Q: int, w: int | None = None) -> int:
    """Which instance of the kernel takes queries of width Q: K, the
    columns that each of the 32 lanes keeps in registers (1..MAX_K), or 0
    for the generic ring instance when Q > 32 * MAX_K. With the band ``w``,
    raises ValueError when the generic instance's ring does not fit one
    block's shared memory (``smem_bytes``)."""
    K = max(1, -(-Q // 32))
    if K <= MAX_K:
        return K
    if w is not None:
        _check_smem(Q, w)
    return 0


def ring_cols(Q: int, w: int) -> int:
    """The generic instance's ring: a power of two of at least 2w + 2
    columns (and 32), so that the columns of a task's band, which lie in
    [i - w, i + w + 1] at row i, never share a slot while they are live.
    The block holds min(ring, Q + 1) of them: below the ring no column
    wraps."""
    need = max(2 * max(int(w), 0) + 2, 32)
    return 1 << (need - 1).bit_length()


def smem_bytes(Q: int, w: int, instance: int | None = None) -> int:
    """Dynamic shared memory of one block of the instance that takes Q (or
    of the one named) at band w: none in the register instances; in the
    generic one four int rows a task (query codes, eh_h, eh_e, the DP row)
    over min(ring_cols(Q, w), Q + 1) columns, as the launch computes it."""
    if instance is None:
        instance = kernel_instance(Q)
    if instance:
        return 0
    return WARPS * 4 * 4 * min(ring_cols(Q, w), Q + 1)


def _check_smem(Q: int, w: int):
    """Raise ValueError when the generic instance's block at (Q, w) does
    not fit the shared memory a block may take."""
    need = smem_bytes(Q, w, 0)
    if need > SMEM_MAX:
        raise ValueError(f"ksw_extend: Q={Q} at band w={w} needs {need} "
                         f"bytes of shared memory per block, over the "
                         f"{SMEM_MAX} available")


def build_lib():
    """Compile csrc/ksw_extend.cu for sm_90a into build/tpubwa_torch/.
    Returns the library path."""
    return _KERNEL.build()


def launch_kernel(args, instance: int, *, o_del: int, e_del: int,
                  o_ins: int, e_ins: int, zdrop: int, a: int, b: int,
                  w_max: int | None = None,
                  kernel: KernelLib = _KERNEL) -> torch.Tensor:
    """Launch one given instance of the kernel on checked CUDA tensors
    (``ksw_extend`` picks the instance; a measurement may name another
    that holds Q, such as the generic one, or another build of the source
    as ``kernel``). The generic instance's ring is sized for ``w_max``, a
    bound of the tasks' w (read from ``w`` when not given, one host sync).
    Counts the launch."""
    query, target = args[0], args[2]
    if target.dim() != 2:
        raise ValueError("ksw_extend: query and target must be 2-D")
    if min(e_del, e_ins) <= 0 or min(o_del, o_ins) < 0:
        # the band clip divides by the extension penalties, and the kernel's
        # live-band shrink relies on E' > 0 implying H > 0
        raise ValueError("ksw_extend: gap extension penalties must be "
                         "positive and gap open penalties not negative")
    N = check_task_args("ksw_extend", ("query", "qlen", "target", "tlen",
                                       "h0", "w", "end_bonus", "valid"), args)
    Q, T = query.shape[1], target.shape[1]
    out = torch.empty((N, 6), dtype=_I32, device=query.device)
    if N == 0:
        return out
    ring = 0
    if instance == 0:
        if w_max is None:
            w_max = int(args[5].max())
        _check_smem(Q, w_max)
        ring = ring_cols(Q, w_max)
    lib = kernel.load(_declare)
    ptrs = [x.data_ptr() for x in args] + [out.data_ptr()]
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ksw_extend_launch(*ptrs, N, Q, T, o_del, e_del, o_ins,
                                    e_ins, zdrop, a, b, instance, ring,
                                    stream)
    with _count_lock:
        ksw_extend.launches += 1
    if err != 0:
        raise RuntimeError(f"ksw_extend kernel launch failed: CUDA error "
                           f"{err}")
    return out


def ksw_extend(query, qlen, target, tlen, h0, w, end_bonus, valid, *,
               o_del: int, e_del: int, o_ins: int, e_ins: int, zdrop: int,
               a: int, b: int, w_max: int | None = None) -> torch.Tensor:
    """Banded extension of N tasks -> (N, 6) int32 (see module doc).

    CPU tensors run the plain version. CUDA tensors must be contiguous
    int32 on one device, query (N, Q), target (N, T), the rest (N,); the
    kernel instance that ``kernel_instance(Q)`` names is launched on the
    current stream and its launch error, if any, raises. ``w_max`` bounds
    the tasks' w (the caller's band; read from ``w`` when not given); a
    band too wide for the generic instance raises ValueError."""
    args = (query, qlen, target, tlen, h0, w, end_bonus, valid)
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              zdrop=zdrop, a=a, b=b)
    if query.device.type == "cpu":
        return ksw_extend_ref(*args, **kw)
    if query.dim() != 2:
        raise ValueError("ksw_extend: query and target must be 2-D")
    return launch_kernel(args, kernel_instance(query.shape[1]),
                         w_max=w_max, **kw)


ksw_extend.launches = 0
