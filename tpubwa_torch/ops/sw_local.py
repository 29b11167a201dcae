"""Batched unbanded local Smith-Waterman (the forward pass of ksw_align).

Exact ``native/ksw.cpp :: local_fwd`` semantics [bwa: ksw.c :: ksw_u8 with
KSW_XSUBO], the alignment that mate rescue runs over every predicted
window [bwa: bwamem_pair.c :: mem_matesw]. Two implementations of one
function, decided by the tensors' device:

* ``ksw_local_ref`` — the plain PyTorch version: one target row per loop
  step as (N, Q) tensor ops, the insertion chain F as an exclusive running
  max over G = max(M, E), then the sub-optimal run tracking as a second
  loop over the stored row maxima. The CPU path and the yardstick the CUDA
  kernel is held to.
* ``ksw_local`` — the wrapper: CPU tensors go to ``ksw_local_ref``; CUDA
  tensors go to the hand-written kernel in ``csrc/ksw_local.cu`` (built
  with nvcc at first use, bound with ctypes) or raise. There is no
  fallback from the kernel to the plain version. The kernel has register
  instances (a lane keeps K columns of the H and E rows in registers) for
  Q <= 256 and a generic shared-memory instance beyond; the query width
  alone decides (``kernel_instance``).

Both return (N, 5) int32: score, te, qe, score2, te2 (0-based ends, -1
when nothing scored). ``want_sub=False`` skips the run tracking and
reports score2 = 0, te2 = -1 (the start-extraction pass needs neither).
"""
from __future__ import annotations

import ctypes as C
import threading

import torch

from .cubuild import SMEM_MAX as _SMEM_MAX
from .cubuild import WARPS as _WARPS
from .cubuild import KernelLib, check_task_args
from .sw import NEG, _scmat

_I32 = torch.int32
_KERNEL = KernelLib("ksw_local")
_count_lock = threading.Lock()
# must match csrc/ksw_local.cu: the largest register instance (columns a
# lane owns)
MAX_K = 8


def ksw_local_ref(query, qlen, target, tlen, minsc, valid, *,
                  o_del: int, e_del: int, o_ins: int, e_ins: int,
                  a: int, b: int, want_sub: bool = True) -> torch.Tensor:
    """Plain version, vectorised over tasks. query (N, Q), target (N, T)
    int codes; qlen, tlen, minsc, valid (N,)."""
    N, Q = query.shape
    T = target.shape[1]
    dev = query.device
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    col = lambda x: x.to(_I32)[:, None]          # noqa: E731  (N, 1)
    qlen, tlen, minsc = col(qlen), col(tlen), col(minsc)
    valid = valid[:, None] != 0
    z = torch.zeros((N, 1), dtype=_I32, device=dev)
    best, te, qe = z.clone(), z - 1, z - 1
    # rows any task still needs: every later row is dead for all of them
    rows = int(torch.where(valid, tlen, 0).amax().clamp(0, T)) \
        if N and Q and T else 0
    jj = torch.arange(Q, dtype=_I32, device=dev)[None, :]
    in_q = jj < qlen
    scmat = _scmat(a, b, dev)
    qcode = query.to(torch.int64).clamp(0, 4)
    tgt = target.to(torch.int64).clamp(0, 4)
    H = torch.zeros((N, Q), dtype=_I32, device=dev)
    E = torch.zeros((N, Q), dtype=_I32, device=dev)
    imaxs = torch.zeros((N, rows), dtype=_I32, device=dev)
    neg = torch.full((N, 1), NEG, dtype=_I32, device=dev)

    for i in range(rows):
        live = valid & (i < tlen)
        S = scmat[tgt[:, i:i + 1], qcode]                      # (N, Q)
        M = (torch.cat([z, H[:, :-1]], dim=1) + S).clamp(min=0)
        G = torch.maximum(M, E)
        # F(j) = max(0, max_{k<j} (G(k) - oe_ins - e_ins*(j-1-k)))
        A = (G - oe_ins) + e_ins * jj
        excl = torch.cat([neg, torch.cummax(A, dim=1).values[:, :-1]], dim=1)
        F = (excl - e_ins * (jj - 1)).clamp(min=0)
        Hn = torch.where(in_q, torch.maximum(G, F), 0)
        En = torch.where(in_q, torch.maximum(E - e_del, Hn - oe_del)
                         .clamp(min=0), 0)
        imax = Hn.amax(dim=1, keepdim=True)
        # FIRST column that reaches the row max; -1 when the row is all 0
        imj = torch.where((Hn == imax) & (imax > 0), jj, Q + 1) \
            .amin(dim=1, keepdim=True)
        imj = torch.where(imax > 0, imj, -1)
        # strictly greater: the earliest row of the global max wins
        better = live & (imax > best)
        best = torch.where(better, imax, best)
        te = torch.where(better, i, te)
        qe = torch.where(better, imj, qe)
        H = torch.where(live, Hn, H)
        E = torch.where(live, En, E)
        imaxs[:, i:i + 1] = torch.where(live, imax, 0)

    score2, te2 = z.clone(), z - 1
    if want_sub:
        # run tracking: a run's position is the row of its last max UPDATE
        # and adjacency is tested against that row, so non-improving rows
        # can split runs; a finished run counts only outside the best
        # hit's neighbourhood, which needs the final te — a second pass
        lo, hi = te - qlen, te + qlen
        bf, bs = z.clone(), z - 2

        def close(fin, bf, bs, score2, te2):
            upd = fin & ((bs < lo) | (bs > hi)) & (bf > score2)
            return torch.where(upd, bf, score2), torch.where(upd, bs, te2)

        for i in range(rows):
            im = imaxs[:, i:i + 1]
            elig = valid & (i < tlen) & (im >= minsc)
            new_run = elig & (bs + 1 != i)
            score2, te2 = close(new_run & (bs >= 0), bf, bs, score2, te2)
            take = new_run | (elig & (im > bf))
            bf = torch.where(take, im, bf)
            bs = torch.where(take, i, bs)
        score2, te2 = close(bs >= 0, bf, bs, score2, te2)
    return torch.cat([best, te, qe, score2, te2], dim=1).to(_I32)


def _declare(lib: C.CDLL) -> None:
    lib.ksw_local_launch.restype = C.c_int
    lib.ksw_local_launch.argtypes = \
        [C.c_void_p] * 7 + [C.c_int] * 11 + [C.c_void_p]


def build_lib():
    """Compile csrc/ksw_local.cu for sm_90a into build/tpubwa_torch/.
    Returns the library path."""
    return _KERNEL.build()


def kernel_instance(Q: int) -> int:
    """Which instance of the kernel takes queries of width Q: K, the
    columns that each of the 32 lanes keeps in registers (1..MAX_K), or 0
    for the generic shared-memory instance when Q > 32 * MAX_K."""
    K = max(1, -(-Q // 32))
    return K if K <= MAX_K else 0


def smem_bytes(Q: int, T: int, want_sub: bool, instance: int | None = None) \
        -> int:
    """Dynamic shared memory of one block of the kernel instance that takes
    Q (or of the one named): with want_sub the T stored row maxima of each
    task; in the generic instance also four rows over the query (codes, H,
    E, G; padded to whole 32-lane slots)."""
    if instance is None:
        instance = kernel_instance(Q)
    rows = 0 if instance else 4 * 32 * ((Q + 31) // 32)
    return _WARPS * 4 * (rows + (T if want_sub else 0))


def launch_kernel(args, instance: int, *, o_del: int, e_del: int,
                  o_ins: int, e_ins: int, a: int, b: int,
                  want_sub: bool = True,
                  kernel: KernelLib = _KERNEL) -> torch.Tensor:
    """Launch one given instance of the kernel on checked CUDA tensors
    (``ksw_local`` picks the instance; a measurement may name another that
    holds Q, such as the generic one, or another build of the source as
    ``kernel``). Counts the launch."""
    query, target = args[0], args[2]
    if query.dim() != 2 or target.dim() != 2:
        raise ValueError("ksw_local: query and target must be 2-D")
    Q, T = query.shape[1], target.shape[1]
    need = smem_bytes(Q, T, want_sub, instance)
    if need > _SMEM_MAX:
        raise ValueError(f"ksw_local: Q={Q}, T={T} needs {need} bytes of "
                         f"shared memory per block, over the {_SMEM_MAX} "
                         f"available")
    N = check_task_args("ksw_local", ("query", "qlen", "target", "tlen",
                                      "minsc", "valid"), args)
    out = torch.empty((N, 5), dtype=_I32, device=query.device)
    if N == 0:
        return out
    lib = kernel.load(_declare)
    ptrs = [x.data_ptr() for x in args] + [out.data_ptr()]
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ksw_local_launch(*ptrs, N, Q, T, o_del, e_del, o_ins,
                                   e_ins, a, b, int(bool(want_sub)),
                                   instance, stream)
    with _count_lock:
        ksw_local.launches += 1
    if err != 0:
        raise RuntimeError(f"ksw_local kernel launch failed: CUDA error "
                           f"{err}")
    return out


def ksw_local(query, qlen, target, tlen, minsc, valid, *, o_del: int,
              e_del: int, o_ins: int, e_ins: int, a: int, b: int,
              want_sub: bool = True) -> torch.Tensor:
    """Local alignment of N tasks -> (N, 5) int32 (see module doc).

    CPU tensors run the plain version. CUDA tensors must be contiguous
    int32 on one device, query (N, Q), target (N, T), the rest (N,); the
    kernel instance that ``kernel_instance(Q)`` names is launched on the
    current stream and its launch error, if any, raises. Shapes whose rows
    do not fit one block's shared memory raise ValueError."""
    args = (query, qlen, target, tlen, minsc, valid)
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins, a=a, b=b,
              want_sub=want_sub)
    if query.device.type == "cpu":
        return ksw_local_ref(*args, **kw)
    if query.dim() != 2:
        raise ValueError("ksw_local: query and target must be 2-D")
    return launch_kernel(args, kernel_instance(query.shape[1]), **kw)


ksw_local.launches = 0
