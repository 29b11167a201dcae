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
  alone decides (``kernel_instance``). With ``want_sub`` the kernel keeps
  every task's row maxima in a workspace of (N, T) int32 in device memory
  that the wrapper allocates (``workspace_bytes``), not in shared memory,
  so a block's shared memory (``smem_bytes``) depends on Q alone and any
  rescue window launches: pestat's widest at ``max_ins`` is about 40 kbp.
  Only a query too wide for the generic instance's shared memory, or T past
  ``MAX_T``, raises ValueError (``check_launch``).

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
# the widest target the kernel takes: it counts rows in int32, and row
# indices plus a query length (te + qlen, i + 31) must not wrap
MAX_T = 1 << 30


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
    # a task's rows are live below its tlen and dead from there on, so a
    # dead row's H and E need not be kept: nothing it computes is used
    live = valid & (torch.arange(rows, device=dev)[None, :] < tlen)
    aoff = e_ins * jj - oe_ins               # A(j) - G(j)
    foff = e_ins * (1 - jj)                  # F(j) - max_{k<j} A(k)
    scmat = _scmat(a, b, dev)
    qcode = query.to(torch.int64).clamp(0, 4)
    tgt = target.to(torch.int64).clamp(0, 4)
    H = torch.zeros((N, Q), dtype=_I32, device=dev)
    E = torch.zeros((N, Q), dtype=_I32, device=dev)
    imaxs = torch.zeros((N, rows), dtype=_I32, device=dev)
    neg = torch.full((N, 1), NEG, dtype=_I32, device=dev)

    for i in range(rows):
        S = scmat[tgt[:, i:i + 1], qcode]                      # (N, Q)
        M = (torch.cat([z, H[:, :-1]], dim=1) + S).clamp_(min=0)
        G = torch.maximum(M, E)
        # F(j) = max(0, max_{k<j} (G(k) - oe_ins - e_ins*(j-1-k)))
        excl = torch.cat([neg, torch.cummax(G + aoff, dim=1).values[:, :-1]],
                         dim=1)
        H = torch.where(in_q, torch.maximum(G, (excl + foff).clamp_(min=0)),
                        0)
        # E stays 0 past qlen: H is 0 there
        E = torch.maximum(E - e_del, H - oe_del).clamp_(min=0)
        imax = H.amax(dim=1, keepdim=True)
        # strictly greater: the earliest row of the global max wins, at
        # the FIRST column that reaches it (imax > best >= 0 there)
        better = live[:, i:i + 1] & (imax > best)
        best = torch.where(better, imax, best)
        te = torch.where(better, i, te)
        qe = torch.where(better, torch.where(H == imax, jj, Q)
                         .amin(dim=1, keepdim=True), qe)
        imaxs[:, i:i + 1] = imax
    imaxs.masked_fill_(~live, 0)

    score2, te2 = z.clone(), z - 1
    if want_sub:
        # run tracking: a run's position is the row of its last max UPDATE
        # and adjacency is tested against that row, so non-improving rows
        # can split runs; a finished run counts only outside the best
        # hit's neighbourhood, which needs the final te — a second pass.
        # A row where no task reaches minsc changes nothing: skipped.
        lo, hi = te - qlen, te + qlen
        bf, bs = z.clone(), z - 2
        elig_all = live & (imaxs >= minsc)

        def close(fin, bf, bs, score2, te2):
            upd = fin & ((bs < lo) | (bs > hi)) & (bf > score2)
            return torch.where(upd, bf, score2), torch.where(upd, bs, te2)

        for i in elig_all.any(dim=0).nonzero()[:, 0].tolist():
            im = imaxs[:, i:i + 1]
            elig = elig_all[:, i:i + 1]
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
        [C.c_void_p] * 8 + [C.c_int] * 11 + [C.c_void_p]


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


def smem_bytes(Q: int, instance: int | None = None) -> int:
    """Dynamic shared memory of one block of the kernel instance that takes
    Q (or of the one named): none in a register instance; in the generic
    instance four rows over the query (codes, H, E, G; padded to whole
    32-lane slots) for each of the block's tasks."""
    if instance is None:
        instance = kernel_instance(Q)
    return 0 if instance else _WARPS * 4 * 4 * 32 * ((Q + 31) // 32)


def workspace_bytes(N: int, T: int, want_sub: bool) -> int:
    """Device memory the wrapper allocates for a launch: with want_sub the
    T row maxima of each of the N tasks, nothing without."""
    return 4 * N * T if want_sub else 0


def check_launch(Q: int, T: int, instance: int | None = None) -> None:
    """Raise ValueError naming Q and T when the instance that takes Q (or
    the one named) cannot launch at these widths: its block's shared
    memory over SMEM_MAX (the generic instance past Q = 3,616), or T past
    MAX_T."""
    need = smem_bytes(Q, instance)
    if need > _SMEM_MAX:
        raise ValueError(f"ksw_local: Q={Q}, T={T} needs {need} bytes of "
                         f"shared memory per block, over the {_SMEM_MAX} "
                         f"available")
    if T > MAX_T:
        raise ValueError(f"ksw_local: Q={Q}, T={T}: T is past the kernel's "
                         f"{MAX_T} rows")


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
    check_launch(Q, T, instance)
    N = check_task_args("ksw_local", ("query", "qlen", "target", "tlen",
                                      "minsc", "valid"), args)
    out = torch.empty((N, 5), dtype=_I32, device=query.device)
    if N == 0:
        return out
    lib = kernel.load(_declare)
    # the row maxima of want_sub; the caching allocator serves it
    ws = torch.empty((N, T), dtype=_I32, device=query.device) \
        if want_sub else None
    ptrs = [x.data_ptr() for x in args] + \
        [out.data_ptr(), None if ws is None else ws.data_ptr()]
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
    current stream and its launch error, if any, raises. Shapes the kernel
    cannot launch raise ValueError (``check_launch``)."""
    args = (query, qlen, target, tlen, minsc, valid)
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins, a=a, b=b,
              want_sub=want_sub)
    if query.device.type == "cpu":
        return ksw_local_ref(*args, **kw)
    if query.dim() != 2:
        raise ValueError("ksw_local: query and target must be 2-D")
    return launch_kernel(args, kernel_instance(query.shape[1]), **kw)


ksw_local.launches = 0
