"""ctypes wrapper around the native oracle (scalar BWA-MEM semantics).

The oracle in ``native/*.cpp`` is the golden spec for every device stage
and the production host-side finishing path. It is built on demand with
g++ into ``build/tpubwa_torch/liboracle.so``: the library is linked to a
temporary file and renamed into place, so a process that loads it never
sees a half-written file, even while another process builds it.
"""
from __future__ import annotations

import ctypes as C
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..index.builder import FMIndex
from ..opts import MemOptions
from ..utils.files import write_atomic

_REPO = Path(__file__).resolve().parents[2]
_SO = _REPO / "build" / "tpubwa_torch" / "liboracle.so"
_NATIVE = _REPO / "native"

_lib = None
_lib_lock = threading.Lock()


def _build() -> None:
    def link(tmp):
        cmd = ["g++", "-O2", "-g", "-std=c++17", "-shared", "-fPIC",
               *[str(s) for s in sorted(_NATIVE.glob("*.cpp"))], "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    write_atomic(_SO, link)


def get_lib() -> C.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        srcs = [*_NATIVE.glob("*.cpp"), *_NATIVE.glob("*.h")]
        newest_src = max((s.stat().st_mtime for s in srcs), default=0)
        if not _SO.exists() or _SO.stat().st_mtime < newest_src:
            _build()
        lib = C.CDLL(str(_SO))
        _declare(lib)
        _lib = lib
        return _lib


class CMemOpt(C.Structure):
    """Must match native/fm.h :: MemOpt field-for-field."""
    _fields_ = [
        ("a", C.c_int32), ("b", C.c_int32),
        ("o_del", C.c_int32), ("e_del", C.c_int32),
        ("o_ins", C.c_int32), ("e_ins", C.c_int32),
        ("pen_unpaired", C.c_int32), ("pen_clip5", C.c_int32),
        ("pen_clip3", C.c_int32), ("w", C.c_int32), ("zdrop", C.c_int32),
        ("min_seed_len", C.c_int32), ("split_width", C.c_int32),
        ("max_occ", C.c_int32), ("max_chain_gap", C.c_int32),
        ("max_chain_extend", C.c_int32), ("min_chain_weight", C.c_int32),
        ("T", C.c_int32), ("flag", C.c_int32), ("max_ins", C.c_int32),
        ("max_matesw", C.c_int32), ("max_xa_hits", C.c_int32),
        ("split_factor", C.c_double), ("mask_level", C.c_double),
        ("drop_ratio", C.c_double), ("mask_level_redun", C.c_double),
        ("mapq_coef_len", C.c_double), ("xa_drop_ratio", C.c_double),
        ("mat", C.c_int8 * 25),
    ]


def to_copt(o: MemOptions) -> CMemOpt:
    c = CMemOpt()
    for name, _ in CMemOpt._fields_[:-1]:
        setattr(c, name, getattr(o, name))
    mat = o.scmat.reshape(-1)
    for i in range(25):
        c.mat[i] = int(mat[i])
    return c


def _declare(lib: C.CDLL) -> None:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    lib.tb_idx_new.restype = C.c_void_p
    lib.tb_idx_new.argtypes = [
        C.c_int64, C.c_int64, C.c_int64, i64p, u32p, u32p, i64p, u8p,
        i64p, i64p, C.c_int, C.POINTER(C.c_char_p),
    ]
    lib.tb_idx_free.argtypes = [C.c_void_p]
    lib.tb_align_se_sam.restype = C.c_void_p  # char*; sliced manually
    lib.tb_align_se_sam.argtypes = [
        C.c_void_p, C.POINTER(CMemOpt), u8p, i32p,
        C.POINTER(C.c_char_p), C.POINTER(C.c_char_p), C.c_int, C.c_int,
        C.c_int64, C.c_char_p, C.POINTER(C.c_int64),
    ]
    lib.tb_finish_se_sam.restype = C.c_void_p
    lib.tb_finish_se_sam.argtypes = [
        C.c_void_p, C.POINTER(CMemOpt), u8p, i32p,
        C.POINTER(C.c_char_p), C.POINTER(C.c_char_p), C.c_int, C.c_int,
        i64p, i32p, i32p, C.c_int64, C.c_char_p, C.POINTER(C.c_int64),
    ]
    lib.tb_sais.restype = C.c_int
    lib.tb_sais.argtypes = [u8p, C.c_int64, i64p]
    # ---- scalar stages, for differential tests of the device stages
    lib.tb_ksw_extend.argtypes = [
        C.c_int, u8p, C.c_int, u8p, C.c_int, C.c_int, C.c_int, C.c_int,
        C.c_int, C.c_int, C.c_int, C.c_int, i8p, i32p,
    ]
    lib.tb_ksw_global.restype = C.c_int
    lib.tb_ksw_global.argtypes = [
        C.c_int, u8p, C.c_int, u8p, C.c_int, C.c_int, C.c_int, C.c_int,
        C.c_int, i8p, u32p, C.c_int, C.POINTER(C.c_int),
    ]
    lib.tb_smems.restype = C.c_int
    lib.tb_smems.argtypes = [C.c_void_p, C.POINTER(CMemOpt), u8p, C.c_int,
                             C.POINTER(C.POINTER(C.c_int64))]
    lib.tb_chains.restype = C.c_int
    lib.tb_chains.argtypes = [C.c_void_p, C.POINTER(CMemOpt), u8p, C.c_int,
                              C.c_int, C.POINTER(C.POINTER(C.c_int64))]
    lib.tb_regs.restype = C.c_int
    lib.tb_regs.argtypes = [C.c_void_p, C.POINTER(CMemOpt), u8p, C.c_int,
                            C.c_int64, C.c_int,
                            C.POINTER(C.POINTER(C.c_int64))]
    # ---- paired-end entry points
    lib.tb_ksw_align.argtypes = [
        C.c_int, u8p, C.c_int, u8p, C.c_int, C.c_int, C.c_int, C.c_int,
        C.c_int, i8p, i32p,
    ]
    lib.tb_regs_pre.restype = C.c_int
    lib.tb_regs_pre.argtypes = [C.c_void_p, C.POINTER(CMemOpt), u8p, C.c_int,
                                C.POINTER(C.POINTER(C.c_int64)), i32p]
    lib.tb_align_pe_sam.restype = C.c_void_p
    lib.tb_align_pe_sam.argtypes = [
        C.c_void_p, C.POINTER(CMemOpt), u8p, i32p,
        C.POINTER(C.c_char_p), C.POINTER(C.c_char_p), C.c_int, C.c_int,
        C.c_int64, C.c_char_p, f64p, C.POINTER(C.c_int64),
    ]
    lib.tb_finish_pe_sam.restype = C.c_void_p
    lib.tb_finish_pe_sam.argtypes = [
        C.c_void_p, C.POINTER(CMemOpt), u8p, i32p,
        C.POINTER(C.c_char_p), C.POINTER(C.c_char_p), C.c_int, C.c_int,
        i64p, i32p, i32p, C.c_void_p, C.c_int, C.c_void_p, C.c_void_p,
        C.c_int, C.c_int64, C.c_char_p, C.POINTER(C.c_int64),
    ]
    lib.tb_pe_isize.restype = C.c_int
    lib.tb_pe_isize.argtypes = [
        C.c_void_p, C.POINTER(CMemOpt), u8p, i32p, C.c_int, C.c_int,
        i64p, i32p, i32p, i32p, i64p,
    ]
    lib.tb_pe_rescue_tasks.restype = C.c_int
    lib.tb_pe_rescue_tasks.argtypes = [
        C.c_void_p, C.POINTER(CMemOpt), u8p, i32p, C.c_int, C.c_int,
        i64p, i32p, i32p, C.c_void_p, C.c_int, C.c_int64,
        C.POINTER(C.POINTER(C.c_int64)),
    ]
    # rescue results the native replay asked for and did not find injected
    lib.tb_rescue_miss_count.restype = C.c_int
    lib.tb_rescue_miss_count.argtypes = []
    lib.tb_rescue_miss_reset.restype = None
    lib.tb_rescue_miss_reset.argtypes = []


def ksw_extend(query, target, opt: MemOptions, w=None, end_bonus=0, h0=0,
               zdrop=None):
    """Scalar ksw_extend2. Returns (score, qle, tle, gtle, gscore, max_off)."""
    lib = get_lib()
    query = np.ascontiguousarray(query, dtype=np.uint8)
    target = np.ascontiguousarray(target, dtype=np.uint8)
    out = np.zeros(6, dtype=np.int32)
    mat = np.ascontiguousarray(opt.scmat.reshape(-1))
    lib.tb_ksw_extend(len(query), query, len(target), target, opt.o_del,
                      opt.e_del, opt.o_ins, opt.e_ins,
                      opt.w if w is None else w, end_bonus,
                      opt.zdrop if zdrop is None else zdrop, h0, mat, out)
    return tuple(int(x) for x in out)


def ksw_global(query, target, opt: MemOptions, w=None):
    """Scalar ksw_global2. Returns (score, cigar list of (len, op))."""
    lib = get_lib()
    query = np.ascontiguousarray(query, dtype=np.uint8)
    target = np.ascontiguousarray(target, dtype=np.uint8)
    cap = len(query) + len(target) + 2
    cig = np.zeros(cap, dtype=np.uint32)
    n = C.c_int(0)
    mat = np.ascontiguousarray(opt.scmat.reshape(-1))
    score = lib.tb_ksw_global(len(query), query, len(target), target,
                              opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                              opt.w if w is None else w, mat, cig, cap,
                              C.byref(n))
    return score, [(int(c) >> 4, int(c) & 0xF) for c in cig[: n.value]]


def ksw_align_local(query, target, opt: MemOptions, minsc=0):
    """Scalar local SW. Returns dict(score, tb, te, qb, qe, score2, te2)."""
    lib = get_lib()
    query = np.ascontiguousarray(query, dtype=np.uint8)
    target = np.ascontiguousarray(target, dtype=np.uint8)
    out = np.zeros(7, dtype=np.int32)
    mat = np.ascontiguousarray(opt.scmat.reshape(-1))
    lib.tb_ksw_align(len(query), query, len(target), target, opt.o_del,
                     opt.e_del, opt.o_ins, opt.e_ins, minsc, mat, out)
    keys = ("score", "tb", "te", "qb", "qe", "score2", "te2")
    return dict(zip(keys, (int(x) for x in out)))


def sam_args(batch):
    """A batch as the native SAM entry points take it: contiguous uint8
    seqs, int32 lens, and C string arrays of names and qualities."""
    seqs = np.ascontiguousarray(batch.seqs, dtype=np.uint8)
    lens = np.ascontiguousarray(batch.lens, dtype=np.int32)
    names = (C.c_char_p * batch.n)(*[n.encode() for n in batch.names])
    quals = (C.c_char_p * batch.n)(*[(q or "").encode() for q in batch.quals])
    return seqs, lens, names, quals


class Oracle:
    """Holds a native index handle over a (kept-alive) FMIndex."""

    def __init__(self, idx: FMIndex):
        lib = get_lib()
        # keep contiguous arrays alive for the lifetime of the handle
        self._keep = dict(
            L2=np.ascontiguousarray(idx.L2, dtype=np.int64),
            bwt_words=np.ascontiguousarray(idx.bwt_words, dtype=np.uint32),
            occ_cp=np.ascontiguousarray(idx.occ_cp, dtype=np.uint32),
            sa_samples=np.ascontiguousarray(idx.sa_samples, dtype=np.int64),
            pac=np.ascontiguousarray(idx.pac, dtype=np.uint8),
            ann_off=np.ascontiguousarray(
                [a.offset for a in idx.anns], dtype=np.int64),
            ann_len=np.ascontiguousarray(
                [a.length for a in idx.anns], dtype=np.int64),
        )
        names = [a.name.encode() for a in idx.anns]
        self._names_arr = (C.c_char_p * len(names))(*names)
        self.rnames = [a.name for a in idx.anns]
        self._lib = lib
        self._h = lib.tb_idx_new(
            idx.l_pac, idx.primary, idx.sa_intv, self._keep["L2"],
            self._keep["bwt_words"], self._keep["occ_cp"],
            self._keep["sa_samples"], self._keep["pac"],
            self._keep["ann_off"], self._keep["ann_len"], len(names),
            self._names_arr)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tb_idx_free(self._h)
            self._h = None

    def _rows(self, fn, seq, opt: MemOptions, width: int, *extra):
        """Call a native stage that returns n rows of `width` int64s."""
        seq = np.ascontiguousarray(seq, dtype=np.uint8)
        rows = C.POINTER(C.c_int64)()
        n = fn(self._h, C.byref(to_copt(opt)), seq, len(seq), *extra,
               C.byref(rows))
        return np.ctypeslib.as_array(rows, shape=(n, width)).copy() if n \
            else np.empty((0, width), dtype=np.int64)

    def smems(self, seq, opt: MemOptions):
        """[(k, l, s, qbeg, qend)] after both seeding rounds."""
        return self._rows(self._lib.tb_smems, seq, opt, 5)

    def chains(self, seq, opt: MemOptions, filtered=True):
        """Seed rows (rbeg, qbeg, len, chain_id) after chaining (+filter)."""
        return self._rows(self._lib.tb_chains, seq, opt, 4,
                          1 if filtered else 0)

    def regs(self, seq, opt: MemOptions, read_id=0, stage=1):
        """AlnReg rows. stage 0: pre-dedup (rb,re,qb,qe,seedcov,score,
        truesc,seedlen0,csub,sub_n,w,sec); stage 1: post-dedup; stage 2:
        post-primary-marking (rid/sub in cols 4/7)."""
        return self._rows(self._lib.tb_regs, seq, opt, 12, read_id, stage)

    def regs_pre(self, seq, opt: MemOptions):
        """Pre-dedup regions in the device/finish 10-field layout + l_rep."""
        seq = np.ascontiguousarray(seq, dtype=np.uint8)
        rows = C.POINTER(C.c_int64)()
        l_rep = np.zeros(1, dtype=np.int32)
        n = self._lib.tb_regs_pre(self._h, C.byref(to_copt(opt)), seq,
                                  len(seq), C.byref(rows), l_rep)
        arr = (np.ctypeslib.as_array(rows, shape=(n, 10)).copy() if n
               else np.empty((0, 10), dtype=np.int64))
        return arr, int(l_rep[0])

    def align_pe(self, batch, opt: MemOptions, id0=0, rg_id=""):
        """Paired-end SAM for an interleaved ReadBatch (pair i = rows
        2i, 2i+1). Returns (sam_text, pes) where pes is a (4, 5) array of
        (low, high, failed, avg, std) per orientation FF/FR/RF/RR."""
        opt = opt.replace(flag=opt.flag | MemOptions.F_PE)
        seqs, lens, names, quals = sam_args(batch)
        pes = np.zeros((4, 5), dtype=np.float64)
        out_len = C.c_int64(0)
        ptr = self._lib.tb_align_pe_sam(
            self._h, C.byref(to_copt(opt)), seqs, lens, names, quals,
            batch.n, seqs.shape[1], id0, rg_id.encode(), pes.reshape(-1),
            C.byref(out_len))
        return C.string_at(ptr, out_len.value).decode(), pes

    def align_se(self, batch, opt: MemOptions, id0=0, rg_id="") -> str:
        """Full single-end SAM body text for a ReadBatch."""
        seqs, lens, names, quals = sam_args(batch)
        out_len = C.c_int64(0)
        ptr = self._lib.tb_align_se_sam(
            self._h, C.byref(to_copt(opt)), seqs, lens, names, quals,
            batch.n, seqs.shape[1] if seqs.ndim == 2 else len(seqs),
            id0, rg_id.encode(), C.byref(out_len))
        return C.string_at(ptr, out_len.value).decode()

    def finish_se(self, batch, opt: MemOptions, flat, counts, l_rep, id0=0,
                  rg_id="") -> str:
        """SAM text for reads whose pre-dedup regions came from the device:
        flat (total, 10) int64 rows in REG_FIELDS order, counts (n,) regions
        per read, l_rep (n,) repetitive query length per read."""
        seqs, lens, names, quals = sam_args(batch)
        out_len = C.c_int64(0)
        ptr = self._lib.tb_finish_se_sam(
            self._h, C.byref(to_copt(opt)), seqs, lens, names, quals,
            batch.n, seqs.shape[1], np.ascontiguousarray(flat, np.int64),
            np.ascontiguousarray(counts, np.int32),
            np.ascontiguousarray(l_rep, np.int32), id0, rg_id.encode(),
            C.byref(out_len))
        return C.string_at(ptr, out_len.value).decode()
