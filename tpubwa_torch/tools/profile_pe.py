"""The paired-end finish bisected stage by stage on the 4.6 Mbp bench
genome: the counterpart of ``scripts/profile_pe.py``.

Pairs of 150 bp (1% substitutions, 0.1% indels, inserts 400 +- 50) from
the bench genome (``tools/bench_world.py``). One batch (seed 1) warms the
path through ``align_pe``; another (seed 2) runs the steps of
``Aligner._pe_stage_a`` / ``_pe_stage_b`` one by one, each on the host
clock: ``worker1_device`` (``worker1_packed``, ended by a synchronize),
``transfer`` (the copy to the host), ``unpack``, ``tier2`` (the big-caps
tiers, when tier 1 overflowed), ``native_isize`` (per-pair insert
samples), ``pestat_psum_device`` (``dist/mesh.py::pe_hist_psum`` on the
aligner's device, its copy to the host included: it returns a host
array), ``pestat_dl`` (``dist/multihost.py::hist_allreduce``, the
single-process identity), ``native_rescue_taskgen``,
``rescue_kernel`` (``pair/rescue.py::run_rescue_tasks``: K2 forward and
reverse) and ``native_pair_sam``; beside them ``n_rescue_tasks`` and
``sum_ms``. Then 4 batches (seeds 10-13) through ``align_pe_stream``:
``pe_stream_reads_per_s``. The native finish counts every rescue window
whose result it needed and was not given (``rescue_results_missing``, 0
on a sound run).

Usage: python -m tpubwa_torch.tools.profile_pe [pairs]
           [--platform cuda|cpu]
Runs on the card and raises without one unless ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import ctypes as C
import json
import sys
import time

import numpy as np

PE_READ_LEN = 150
STREAM_BATCHES = 4


def pairs_batch(aln, pairs: int, seed: int):
    """``pairs`` pairs of 150 bp from the index's forward strand,
    interleaved in one ReadBatch (simulate_reads counts pairs when
    paired: the reference script passes 2 * pairs and so profiles batches
    of twice the pairs its argument names)."""
    from ..io import fastx
    fwd = aln.idx.get_seq(0, aln.idx.l_pac).astype(np.uint8)
    recs = fastx.simulate_reads(fwd, pairs, read_len=PE_READ_LEN,
                                paired=True, error_rate=0.01,
                                indel_rate=0.001, seed=seed,
                                insert_mean=400, insert_std=50)
    return fastx.batch_reads(recs, max_len=PE_READ_LEN)


def profile_pe(aln, pairs: int = 2048) -> dict:
    """The PE finish's steps (ms) on one batch of ``pairs`` pairs, and the
    streamed rate over STREAM_BATCHES batches."""
    from ..dist.mesh import pe_hist_psum
    from ..dist.multihost import hist_allreduce
    from ..opts import MemOptions
    from ..oracle import sam_args, to_copt
    from ..pair.rescue import run_rescue_tasks
    from .scale_bench import sync
    aln.align_pe(pairs_batch(aln, pairs, 1), id0=0)      # warm the path
    batch = pairs_batch(aln, pairs, 2)
    lib = aln.oracle._lib
    lib.tb_rescue_miss_reset()
    t = {}

    def tick(name, t0):
        t[name] = (time.perf_counter() - t0) * 1e3

    sync(aln)
    t0 = time.perf_counter()
    dev = aln.worker1_packed(batch.seqs, batch.lens)
    sync(aln)
    tick("worker1_device", t0)
    t0 = time.perf_counter()
    buf = dev.cpu().numpy()
    tick("transfer", t0)

    copt = to_copt(aln.opt.replace(flag=aln.opt.flag | MemOptions.F_PE))
    t0 = time.perf_counter()
    n, ovf, l_rep, flat = aln._unpack_host(buf, batch.n)
    tick("unpack", t0)
    t0 = time.perf_counter()
    if ovf.any():
        n, ovf, l_rep, flat = aln._tiers(batch, n, ovf, l_rep, flat)
    tick("tier2", t0)

    seqs_h, lens_h, names, quals = sam_args(batch)
    flat_h = np.ascontiguousarray(flat, np.int64)
    n_h = np.ascontiguousarray(n, np.int32)
    lrep_h = np.ascontiguousarray(l_rep, np.int32)
    stride = seqs_h.shape[1]
    n_pairs = batch.n // 2
    dirs = np.zeros(max(n_pairs, 1), np.int32)
    isz = np.zeros(max(n_pairs, 1), np.int64)
    t0 = time.perf_counter()
    lib.tb_pe_isize(aln.oracle._h, C.byref(copt), seqs_h, lens_h, batch.n,
                    stride, flat_h, n_h, lrep_h, dirs, isz)
    tick("native_isize", t0)
    t0 = time.perf_counter()
    hist = pe_hist_psum(dirs[:n_pairs], isz[:n_pairs], aln.opt.max_ins,
                        aln.device)
    tick("pestat_psum_device", t0)
    t0 = time.perf_counter()
    hist_h = np.ascontiguousarray(hist_allreduce(hist), np.int64)
    tick("pestat_dl", t0)

    rowsp = C.POINTER(C.c_int64)()
    t0 = time.perf_counter()
    n_t = lib.tb_pe_rescue_tasks(
        aln.oracle._h, C.byref(copt), seqs_h, lens_h, batch.n, stride,
        flat_h, n_h, lrep_h, hist_h.ctypes.data_as(C.c_void_p),
        aln.opt.max_ins, 0, C.byref(rowsp))
    tick("native_rescue_taskgen", t0)
    t["n_rescue_tasks"] = int(n_t)
    tasks_p = res_p = None
    if n_t:
        tasks = np.ctypeslib.as_array(rowsp, shape=(n_t * 8,)) \
            .reshape(n_t, 8).copy()
        t0 = time.perf_counter()
        res = np.ascontiguousarray(run_rescue_tasks(
            aln.didx, batch.seqs, batch.lens, tasks, 0, aln.opt), np.int32)
        tick("rescue_kernel", t0)
        tasks_p = tasks.ctypes.data_as(C.c_void_p)
        res_p = res.ctypes.data_as(C.c_void_p)
    out_len = C.c_int64(0)
    t0 = time.perf_counter()
    lib.tb_finish_pe_sam(
        aln.oracle._h, C.byref(copt), seqs_h, lens_h, names, quals, batch.n,
        stride, flat_h, n_h, lrep_h, hist_h.ctypes.data_as(C.c_void_p),
        aln.opt.max_ins, tasks_p, res_p, n_t, 0, b"", C.byref(out_len))
    tick("native_pair_sam", t0)
    sum_ms = sum(v for k, v in t.items() if k != "n_rescue_tasks")

    bs = [pairs_batch(aln, pairs, 10 + i) for i in range(STREAM_BATCHES)]
    aln.stats = {"reads": 0, "fallback_reads": 0}
    sync(aln)
    t0 = time.perf_counter()
    for _ in aln.align_pe_stream(bs, id0=0):
        pass
    dt = time.perf_counter() - t0
    return {"pairs": pairs, **t, "sum_ms": sum_ms,
            "pe_stream_reads_per_s": sum(b.n for b in bs) / dt,
            "rescue_results_missing": int(lib.tb_rescue_miss_count()),
            "device": aln.device.type}


STEPS = ("worker1_device", "transfer", "unpack", "tier2", "native_isize",
         "pestat_psum_device", "pestat_dl", "native_rescue_taskgen",
         "rescue_kernel", "native_pair_sam")


def report(r: dict) -> None:
    """The reference script's two lines."""
    steps = {k: round(r[k], 1) for k in STEPS if k in r}
    print({"pairs": r["pairs"], **steps, "n_rescue_tasks":
           r["n_rescue_tasks"], "sum_ms": round(r["sum_ms"], 1)}, flush=True)
    print({"pe_stream_reads_per_s": round(r["pe_stream_reads_per_s"], 1)},
          flush=True)


def main(argv=None) -> int:
    from . import bench_world
    from .scale_bench import require_card
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.profile_pe",
        description="the PE finish stage by stage on the 4.6 Mbp bench "
                    "genome")
    ap.add_argument("pairs", type=int, nargs="?", default=2048)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    require_card(a.platform, "profile_pe")
    r = profile_pe(bench_world.make_aligner(a.platform), a.pairs)
    report(r)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
