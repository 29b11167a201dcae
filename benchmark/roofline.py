"""The card's peaks and the least time each hand-written kernel's work could
take on it.

A kernel's work is counted from what its tasks need, whatever kernel
implements it: the dynamic-programming cells of each valid task (from its
query length, target length and band) times the integer operations a cell
takes, and the bytes of its inputs read once and its outputs written once.
The bound of a launch is the larger of the cells' operations over the
int32 peak and the bytes over the memory bandwidth.
"""
from __future__ import annotations

import numpy as np

# int32 operations a DP cell takes (the kernels' inner loops: H, E and F
# updates with their maxima; K2 adds the row maximum and the sub-optimal
# bookkeeping)
OPS_PER_CELL = {"k1": 15, "k2": 20}
# NVIDIA H100 SXM: HBM3 bandwidth (data sheet), int32 lanes an SM
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# bytes a task's scalar arguments and outputs take (int32 each)
K1_TASK_BYTES = 4 * (6 + 6)        # qlen tlen h0 w end_bonus valid | 6 out
K2_TASK_BYTES = 4 * (4 + 5)        # qlen tlen minsc valid | 5 out


def int32_peak(sm_count: int, max_sm_clock_mhz: float) -> float:
    """int32 operations a second: SMs x lanes x the maximum SM clock."""
    return float(sm_count) * INT32_LANES_PER_SM * max_sm_clock_mhz * 1e6


def k1_band(qlen, w, end_bonus, o_del: int, e_del: int, o_ins: int,
            e_ins: int, a: int):
    """The band ksw_extend2 runs at: w clipped by the longest gap the
    query's score could pay for [bwa: ksw.c :: ksw_extend2]."""
    qlen = np.asarray(qlen, np.int64)
    eb = np.asarray(end_bonus, np.int64)
    max_ins = np.maximum(np.trunc((qlen * a + eb - o_ins) / e_ins + 1.), 1)
    max_del = np.maximum(np.trunc((qlen * a + eb - o_del) / e_del + 1.), 1)
    return np.minimum(np.minimum(np.asarray(w, np.int64), max_ins),
                      max_del).astype(np.int64)


def band_cells(qlen, tlen, w):
    """Cells of a banded DP: rows i < tlen, columns max(0, i - w) to
    min(qlen, i + w + 1), summed in closed form per task."""
    Q = np.asarray(qlen, np.int64)
    T = np.asarray(tlen, np.int64)
    w = np.asarray(w, np.int64)
    Tp = np.clip(np.minimum(T, Q + w), 0, None)
    a = np.clip(Q - w, 0, Tp)
    s1 = a * (a - 1) // 2 + a * (w + 1) + (Tp - a) * Q
    m = np.clip(Tp - 1 - w, 0, None)
    s2 = m * (m + 1) // 2
    return np.where((Q > 0) & (T > 0), s1 - s2, 0)


def k1_launch(qlen, tlen, w, end_bonus, valid, opt: dict):
    """(cells, bytes) of one K1 launch's valid tasks."""
    v = np.asarray(valid).astype(bool)
    q, t = np.asarray(qlen)[v], np.asarray(tlen)[v]
    band = k1_band(q, np.asarray(w)[v], np.asarray(end_bonus)[v],
                   opt["o_del"], opt["e_del"], opt["o_ins"], opt["e_ins"],
                   opt["a"])
    cells = int(band_cells(q, t, band).sum())
    nbytes = int(4 * (q.astype(np.int64).sum() + t.astype(np.int64).sum())
                 + K1_TASK_BYTES * int(v.sum()))
    return cells, nbytes


def k2_launch(qlen, tlen, valid):
    """(cells, bytes) of one K2 launch's valid tasks: unbanded, Q x T."""
    v = np.asarray(valid).astype(bool)
    q = np.asarray(qlen, np.int64)[v]
    t = np.asarray(tlen, np.int64)[v]
    cells = int((q * t).sum())
    nbytes = int(4 * (q.sum() + t.sum()) + K2_TASK_BYTES * int(v.sum()))
    return cells, nbytes


def bound_s(cells: int, nbytes: int, ops_per_cell: int, peak_ops: float,
            bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    return max(cells * ops_per_cell / peak_ops, nbytes / bytes_per_s)


def share_pct(bounds_s: float, kernel_s: float):
    """Roofline share in %, None where the kernel did not run."""
    if kernel_s <= 0:
        return None
    return 100.0 * bounds_s / kernel_s
