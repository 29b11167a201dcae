// Batched banded affine-gap seed extension on Hopper (sm_90a).
//
// Replaces tpubwa/ops/sw_pallas.py::_kernel (entry ksw_extend_pallas), the
// TPU kernel of the extension stage. Computes exact ksw_extend2 semantics
// (native/ksw.cpp): band clip to max_ins/max_del, z-drop, live-band shrink,
// to-query-end score, bwa 5x5 matrix (match a, mismatch -b, N -1). The
// plain PyTorch version it is held to is tpubwa_torch/ops/sw.py::
// ksw_extend_ref.
//
// What bounds it: operations by the roofline (a 100 bp extension reads
// ~1.6 KB and does ~15 int32 operations per band cell), but at the sizes the
// aligner launches neither bytes nor operations are near: a launch lasts as
// long as its longest task, and a task is a serial walk over its rows. So
// the time of a launch is its launch cost plus (rows of the longest task) x
// (latency of one row), and the design is about the dependent chain of one
// row.
//
// Design (register instances, template parameter K = columns a lane owns):
// one warp per task. The query's columns are split over the 32 lanes in
// contiguous chunks of K = ceil(Q / 32); a lane keeps its chunk of the H
// row (ksw's eh_h, stored without its index shift), of eh_e and of the
// query codes in registers, every loop over the chunk is fully unrolled and
// predicated on the band. No shared memory and no barrier in the row loop.
// A warp that is alone on its scheduler hides none of its own latencies,
// and on the card a row cost its instruction count as much as its chain of
// shuffles: each cell is computed once, and what can be decided a lane or a
// row at a time is not done a cell at a time. Per row:
//   base     the row's target base is a shuffle from a register (each lane
//            loads one base every 32 rows), not a load in the chain;
//   diagonal H(i-1, c0-1) of a lane's first column is the previous lane's
//            last H, one __shfl_up (lane 0 takes ksw's eh_h[0], a scalar);
//   pass 1   each cell once: M (with the mp != 0 rule) and the insertion
//            term A(j) = max(M - oe_ins, 0) + e_ins*j, kept in registers
//            with the lane's own exclusive running maximum of A;
//   scan     one exclusive max-scan over the lanes' maxima gives each lane
//            the carry of the insertion chain F: four independent shuffles
//            and three doubling steps;
//   pass 2   F from carry and the lane's running maximum (no chain inside
//            the lane), H = max3(M, E, F), E' (DPX instructions, no
//            recomputation of M), written in place under the band's
//            predicate; ksw's eh_h[beg] = h1 becomes a scalar (beg = 0) or
//            a zero below the band, its eh_e[end] = 0 never changes
//            anything and is left out (see the row loop);
//   reduce   row maximum and its LAST column as one packed key through one
//            redux.sync; the live band's first and last live entry through
//            one redux.sync each, all three side by side.
// The loop is software-pipelined: base, diagonal, pass 1 and scan of row
// i + 1 do not depend on row i's band, so they are issued between row i's
// reductions and the bookkeeping that consumes them (next band, z-drop,
// stop), whose latency they hide.
// Band bookkeeping is warp-uniform; each warp leaves its row loop as soon as
// its own task ends.
//
// Queries too long for the largest register instance (Q > 32 * kMaxK)
// take the generic instance: the same function with the row in shared
// memory, three passes a row, butterfly reductions. The instance is chosen
// by shape (ops/sw.py::kernel_instance), never by failure.
#include "ksw_common.cuh"

namespace {

using namespace ksw;

constexpr int kMaxK = 9;       // largest register instance: Q <= 288
constexpr int kKeyBits = 9;    // packed key: column in the low 9 bits

__device__ __forceinline__ int floordiv(int x, int y) {
  int q = x / y;
  if ((x % y != 0) && ((x < 0) != (y < 0))) --q;
  return q;
}

__device__ __forceinline__ int score_plain(int tc, int qc, int a, int b) {
  if (tc > 3 || qc > 3) return -1;
  return tc == qc ? a : -b;
}

// The head of a row, everything that does not need the row's band: the
// target base, the diagonal input of the lane's first column, M and the
// insertion term A of each cell once, the lane's exclusive running maximum
// of A (px) and, by one scan over the lanes, the carry of the insertion
// chain F into the lane.
//
// A is masked by the band clip (j >= i - w) alone, not by the live band
// [bg, en): a column at or above en can only feed columns further right,
// which the row does not write; a column below bg that passes the clip is
// a dead entry of ksw's eh (H = 0, never written again), whose M is 0 by
// the mp != 0 rule and whose A = e_ins * j' reaches no column j > j' with
// more than 0. So F over these columns equals F over [bg, j), and the head
// of row i + 1 can be issued before row i's reductions have come back.
template <int K>
__device__ __forceinline__ int row_head(
    int i, int lane, int c0, int w, int T, const int *__restrict__ trow,
    int &tchunk, int hm1, const int (&hrow)[K], const int (&qq)[K],
    const int (&mis)[K], int a, int oe_ins, int e_ins, int (&m)[K],
    int (&px)[K]) {
  if ((i & 31) == 0) tchunk = load_bases(trow, i, lane, T);
  const RowBase tb = row_base(__shfl_sync(kFull, tchunk, i & 31));
  int hd = __shfl_up_sync(kFull, hrow[K - 1], 1);
  if (lane == 0) hd = hm1;
  const int clip = i - w;
  int run = kNeg;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = c0 + k;
    const int mp = hd;
    hd = hrow[k];
    m[k] = mp != 0 ? mp + score(tb, qq[k], mis[k], a) : 0;
    px[k] = run;
    const int ak = addmax_relu(m[k], -oe_ins, 0) + e_ins * j;
    run = max(run, j >= clip ? ak : kNeg);
  }
  return warp_excl_max(run, lane);
}

template <int K>
__global__ void __launch_bounds__(32 * kWarps) ksw_extend_reg_kernel(
    const int *__restrict__ query, const int *__restrict__ qlen_a,
    const int *__restrict__ target, const int *__restrict__ tlen_a,
    const int *__restrict__ h0_a, const int *__restrict__ w_a,
    const int *__restrict__ eb_a, const int *__restrict__ valid_a,
    int *__restrict__ out, int N, int Q, int T, int o_del, int e_del,
    int o_ins, int e_ins, int zdrop, int a, int b) {
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= N) return;  // warp-uniform

  const int qlen = qlen_a[task], tlen = tlen_a[task], h0 = h0_a[task];
  const int eb = eb_a[task];
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const int max_sc = max(a, max(-b, -1));
  // band clip [bwa: the max_ins/max_del adjustment]; floor division as in
  // the plain version (after the max(., 1) clamp it equals bwa's double
  // math, and C++ truncation would too)
  const int max_ins = max(floordiv(qlen * max_sc + eb - o_ins, e_ins) + 1, 1);
  const int max_del = max(floordiv(qlen * max_sc + eb - o_del, e_del) + 1, 1);
  const int w = min(min(w_a[task], max_ins), max_del);

  // Every H of the task is at most max(h0, 0) + max(a, 0) * qlen: the first
  // row and column start at or below h0, a diagonal step adds at most a, E
  // and F only subtract. While that stays under 2^22 the row maximum and
  // its column (< 2^9: Q <= 288 here) fit one non-negative int32 key
  // h << 9 | j, and the maximum of the keys is the maximum h with its LAST
  // column. A task beyond the limit takes two reductions instead.
  const bool packed =
      (long long)max(h0, 0) + (long long)max(a, 0) * max(qlen, 0) <
      (1ll << (31 - kKeyBits));

  const int *qrow = query + (size_t)task * Q;
  const int *trow = target + (size_t)task * T;
  const int c0 = lane * K;  // the lane owns columns [c0, c0 + K)
  int hrow[K];              // H(i-1, j), ksw's eh_h[j+1]
  int ee[K];                // eh_e[j]
  int qq[K];                // query code of column j
  int mis[K];               // its score against another base
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = c0 + k;
    hrow[k] = j + 1 <= qlen ? max(h0 - o_ins - e_ins * (j + 1), 0) : 0;
    ee[k] = 0;
    qq[k] = j < Q ? clamp_code(qrow[j]) : 4;
    mis[k] = qq[k] > 3 ? -1 : -b;
  }
  int hm1 = h0;             // H(i-1, -1), ksw's eh_h[0]; warp-uniform

  int beg = 0, end = qlen, mx = h0, max_i = -1, max_j = -1, max_ie = -1;
  int gscore = -1, max_off = 0;
  bool done = valid_a[task] == 0 || qlen <= 0 || tlen <= 0 || T <= 0;
  int tchunk = 4;
  int m[K], px[K];          // M and the lane's running maximum of A
  int carry = kNeg;         // the F carry into the lane
  if (!done)
    carry = row_head<K>(0, lane, c0, w, T, trow, tchunk, hm1, hrow, qq, mis,
                        a, oe_ins, e_ins, m, px);

  // The row loop is software-pipelined: a row's tail (F, H, E' and the
  // row's three reductions) is followed by the head of the NEXT row, and
  // only then are the reductions consumed. The band of the next row and
  // the decision to stop hang on those reductions; its head does not (see
  // row_head), so their latency hides behind it. A head computed for a row
  // that is then not run costs nothing but its instructions.
  for (int i = 0; !done; ++i) {
    const int bg = max(beg, i - w);
    const int en = min(min(end, i + w + 1), qlen);

    // tail: F, H and next E, written over the row in place.
    //  * H(i, j) on [bg, en); 0 below bg: ksw writes eh_h[beg] = h1 there,
    //    which is 0 for bg > 0 (bg = 0 puts h1 into the scalar hm1), and
    //    the columns further down are never read again (bg never falls);
    //    at and above en the row above stays.
    //  * E'(j) on [bg, en). ksw also writes eh_e[end] = 0, which never
    //    changes anything: an entry at or above a row's `end` holds E = 0
    //    (true at the start; a row leaves E = 0 in every entry above its
    //    last live one, and end2 is two past that; an entry the band clip
    //    i + w + 1 kept out has never been written).
    //  * Live-band shrink, over ksw's entries eh[bg..en] after the row:
    //    entry j is live when H(i, j-1) (h1 for j = bg) or E'(j) is not 0.
    //    In the band neither is negative, and a positive E' = max(M -
    //    oe_del, E - e_del, 0) needs a larger M or E, hence a positive H in
    //    the same column (the gap penalties are positive; the wrapper
    //    checks). So the live entries follow from the columns with a
    //    positive H alone: the last one (hi) is one past the last such
    //    column, the first one (lo) is the first such column when its E' is
    //    positive and the next entry when not.
    const int h1_init =
        bg == 0 ? max(h0 - (o_del + e_del * (i + 1)), 0) : 0;
    int lm = 0, lj = 0;                 // lane maximum, its LAST column
    int lo = INT_MAX, hi = -1;
    int last = 0;                       // H of the lane's last band column
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = c0 + k;
      const bool geb = j >= bg;
      const bool inb = geb && j < en;
      const int f = addmax_relu(max(carry, px[k]), -e_ins * (j - 1), 0);
      const int e = ee[k];
      const int h = max3(m[k], e, f);
      const int e2 = addmax_relu(m[k], -oe_del, e - e_del);
      hrow[k] = inb ? h : (geb ? hrow[k] : 0);
      ee[k] = inb ? e2 : e;
      if (inb && h >= lm) {  // j ascends: >= keeps the last column
        lm = h;
        lj = j;
      }
      const bool pos = inb && h > 0;
      if (pos) hi = j + 1;
      lo = min(lo, pos ? (e2 > 0 ? j : j + 1) : INT_MAX);
      if (inb) last = h;
    }
    if (bg == 0) hm1 = h1_init;
    if (lo >= en) lo = INT_MAX;         // entry en is not in [bg, en)

    // The row's reductions, issued side by side. The plain version scans
    // for the first live entry beg2 in [bg, en) (en if none) and then for
    // the last one in [beg2, en]. The second scan does not need beg2: if
    // [bg, en) has a live entry, beg2 is one, so the last live entry of
    // [bg, en] is at or above beg2 and is the answer; if it has none,
    // beg2 = en and the last live entry of [bg, en] is en or nothing, again
    // the answer of the scan of [en, en]. H(i, en-1), the row's
    // to-query-end score, is `last` of the lane that owns that column.
    int mm, mj;
    if (packed) {
      const int key = warp_max((lm << kKeyBits) | lj);
      mm = key >> kKeyBits;
      mj = key & ((1 << kKeyBits) - 1);
    } else {
      mm = warp_max(lm);
      mj = warp_max(lm == mm ? lj : -1);
    }
    int lo_w = warp_min(lo), hi_w = warp_max(hi);
    const int h_end = __shfl_sync(kFull, last, max(en - 1, 0) / K);

    // the head of row i + 1, while those are in flight
    carry = row_head<K>(i + 1, lane, c0, w, T, trow, tchunk, hm1, hrow, qq,
                        mis, a, oe_ins, e_ins, m, px);

    if (mm == 0) mj = -1;
    if (h1_init > 0 && en >= bg) {      // entry bg holds h1: no lane's cell
      hi_w = max(hi_w, bg);
      if (en > bg) lo_w = bg;
    }
    const int beg2 = min(lo_w, en);
    const int last_live = max(hi_w >= beg2 ? hi_w : beg2 - 1, -1);
    const int end2 = min(last_live + 2, qlen);
    // to-query-end score; ksw tie rule: max_ie updates when h1 >= gscore
    const int h1_last = en > bg ? h_end : h1_init;
    if (en == qlen) {
      if (h1_last >= gscore) max_ie = i;
      gscore = max(gscore, h1_last);
    }
    // break / max update / z-drop [exact ksw_extend2 order]
    const bool better = mm > mx;
    const int di = i - max_i, dj = mj - max_j;
    const int pen = di > dj ? (di - dj) * e_del : (dj - di) * e_ins;
    done = mm == 0 || (!better && zdrop > 0 && mx - mm - pen > zdrop) ||
           i + 1 >= tlen;
    if (better) {
      max_off = max(max_off, abs(mj - i));
      mx = mm;
      max_i = i;
      max_j = mj;
    }
    beg = beg2;
    end = end2;
  }

  if (lane == 0) {
    int *o = out + (size_t)task * 6;
    o[0] = mx;
    o[1] = max_j + 1;
    o[2] = max_i + 1;
    o[3] = max_ie + 1;
    o[4] = gscore;
    o[5] = max_off;
  }
}

// The generic instance: any Q whose rows fit a block's shared memory. The
// warp's eh_h / eh_e rows, its query codes and the current DP row live in
// shared memory (4 * (Q+1) ints per warp); each cell is touched in three
// passes, with a __syncwarp between them.
__global__ void ksw_extend_generic_kernel(
    const int *__restrict__ query, const int *__restrict__ qlen_a,
    const int *__restrict__ target, const int *__restrict__ tlen_a,
    const int *__restrict__ h0_a, const int *__restrict__ w_a,
    const int *__restrict__ eb_a, const int *__restrict__ valid_a,
    int *__restrict__ out, int N, int Q, int T, int o_del, int e_del,
    int o_ins, int e_ins, int zdrop, int a, int b) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int task = blockIdx.x * kWarps + warp;
  if (task >= N) return;  // warp-uniform

  const int Q1 = Q + 1;
  int *sq = smem + warp * 4 * Q1;  // query codes [Q]
  int *eh = sq + Q1;               // eh_h [Q+1]: H(i-1, j-1)
  int *ee = eh + Q1;               // eh_e [Q+1]
  int *hr = ee + Q1;               // H(i, j) of the current row [Q]
  const int K = (Q1 + 31) / 32;
  const int c0 = min(lane * K, Q1);
  const int c1 = min(c0 + K, Q1);
  const int cq1 = min(c1, Q);      // column range [c0, cq1) of the DP row

  const int qlen = qlen_a[task], tlen = tlen_a[task], h0 = h0_a[task];
  const int eb = eb_a[task];
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const int max_sc = max(a, max(-b, -1));
  // band clip [bwa: the max_ins/max_del adjustment]; floor division as in
  // the plain version (after the max(., 1) clamp it equals bwa's double
  // math, and C++ truncation would too)
  const int max_ins = max(floordiv(qlen * max_sc + eb - o_ins, e_ins) + 1, 1);
  const int max_del = max(floordiv(qlen * max_sc + eb - o_del, e_del) + 1, 1);
  const int w = min(min(w_a[task], max_ins), max_del);

  const int *qrow = query + (size_t)task * Q;
  const int *trow = target + (size_t)task * T;
  for (int j = c0; j < c1; ++j) {
    const int v = j == 0 ? h0 : max(h0 - o_ins - e_ins * j, 0);
    eh[j] = j <= qlen ? v : 0;
    ee[j] = 0;
    if (j < Q) sq[j] = min(max(qrow[j], 0), 4);
  }
  __syncwarp();

  int beg = 0, end = qlen, mx = h0, max_i = -1, max_j = -1, max_ie = -1;
  int gscore = -1, max_off = 0;
  bool done = valid_a[task] == 0 || qlen <= 0 || tlen <= 0;

  for (int i = 0; !done && i < tlen; ++i) {
    const int bg = max(beg, i - w);
    const int en = min(min(end, i + w + 1), qlen);
    const int tc = clamp_code(trow[min(i, T - 1)]);

    // pass 1: the lane's max of A over its in-band columns
    int amax = INT_MIN / 2;
    for (int j = max(c0, bg); j < min(cq1, en); ++j) {
      const int mp = eh[j];
      const int m = mp != 0 ? mp + score_plain(tc, sq[j], a, b) : 0;
      amax = max(amax, max(m - oe_ins, 0) + e_ins * j);
    }
    int incl = amax;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = max(incl, v);
    }
    int carry = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) carry = INT_MIN / 2;

    // pass 2: F, H, next E (in place), lane row max and last argmax
    int lm = 0, lj = -1;
    for (int j = max(c0, bg); j < min(cq1, en); ++j) {
      const int mp = eh[j];
      const int m = mp != 0 ? mp + score_plain(tc, sq[j], a, b) : 0;
      const int e = ee[j];
      const int f = j > bg ? max(carry - e_ins * (j - 1), 0) : 0;
      carry = max(carry, max(m - oe_ins, 0) + e_ins * j);
      const int h = max(max(m, e), f);
      hr[j] = h;
      ee[j] = max(max(m - oe_del, 0), e - e_del);
      if (h > lm) {
        lm = h;
        lj = j;
      } else if (h == lm && h > 0) {
        lj = j;
      }
    }
    __syncwarp();
    const int mm = warp_max_xor(lm);
    const int mj = warp_max_xor(lm == mm && mm > 0 ? lj : -1);
    const int h1_init =
        bg == 0 ? max(h0 - (o_del + e_del * (i + 1)), 0) : 0;
    const int h1_last = en > bg ? hr[en - 1] : h1_init;

    // pass 3: index-shifted eh_h write-back, eh_e[end] = 0
    for (int j = c0; j < c1; ++j) {
      if (j >= bg && j <= en) eh[j] = j == bg ? h1_init : hr[j - 1];
      if (j == en) ee[j] = 0;
    }
    __syncwarp();

    // live-band shrink over the updated eh in [beg, end]
    int lo = INT_MAX;
    for (int j = max(c0, bg); j < min(c1, en); ++j)
      if (eh[j] != 0 || ee[j] != 0) lo = min(lo, j);
    const int beg2 = min(warp_min_xor(lo), en);
    int hi = -1;
    for (int j = max(c0, beg2); j < min(c1, en + 1); ++j)
      if (eh[j] != 0 || ee[j] != 0) hi = max(hi, j);
    hi = warp_max_xor(hi);
    const int last_live = hi >= 0 ? hi : beg2 - 1;
    const int end2 = min(last_live + 2, qlen);

    // to-query-end score; ksw tie rule: max_ie updates when h1 >= gscore
    if (en == qlen) {
      if (h1_last >= gscore) max_ie = i;
      gscore = max(gscore, h1_last);
    }
    // break / max update / z-drop [exact ksw_extend2 order]
    bool done_now = mm == 0;
    if (mm > mx) {
      max_off = max(max_off, abs(mj - i));
      mx = mm;
      max_i = i;
      max_j = mj;
    } else if (zdrop > 0) {
      const int di = i - max_i, dj = mj - max_j;
      const int pen = di > dj ? (di - dj) * e_del : (dj - di) * e_ins;
      if (mx - mm - pen > zdrop) done_now = true;
    }
    beg = beg2;
    end = end2;
    done = done || done_now;
    __syncwarp();
  }

  if (lane == 0) {
    int *o = out + (size_t)task * 6;
    o[0] = mx;
    o[1] = max_j + 1;
    o[2] = max_i + 1;
    o[3] = max_ie + 1;
    o[4] = gscore;
    o[5] = max_off;
  }
}

template <int K>
int launch_reg(const int *query, const int *qlen, const int *target,
               const int *tlen, const int *h0, const int *w,
               const int *end_bonus, const int *valid, int *out, int N, int Q,
               int T, int o_del, int e_del, int o_ins, int e_ins, int zdrop,
               int a, int b, cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  ksw_extend_reg_kernel<K><<<blocks, 32 * kWarps, 0, stream>>>(
      query, qlen, target, tlen, h0, w, end_bonus, valid, out, N, Q, T, o_del,
      e_del, o_ins, e_ins, zdrop, a, b);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. All pointers are device pointers to
// contiguous int32 arrays: query (N, Q), qlen, target (N, T), tlen, h0, w,
// end_bonus, valid (N,), out (N, 6). `instance` is the number of columns a
// lane owns in the register kernel (1..9, with Q <= 32 * instance) or 0
// for the generic shared-memory kernel. Launches on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for an instance
// that cannot hold Q); does not synchronise.
extern "C" int ksw_extend_launch(const int *query, const int *qlen,
                                 const int *target, const int *tlen,
                                 const int *h0, const int *w,
                                 const int *end_bonus, const int *valid,
                                 int *out, int N, int Q, int T, int o_del,
                                 int e_del, int o_ins, int e_ins, int zdrop,
                                 int a, int b, int instance, void *stream) {
  if (N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (instance < 0 || instance > kMaxK ||
      (instance > 0 && Q > 32 * instance))
    return (int)cudaErrorInvalidValue;
#define KSW_REG(KK)                                                         \
  case KK:                                                                  \
    return launch_reg<KK>(query, qlen, target, tlen, h0, w, end_bonus,      \
                          valid, out, N, Q, T, o_del, e_del, o_ins, e_ins,  \
                          zdrop, a, b, s);
  switch (instance) {
    KSW_REG(1) KSW_REG(2) KSW_REG(3) KSW_REG(4) KSW_REG(5) KSW_REG(6)
    KSW_REG(7) KSW_REG(8) KSW_REG(9)
    default:
      break;
  }
#undef KSW_REG
  const size_t smem = (size_t)kWarps * 4 * (Q + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ksw_extend_generic_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  ksw_extend_generic_kernel<<<blocks, 32 * kWarps, smem, s>>>(
      query, qlen, target, tlen, h0, w, end_bonus, valid, out, N, Q, T, o_del,
      e_del, o_ins, e_ins, zdrop, a, b);
  return (int)cudaGetLastError();
}
