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
// take the generic instance: the same function with the live band of the
// rows in a ring in shared memory, sized by the band and not by Q, so any
// width launches (three passes a row over the band). The instance is
// chosen by shape (ops/sw.py::kernel_instance), never by failure.
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

// The generic instance: any Q. ksw_extend2 reads and writes row i only in
// the columns [bg, en] of its band, inside [i - w, i + w + 1]; bg never
// falls and a column is first read with the value the first row gave it.
// So the warp keeps the live part of its rows (query codes, eh_h, eh_e and
// the current DP row H(i, .)) in a ring of P columns in shared memory,
// column j in slot j & (P - 1), with P a power of two at least 2w + 2: the
// columns one row touches are at most 2w + 2 apart, and a column written at
// row k and read again at row i > k is at most 2w + 1 from any column
// written between (all lie in [k - w, i + w + 1] with the read one at or
// above i - w and at or below k + w + 1). A column that enters the band for
// the first time (above `hiw`, the highest column filled so far) is filled
// with the first row's value, h0 - o_ins - e_ins * j clamped at 0 (h0 at
// column 0), eh_e 0 and its query code. The block's shared memory depends
// on the band, not on Q (min(P, Q + 1) columns: below P no column wraps).
// Each row: the band's DP columns [bg, en) are split over the 32 lanes in
// contiguous chunks; pass 1 takes each lane's maximum of the insertion term
// A, one exclusive scan over the lanes gives each lane its F carry, pass 2
// computes F, H and E' in place, pass 3 writes ksw's index-shifted eh_h
// over [bg, en] and finds the live band's first and last entry on the way.
// A task whose band passes the ring (a w above the w_max the launch was
// sized for) writes INT_MIN into its six outputs.
__global__ void __launch_bounds__(32 * kWarps) ksw_extend_ring_kernel(
    const int *__restrict__ query, const int *__restrict__ qlen_a,
    const int *__restrict__ target, const int *__restrict__ tlen_a,
    const int *__restrict__ h0_a, const int *__restrict__ w_a,
    const int *__restrict__ eb_a, const int *__restrict__ valid_a,
    int *__restrict__ out, int N, int Q, int T, int P, int o_del, int e_del,
    int o_ins, int e_ins, int zdrop, int a, int b) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int task = blockIdx.x * kWarps + warp;
  if (task >= N) return;  // warp-uniform

  const int R = min(P, Q + 1);     // slots a row of the ring holds
  const int mask = P - 1;
  int *sq = smem + warp * 4 * R;   // query code of column j
  int *eh = sq + R;                // eh_h[j]: H(i-1, j-1)
  int *ee = eh + R;                // eh_e[j]
  int *hr = ee + R;                // H(i, j) of the current row

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
  int *o = out + (size_t)task * 6;
  if (P < Q + 1 && 2 * w + 2 > P) {
    if (lane < 6) o[lane] = INT_MIN;
    return;
  }

  const int *qrow = query + (size_t)task * Q;
  const int *trow = target + (size_t)task * T;
  int beg = 0, end = qlen, mx = h0, max_i = -1, max_j = -1, max_ie = -1;
  int gscore = -1, max_off = 0;
  int hiw = -1;                    // the highest column filled so far
  int tchunk = 4;
  bool done = valid_a[task] == 0 || qlen <= 0 || tlen <= 0 || T <= 0;

  for (int i = 0; !done && i < tlen; ++i) {
    const int bg = max(beg, i - w);
    const int en = min(min(end, i + w + 1), qlen);
    if ((i & 31) == 0) tchunk = load_bases(trow, i, lane, T);
    const int tc = __shfl_sync(kFull, tchunk, i & 31);

    // columns entering the band for the first time (en <= qlen <= Q)
    for (int j = max(hiw + 1, bg) + lane; j <= en; j += 32) {
      const int s = j & mask;
      eh[s] = j == 0 ? h0 : max(h0 - o_ins - e_ins * j, 0);
      ee[s] = 0;
      sq[s] = j < Q ? clamp_code(qrow[j]) : 4;
    }
    hiw = max(hiw, en);
    __syncwarp();

    // the lane's chunk [c0, c1) of the band's DP columns [bg, en)
    const int kc = (max(en - bg, 0) + 31) >> 5;
    const int c0 = bg + lane * kc;
    const int c1 = min(c0 + kc, en);

    // pass 1: the lane's maximum of A over its chunk
    int amax = kNeg;
    for (int j = c0; j < c1; ++j) {
      const int s = j & mask;
      const int mp = eh[s];
      const int m = mp != 0 ? mp + score_plain(tc, sq[s], a, b) : 0;
      amax = max(amax, max(m - oe_ins, 0) + e_ins * j);
    }
    int carry = warp_excl_max(amax, lane);

    // pass 2: F, H, next E (in place), lane row max and its last column
    int lm = 0, lj = -1;
    for (int j = c0; j < c1; ++j) {
      const int s = j & mask;
      const int mp = eh[s];
      const int m = mp != 0 ? mp + score_plain(tc, sq[s], a, b) : 0;
      const int e = ee[s];
      const int f = j > bg ? max(carry - e_ins * (j - 1), 0) : 0;
      carry = max(carry, max(m - oe_ins, 0) + e_ins * j);
      const int h = max3(m, e, f);
      hr[s] = h;
      ee[s] = max(max(m - oe_del, 0), e - e_del);
      if (h > lm || (h == lm && h > 0)) {
        lm = h;
        lj = j;
      }
    }
    __syncwarp();
    const int mm = warp_max(lm);
    const int mj = warp_max(lm == mm && mm > 0 ? lj : -1);
    const int h1_init =
        bg == 0 ? max(h0 - (o_del + e_del * (i + 1)), 0) : 0;
    const int h1_last = en > bg ? hr[(en - 1) & mask] : h1_init;

    // pass 3: index-shifted eh_h write-back over [bg, en], eh_e[en] = 0,
    // and the live band over the updated entries: the first live entry of
    // [bg, en) and the last of [bg, en] (the plain version's second scan
    // of [beg2, en] gives the same: see the register instances)
    int lo = INT_MAX, hi = -1;
    const int k3 = (max(en - bg + 1, 0) + 31) >> 5;
    const int d0 = bg + lane * k3;
    const int d1 = min(d0 + k3, en + 1);
    for (int j = d0; j < d1; ++j) {
      const int s = j & mask;
      const int v = j == bg ? h1_init : hr[(j - 1) & mask];
      eh[s] = v;
      int e = 0;
      if (j == en)
        ee[s] = 0;
      else
        e = ee[s];
      if (v != 0 || e != 0) {
        if (j < en) lo = min(lo, j);
        hi = j;
      }
    }
    const int beg2 = min(warp_min(lo), en);
    const int hi_w = warp_max(hi);
    const int last_live = max(hi_w >= beg2 ? hi_w : beg2 - 1, -1);
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
    done = done_now;
    __syncwarp();
  }

  if (lane == 0) {
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
// for the generic ring kernel, whose ring holds `ring` columns (a power of
// two, at least 2w + 2 for every task's w; ops/sw.py::ring_cols) and whose
// block takes kWarps * 4 * min(ring, Q + 1) ints of shared memory. Launches
// on `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for an instance that cannot hold Q or a ring that
// is not a power of two); does not synchronise.
extern "C" int ksw_extend_launch(const int *query, const int *qlen,
                                 const int *target, const int *tlen,
                                 const int *h0, const int *w,
                                 const int *end_bonus, const int *valid,
                                 int *out, int N, int Q, int T, int o_del,
                                 int e_del, int o_ins, int e_ins, int zdrop,
                                 int a, int b, int instance, int ring,
                                 void *stream) {
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
  if (ring < 2 || (ring & (ring - 1)) != 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)kWarps * 4 * (size_t)min(ring, Q + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ksw_extend_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  ksw_extend_ring_kernel<<<blocks, 32 * kWarps, smem, s>>>(
      query, qlen, target, tlen, h0, w, end_bonus, valid, out, N, Q, T, ring,
      o_del, e_del, o_ins, e_ins, zdrop, a, b);
  return (int)cudaGetLastError();
}
