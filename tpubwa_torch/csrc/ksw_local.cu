// Batched unbanded local Smith-Waterman on Hopper (sm_90a): the forward
// pass of ksw_align, run by mate rescue over every predicted window.
//
// Replaces the reference's ops/sw_pallas.py::_local_kernel (entry
// ksw_local_pallas), the TPU kernel of the mate-rescue stage. Computes exact
// native/ksw.cpp::local_fwd semantics: score a / -b, -1 against N; H floored
// at 0; the first column of each row maximum; the earliest row of the
// global maximum; with want_sub the sub-optimal score from bwa's run
// tracking over the per-row maxima. The plain PyTorch version it is held to
// is ops/sw_local.py::ksw_local_ref.
//
// What bounds it: operations by the roofline (a 150 bp task against a
// 640-base window reads ~3 KB and does 20 int32 operations in each of
// ~96,000 cells), but a rescue batch has a few hundred tasks, far fewer
// than the card has warp slots: a launch lasts as long as its longest task,
// tlen rows one after another. So its time is launch cost plus tlen x (the
// latency of one row), and the design is about the dependent chain of a row.
//
// Design (register instances, template parameters K = ceil(Q / 32) and
// want_sub): one warp per task, four tasks per block. The task's own qlen
// columns are split over the 32 lanes in contiguous chunks of
// Kt = ceil(qlen / 32) <= K, so a short query (the start-extraction pass
// aligns prefixes) still spreads over the warp; a lane's chunk of H, E and
// the query codes lives in registers, the loops over it are fully unrolled
// and the lane's column count nk is a predicate. Per row:
//   base       a shuffle from a register (one load a lane every 32 rows);
//   diagonal   H(i-1, c0-1) is the previous lane's last H, one __shfl_up;
//   pass 1     each cell once: G = max(Hdiag + S, E, 0) in one DPX
//              instruction, A(j) = G - oe_ins + e_ins*j and the lane's own
//              exclusive running maximum of A, all kept in registers;
//   scan       one exclusive max-scan over the lanes' maxima (four
//              independent shuffles, then three doubling steps) gives each
//              lane the carry of the insertion chain F;
//   pass 2     H = max(G, carry - e_ins*(j-1)) (G >= 0 absorbs F's floor),
//              E' = max(H - oe_del, E - e_del, 0), the lane's maximum; no
//              chain inside the lane;
//   reduce     one redux.sync for the row maximum; only a row that beats
//              the best so far (strictly, so the earliest row wins) looks
//              for the FIRST column reaching it and pays a second one.
// Registers past nk hold columns that do not exist. They are never read by
// a real column (F and the diagonal only flow towards higher columns), an
// offset of kNeg keeps them out of the lane's A maximum, and they copy the
// H to their left, which keeps them out of the row maximum and leaves the
// lane's last real H in its last register, where the next lane's shuffle
// finds it.
// The loop is software-pipelined: base, diagonal, pass 1 and scan of row
// i + 1 only read row i's H and E, so they are issued between row i's
// reduction and the test that consumes it.
// With want_sub the row maxima are gathered 32 rows at a time in a register
// of lane i & 31 and written to a global-memory workspace (T ints a task,
// allocated by the wrapper) as one coalesced store; after the DP the warp
// replays the run tracking over them (it needs the final te, so it cannot
// be folded into the DP loop), reading them back 32 rows at a time, each
// lane the rows it stored itself, and skipping a chunk in which no row
// reaches minsc. No shared memory grows with T, so every rescue window
// launches (pestat's widest at max_ins, about 40 kbp, included).
//
// Queries too long for the largest register instance (Q > 32 * kMaxK) take
// the generic instance: the same function with H, E, G and the query in
// shared memory and two passes a cell. The instance is chosen by shape
// (ops/sw_local.py::kernel_instance), never by failure.
#include "ksw_common.cuh"

namespace {

using namespace ksw;

constexpr int kMaxK = 8;       // largest register instance: Q <= 256

// Run tracking over the stored row maxima [local_fwd's b list]: a run's
// position is the row of its last max update, adjacency is tested against
// that row, and a finished run counts only outside [te - qlen, te + qlen].
// Warp-uniform: the rows come in 32 at a time, lane L reading row c + L,
// which it stored itself (store_rowmax), and go through the tracking one
// by one as shuffles; a row below minsc changes nothing, so a chunk with
// none at minsc or above is skipped.
__device__ __forceinline__ void replay_runs(const int *rowmax, int tn, int te,
                                            int qlen, int minsc, int lane,
                                            int &score2, int &te2) {
  const int lo = te - qlen, hi = te + qlen;
  int bf = 0, bs = -2;
  for (int c = 0; c < tn; c += 32) {
    const int v = c + lane < tn ? rowmax[c + lane] : kNeg;
    if (!__any_sync(kFull, v >= minsc)) continue;
    const int n = min(32, tn - c);
    for (int r = 0; r < n; ++r) {
      const int im = __shfl_sync(kFull, v, r);
      const int i = c + r;
      if (im < minsc) continue;
      if (bs + 1 != i) {
        if (bs >= 0 && (bs < lo || bs > hi) && bf > score2) {
          score2 = bf;
          te2 = bs;
        }
        bf = im;
        bs = i;
      } else if (im > bf) {
        bf = im;
        bs = i;
      }
    }
  }
  if (bs >= 0 && (bs < lo || bs > hi) && bf > score2) {
    score2 = bf;
    te2 = bs;
  }
}

// Keeps row i's maximum mm (warp-uniform) for the replay: lane i & 31
// holds it in rm until the chunk of 32 rows is full, then the warp writes
// the chunk to rowmax[i - 31 ..= i] in one coalesced store.
__device__ __forceinline__ void store_rowmax(int *rowmax, int i, int lane,
                                             int mm, int &rm) {
  if (lane == (i & 31)) rm = mm;
  if ((i & 31) == 31) rowmax[i - 31 + lane] = rm;
}

// After the row loop: the rows of the last, part chunk.
__device__ __forceinline__ void flush_rowmax(int *rowmax, int tn, int lane,
                                             int rm) {
  const int base = tn & ~31;
  if (base + lane < tn) rowmax[base + lane] = rm;
  __syncwarp();
}

// The head of a row: the target base, the diagonal input of the lane's
// first column (the previous lane's last H, which its register K - 1
// holds), G and the insertion term A of each cell once, the lane's
// exclusive running maximum of A (px) and, by one scan over the lanes, the
// carry of the insertion chain F into the lane. Reads H and E of the row
// above and writes neither.
template <int K>
__device__ __forceinline__ int row_head(
    int i, int lane, int tn, const int *__restrict__ trow, int &tchunk,
    const int (&H)[K], const int (&E)[K], const int (&qq)[K],
    const int (&mis)[K], const int (&aoff)[K], int a, int (&g)[K],
    int (&px)[K]) {
  if ((i & 31) == 0) tchunk = i + lane < tn ? clamp_code(trow[i + lane]) : 4;
  const RowBase tb = row_base(__shfl_sync(kFull, tchunk, i & 31));
  int hd = __shfl_up_sync(kFull, H[K - 1], 1);
  if (lane == 0) hd = 0;
  int run = kNeg;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    g[k] = addmax_relu(hd, score(tb, qq[k], mis[k], a), E[k]);
    hd = H[k];
    px[k] = run;
    run = max(run, g[k] + aoff[k]);
  }
  return warp_excl_max(run, lane);
}

template <int K, bool kWantSub>
__global__ void __launch_bounds__(32 * kWarps) ksw_local_reg_kernel(
    const int *__restrict__ query, const int *__restrict__ qlen_a,
    const int *__restrict__ target, const int *__restrict__ tlen_a,
    const int *__restrict__ minsc_a, const int *__restrict__ valid_a,
    int *__restrict__ out, int *ws, int N, int Q, int T, int o_del,
    int e_del, int o_ins, int e_ins, int a, int b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int task = blockIdx.x * kWarps + warp;
  if (task >= N) return;  // warp-uniform
  int *rowmax = kWantSub ? ws + (size_t)task * T : nullptr;  // [T]

  const int qlen = qlen_a[task], tlen = tlen_a[task];
  const int qn = min(max(qlen, 0), Q);          // columns really aligned
  const int tn = valid_a[task] != 0 && qn > 0 ? min(max(tlen, 0), T) : 0;
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;

  const int Kt = (qn + 31) / 32;                // <= K: qn <= Q <= 32 * K
  const int c0 = min(lane * Kt, qn);
  const int nk = min(c0 + Kt, qn) - c0;         // this lane's columns
  const int *qrow = query + (size_t)task * Q;
  const int *trow = target + (size_t)task * T;
  int H[K];                                     // H(i-1, c0 + k)
  int E[K];
  int qq[K];                                    // query codes
  int mis[K];                                   // score against another base
  int aoff[K];                                  // A(j) - G(j), kNeg past nk
#pragma unroll
  for (int k = 0; k < K; ++k) {
    H[k] = 0;
    E[k] = 0;
    qq[k] = k < nk ? clamp_code(qrow[c0 + k]) : 4;
    mis[k] = qq[k] > 3 ? -1 : -b;
    aoff[k] = k < nk ? e_ins * (c0 + k) - oe_ins : kNeg;
  }

  int best = 0, te = -1, qe = -1;
  int tchunk = 4;
  int rm = 0;        // row maximum of row (i & ~31) + lane, want_sub only
  int g[K], px[K];   // G and the lane's running maximum of A
  int carry = row_head<K>(0, lane, tn, trow, tchunk, H, E, qq, mis, aoff, a,
                          g, px);
  // The row loop is software-pipelined: a row's tail (H, E', the row
  // maximum's reduction) is followed by the head of the NEXT row, which
  // only reads H and E, and only then is the reduction consumed: its
  // latency hides behind the head.
  for (int i = 0; i < tn; ++i) {
    // tail: H, next E, the lane's row maximum. A register past nk copies
    // the H to its left, so register K - 1 ends as the lane's last real H
    // and the lane maximum needs no predicate.
    int lm = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = c0 + k;
      const int h = addmax(max(carry, px[k]), -e_ins * (j - 1), g[k]);
      H[k] = k < nk ? h : (k > 0 ? H[k > 0 ? k - 1 : 0] : 0);
      E[k] = addmax_relu(H[k], -oe_del, E[k] - e_del);
      lm = max(lm, H[k]);
    }
    const int mm = warp_max(lm);
    carry = row_head<K>(i + 1, lane, tn, trow, tchunk, H, E, qq, mis, aoff, a,
                        g, px);
    if (mm > best) {  // strictly greater: the earliest row wins
      best = mm;
      te = i;
      // the FIRST column that reaches it: the lane's lowest (k descends,
      // the last write wins), then the lowest over the lanes
      int lj = INT_MAX;
#pragma unroll
      for (int k = K - 1; k >= 0; --k)
        if (k < nk && H[k] == mm) lj = c0 + k;
      qe = warp_min(lj);
    }
    if (kWantSub) store_rowmax(rowmax, i, lane, mm, rm);
  }

  int score2 = 0, te2 = -1;
  if (kWantSub) {
    flush_rowmax(rowmax, tn, lane, rm);
    replay_runs(rowmax, tn, te, qlen, minsc_a[task], lane, score2, te2);
  }

  if (lane == 0) {
    int *o = out + (size_t)task * 5;
    o[0] = best;
    o[1] = te;
    o[2] = qe;
    o[3] = score2;
    o[4] = te2;
  }
}

// The generic instance: any Q whose rows fit a block's shared memory. Each
// lane keeps its chunk of the query codes and of the H, E and G rows in
// shared memory at slot k*32 + lane (only it touches them: no bank
// conflicts, no barrier in the row loop); two passes a cell, butterfly
// reductions; the row maxima go to the workspace as in the register
// instances.
template <bool kWantSub>
__global__ void ksw_local_generic_kernel(
    const int *__restrict__ query, const int *__restrict__ qlen_a,
    const int *__restrict__ target, const int *__restrict__ tlen_a,
    const int *__restrict__ minsc_a, const int *__restrict__ valid_a,
    int *__restrict__ out, int *ws, int N, int Q, int T, int o_del,
    int e_del, int o_ins, int e_ins, int a, int b) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int task = blockIdx.x * kWarps + warp;
  if (task >= N) return;  // warp-uniform

  const int KQ = (Q + 31) / 32;                 // slots per lane at full Q
  int *sq = smem + warp * 4 * 32 * KQ;          // query codes
  int *sh = sq + 32 * KQ;                       // H(i-1, .) then H(i, .)
  int *se = sh + 32 * KQ;                       // E
  int *sg = se + 32 * KQ;                       // G of the current row
  int *rowmax = kWantSub ? ws + (size_t)task * T : nullptr;  // [T]

  const int qlen = qlen_a[task], tlen = tlen_a[task];
  const int qn = min(max(qlen, 0), Q);          // columns really aligned
  const int tn = valid_a[task] != 0 && qn > 0 ? min(max(tlen, 0), T) : 0;
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;

  const int K = (qn + 31) / 32;
  const int c0 = min(lane * K, qn);
  const int nk = min(c0 + K, qn) - c0;          // this lane's columns
  const int *qrow = query + (size_t)task * Q;
  const int *trow = target + (size_t)task * T;
  for (int k = 0; k < nk; ++k) {
    sq[k * 32 + lane] = clamp_code(qrow[c0 + k]);
    sh[k * 32 + lane] = 0;
    se[k * 32 + lane] = 0;
  }

  int best = 0, te = -1, qe = -1;
  int hlast = 0;     // H(i-1, c0+K-1): the next lane's diagonal input
  int tchunk = 4;
  int rm = 0;        // row maximum of row (i & ~31) + lane, want_sub only
  for (int i = 0; i < tn; ++i) {
    if ((i & 31) == 0) tchunk = i + lane < tn ? clamp_code(trow[i + lane]) : 4;
    const int tc = __shfl_sync(kFull, tchunk, i & 31);
    int hd = __shfl_up_sync(kFull, hlast, 1);
    if (lane == 0) hd = 0;

    // pass 1: G over the chunk, the lane's max of A
    int amax = kNeg;
    for (int k = 0; k < nk; ++k) {
      const int s = k * 32 + lane;
      const int qc = sq[s];
      const int sc = (tc > 3 || qc > 3) ? -1 : (tc == qc ? a : -b);
      const int g = max(max(hd + sc, 0), se[s]);
      hd = sh[s];
      sg[s] = g;
      amax = max(amax, g - oe_ins + e_ins * (c0 + k));
    }
    int incl = amax;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = max(incl, v);
    }
    int carry = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) carry = kNeg;

    // pass 2: F, H, next E, lane row max with its first column
    int lm = 0, lj = INT_MAX, h = 0;
    for (int k = 0; k < nk; ++k) {
      const int s = k * 32 + lane, j = c0 + k;
      const int g = sg[s];
      const int f = max(carry - e_ins * (j - 1), 0);
      carry = max(carry, g - oe_ins + e_ins * j);
      h = max(g, f);
      sh[s] = h;
      se[s] = max(max(se[s] - e_del, h - oe_del), 0);
      if (h > lm) {
        lm = h;
        lj = j;
      }
    }
    hlast = nk == K ? h : 0;
    const int mm = warp_max_xor(lm);
    if (mm > best) {  // strictly greater: the earliest row wins
      best = mm;
      te = i;
      qe = warp_min_xor(lm == mm ? lj : INT_MAX);
    }
    if (kWantSub) store_rowmax(rowmax, i, lane, mm, rm);
  }

  int score2 = 0, te2 = -1;
  if (kWantSub) {
    flush_rowmax(rowmax, tn, lane, rm);
    replay_runs(rowmax, tn, te, qlen, minsc_a[task], lane, score2, te2);
  }

  if (lane == 0) {
    int *o = out + (size_t)task * 5;
    o[0] = best;
    o[1] = te;
    o[2] = qe;
    o[3] = score2;
    o[4] = te2;
  }
}

template <int K, bool kWantSub>
int launch_reg(const int *query, const int *qlen, const int *target,
               const int *tlen, const int *minsc, const int *valid, int *out,
               int *ws, int N, int Q, int T, int o_del, int e_del, int o_ins,
               int e_ins, int a, int b, cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  ksw_local_reg_kernel<K, kWantSub><<<blocks, 32 * kWarps, 0, stream>>>(
      query, qlen, target, tlen, minsc, valid, out, ws, N, Q, T, o_del,
      e_del, o_ins, e_ins, a, b);
  return (int)cudaGetLastError();
}

template <bool kWantSub>
int launch_generic(const int *query, const int *qlen, const int *target,
                   const int *tlen, const int *minsc, const int *valid,
                   int *out, int *ws, int N, int Q, int T, int o_del,
                   int e_del, int o_ins, int e_ins, int a, int b,
                   cudaStream_t stream) {
  const int KQ = (Q + 31) / 32;
  const size_t smem = (size_t)kWarps * 4 * 32 * KQ * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ksw_local_generic_kernel<kWantSub>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  ksw_local_generic_kernel<kWantSub><<<blocks, 32 * kWarps, smem, stream>>>(
      query, qlen, target, tlen, minsc, valid, out, ws, N, Q, T, o_del,
      e_del, o_ins, e_ins, a, b);
  return (int)cudaGetLastError();
}

template <bool kWantSub>
int dispatch(int instance, const int *query, const int *qlen,
             const int *target, const int *tlen, const int *minsc,
             const int *valid, int *out, int *ws, int N, int Q, int T,
             int o_del, int e_del, int o_ins, int e_ins, int a, int b,
             cudaStream_t stream) {
#define KSW_REG(KK)                                                          \
  case KK:                                                                   \
    return launch_reg<KK, kWantSub>(query, qlen, target, tlen, minsc, valid, \
                                    out, ws, N, Q, T, o_del, e_del, o_ins,   \
                                    e_ins, a, b, stream);
  switch (instance) {
    KSW_REG(1) KSW_REG(2) KSW_REG(3) KSW_REG(4) KSW_REG(5) KSW_REG(6)
    KSW_REG(7) KSW_REG(8)
    default:
      break;
  }
#undef KSW_REG
  return launch_generic<kWantSub>(query, qlen, target, tlen, minsc, valid,
                                  out, ws, N, Q, T, o_del, e_del, o_ins,
                                  e_ins, a, b, stream);
}

}  // namespace

// Plain C entry point for ctypes. All pointers are device pointers to
// contiguous int32 arrays: query (N, Q), qlen, target (N, T), tlen, minsc,
// valid (N,), out (N, 5), and with want_sub the workspace ws (N, T) of the
// row maxima (unused, and may be null, without). want_sub picks the
// template instance; `instance` is K of the register kernel (1..8, with
// Q <= 32 * instance) or 0 for the generic shared-memory kernel. Launches
// on `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for an instance that cannot hold Q or a missing
// workspace); does not synchronise.
extern "C" int ksw_local_launch(const int *query, const int *qlen,
                                const int *target, const int *tlen,
                                const int *minsc, const int *valid, int *out,
                                int *ws, int N, int Q, int T, int o_del,
                                int e_del, int o_ins, int e_ins, int a, int b,
                                int want_sub, int instance, void *stream) {
  if (N <= 0) return 0;
  if (instance < 0 || instance > kMaxK ||
      (instance > 0 && Q > 32 * instance) || (want_sub && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  return want_sub ? dispatch<true>(instance, query, qlen, target, tlen, minsc,
                                   valid, out, ws, N, Q, T, o_del, e_del,
                                   o_ins, e_ins, a, b, (cudaStream_t)stream)
                  : dispatch<false>(instance, query, qlen, target, tlen,
                                    minsc, valid, out, ws, N, Q, T, o_del,
                                    e_del, o_ins, e_ins, a, b,
                                    (cudaStream_t)stream);
}
