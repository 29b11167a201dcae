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
// Design: one warp per task, four tasks per block. The task's qlen query
// columns are split across the 32 lanes in contiguous chunks of
// K = ceil(qlen/32), so a short query (the start-extraction pass aligns
// prefixes) still spreads over the warp. Each lane keeps its chunk of the
// query codes and of the H, E and G rows in shared memory at slot
// k*32 + lane: a lane only ever touches its own slots, so there are no bank
// conflicts and no warp barriers in the row loop. What crosses lanes goes
// through shuffles:
//   diagonal   H(i-1, c0-1) of a lane's first column is the previous lane's
//              last H, handed over with one __shfl_up;
//   pass 1     each lane: G(j) = max(max(Hdiag + S, 0), E(j)) over its
//              chunk and the lane maximum of A(j) = G(j) - oe_ins + e_ins*j;
//              a __shfl_up max-scan gives each lane the exclusive carry of
//              the insertion chain F;
//   pass 2     each lane walks its chunk in order: F from the carry, H, the
//              next E, its row maximum with the FIRST column reaching it;
//   reduce     warp max of the lane maxima, then warp min of the columns
//              of the lanes that hold it (chunks are ordered, so the lowest
//              column is the first).
// The target base of row i comes from a register: every 32 rows each lane
// loads one base and the row's base is broadcast with a shuffle. Each
// warp's loop ends at its own tlen; no task waits for a longer one.
// With want_sub (a template parameter) lane 0 stores each row maximum in
// shared memory (T ints per task) and, after the DP, every lane replays the
// run tracking over them (warp-uniform, no divergence); it needs the final
// te, so it cannot be folded into the DP loop.
//
// Bound: operations, not bytes. A 150 bp task against a 640-base window
// reads ~3 KB and does 20 int32 operations in each of ~96,000 cells. This
// first version favours a simple, checkable layout over speed: every cell
// is touched in two passes and its state lives in shared memory, not in
// registers.
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int kWarps = 4;              // tasks per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = INT_MIN / 2;

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int clamp_code(int c) { return min(max(c, 0), 4); }

template <bool kWantSub>
__global__ void ksw_local_kernel(
    const int *__restrict__ query, const int *__restrict__ qlen_a,
    const int *__restrict__ target, const int *__restrict__ tlen_a,
    const int *__restrict__ minsc_a, const int *__restrict__ valid_a,
    int *__restrict__ out, int N, int Q, int T, int o_del, int e_del,
    int o_ins, int e_ins, int a, int b) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int task = blockIdx.x * kWarps + warp;
  if (task >= N) return;  // warp-uniform

  const int KQ = (Q + 31) / 32;                 // slots per lane at full Q
  const int per_warp = 4 * 32 * KQ + (kWantSub ? T : 0);
  int *sq = smem + warp * per_warp;             // query codes
  int *sh = sq + 32 * KQ;                       // H(i-1, .) then H(i, .)
  int *se = sh + 32 * KQ;                       // E
  int *sg = se + 32 * KQ;                       // G of the current row
  int *rowmax = sg + 32 * KQ;                   // [T], want_sub only

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
    const int mm = warp_max(lm);
    if (mm > best) {  // strictly greater: the earliest row wins
      best = mm;
      te = i;
      qe = warp_min(lm == mm ? lj : INT_MAX);
    }
    if (kWantSub && lane == 0) rowmax[i] = mm;
  }

  int score2 = 0, te2 = -1;
  if (kWantSub) {
    __syncwarp();
    // run tracking [local_fwd's b list]: a run's position is the row of
    // its last max update, adjacency is tested against that row, and a
    // finished run counts only outside [te - qlen, te + qlen]
    const int minsc = minsc_a[task];
    const int lo = te - qlen, hi = te + qlen;
    int bf = 0, bs = -2;
    for (int i = 0; i < tn; ++i) {
      const int im = rowmax[i];
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
    if (bs >= 0 && (bs < lo || bs > hi) && bf > score2) {
      score2 = bf;
      te2 = bs;
    }
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

template <bool kWantSub>
int launch(const int *query, const int *qlen, const int *target,
           const int *tlen, const int *minsc, const int *valid, int *out,
           int N, int Q, int T, int o_del, int e_del, int o_ins, int e_ins,
           int a, int b, cudaStream_t stream) {
  const int KQ = (Q + 31) / 32;
  const size_t smem =
      (size_t)kWarps * (4 * 32 * KQ + (kWantSub ? T : 0)) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ksw_local_kernel<kWantSub>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  ksw_local_kernel<kWantSub><<<blocks, 32 * kWarps, smem, stream>>>(
      query, qlen, target, tlen, minsc, valid, out, N, Q, T, o_del, e_del,
      o_ins, e_ins, a, b);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. All pointers are device pointers to
// contiguous int32 arrays: query (N, Q), qlen, target (N, T), tlen, minsc,
// valid (N,), out (N, 5). want_sub picks the template instance. Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
extern "C" int ksw_local_launch(const int *query, const int *qlen,
                                const int *target, const int *tlen,
                                const int *minsc, const int *valid, int *out,
                                int N, int Q, int T, int o_del, int e_del,
                                int o_ins, int e_ins, int a, int b,
                                int want_sub, void *stream) {
  if (N <= 0) return 0;
  return want_sub ? launch<true>(query, qlen, target, tlen, minsc, valid, out,
                                 N, Q, T, o_del, e_del, o_ins, e_ins, a, b,
                                 (cudaStream_t)stream)
                  : launch<false>(query, qlen, target, tlen, minsc, valid,
                                  out, N, Q, T, o_del, e_del, o_ins, e_ins, a,
                                  b, (cudaStream_t)stream);
}
