// Device code shared by the two alignment kernels (ksw_extend.cu,
// ksw_local.cu): launch geometry, the bwa score of one cell, the warp-wide
// running maximum of the insertion chain, one-instruction warp reductions
// and Hopper's DPX instructions for the max-plus steps of the recurrences.
#pragma once
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace ksw {

constexpr int kWarps = 4;              // tasks (warps) per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = INT_MIN / 2;      // "no value" of a running maximum

__device__ __forceinline__ int clamp_code(int c) { return min(max(c, 0), 4); }

// DPX [CUDA 12; one instruction each on sm_90]: three-way maxima and
// add-then-max, the steps of an affine-gap recurrence. KSW_NO_DPX builds
// the same functions from plain max() for a side-by-side timing.
#if !defined(KSW_NO_DPX) && CUDART_VERSION >= 12000
__device__ __forceinline__ int max3(int a, int b, int c) {
  return __vimax3_s32(a, b, c);
}
// max(a + b, c)
__device__ __forceinline__ int addmax(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);
}
// max(a + b, c, 0)
__device__ __forceinline__ int addmax_relu(int a, int b, int c) {
  return __viaddmax_s32_relu(a, b, c);
}
#else
__device__ __forceinline__ int max3(int a, int b, int c) {
  return max(max(a, b), c);
}
__device__ __forceinline__ int addmax(int a, int b, int c) {
  return max(a + b, c);
}
__device__ __forceinline__ int addmax_relu(int a, int b, int c) {
  return max(max(a + b, c), 0);
}
#endif

// The target base of one DP row, prepared once a row so that a cell's score
// is a compare and two selects: `code` is the base, or 7 (equal to no query
// code) when the base is an N, and then every cell of the row scores -1.
struct RowBase {
  int code;
  bool is_n;
};

__device__ __forceinline__ RowBase row_base(int tc) {
  RowBase r;
  r.is_n = tc > 3;
  r.code = r.is_n ? 7 : tc;
  return r;
}

// Score of query code qc against the row's base [bwa 5x5 matrix: match a,
// mismatch -b, anything against N -1]; mis is the lane's precomputed
// (qc > 3 ? -1 : -b).
__device__ __forceinline__ int score(RowBase t, int qc, int mis, int a) {
  return qc == t.code ? a : (t.is_n ? -1 : mis);
}

// Exclusive running maximum across the warp: lane L gets the maximum of v
// over the lanes below it, kNeg for lane 0. A doubling scan is six
// dependent shuffles (one to make it exclusive, five to double); here four
// independent shuffles fetch the four lanes below, then three doubling
// steps (by 4, 8, 16) whose low lanes keep their own value, which max
// ignores: four shuffle latencies in a row instead of six.
__device__ __forceinline__ int warp_excl_max(int v, int lane) {
  int s[4];
#pragma unroll
  for (int d = 1; d <= 4; ++d) {
    const int t = __shfl_up_sync(kFull, v, d);
    s[d - 1] = lane >= d ? t : kNeg;
  }
  int x = max(max3(s[0], s[1], s[2]), s[3]);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) x = max(x, __shfl_up_sync(kFull, x, o));
  return x;
}

// Warp reductions in one instruction each (redux.sync, sm_80 and later).
__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(kFull, v);
}
__device__ __forceinline__ int warp_min(int v) {
  return __reduce_min_sync(kFull, v);
}

// Butterfly reductions of K2's generic (shared-memory) instance.
__device__ __forceinline__ int warp_max_xor(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ int warp_min_xor(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Every 32 rows each lane loads one target base; the row's base is then a
// shuffle, not a global load at the head of the row's dependent chain.
// Index clamped to T - 1 as in the plain versions.
__device__ __forceinline__ int load_bases(const int *__restrict__ trow, int i,
                                          int lane, int T) {
  return clamp_code(trow[min(i + lane, T - 1)]);
}

}  // namespace ksw
