// Kernel C: scipy find_peaks greedy distance suppression, one block per clip.
//
// Replaces tpu_breath/ops/pallas/peaks_kernel.py::suppress_peaks_pallas (its
// pallas_call at :78; XLA twin: ops/peaks.py find_peaks_stats fast path).
// Input: candidate scores [B, n] (envelope height at local maxima >= height,
// -inf elsewhere). Each of `rounds` rounds takes the clip's maximum (ties ->
// lowest index), records it, and masks |pos - idx| < distance. Every kept
// peak of scipy's greedy pass is such a round's argmax, so rounds =
// n // distance + 2 is exact. A round with nothing left records 0 and not
// kept; a NaN score anywhere in a clip leaves every round of it empty, as
// the plain version and the Pallas kernel give (their maximum is NaN).
//
// What bounds it on the H100: bytes, the 64 KB score row of a clip read
// once (8.2 MB at B = 128: 2.4 us at 3.35 TB/s). Only a few hundred to a few
// thousand of a row's 16,000 scores are candidates (8,000 at most, one
// every other sample), and the rounds are a chain of dependent argmaxes, so
// what is left after the read is latency. The design:
// - The row is read once, compacted. Each of 1,024 threads keeps 4 16-byte
//   loads in flight; a warp scan of each load's candidate count and one
//   scan of the 128 (load, warp) totals place every candidate in shared
//   memory in index order, as (key, index): the key is the value as an
//   unsigned integer in the same order, so that a warp's argmax is two warp
//   reductions (__reduce_max_sync of the keys, __reduce_min_sync of the
//   positions holding the max); five steps of 64-bit shuffles measured
//   slower. No atomics: the list's order is fixed.
// - A round reads only what the last window changed. The list is cut into
//   32 runs, one a warp, and each warp keeps its run's best (key, position)
//   in registers and in a table of 32, and its run's first and last index.
//   A round reduces the table (every warp at once, so no barrier); only the
//   warps whose run's index span meets the window |index - idx| < distance
//   mask their candidates in it and re-scan their run. The table is
//   double-buffered: one barrier a round. The runs' spans tell each warp in
//   two compares whether a window touches it; the first version of this
//   kernel found the window by two warp-wide binary searches in the list
//   instead, with shuffle reductions, and measured slower (PERF.md).
//   A tournament tree was not taken: updating it after a window is a chain
//   of log2(list) dependent levels, one barrier each (or one warp walking
//   them), where the runs re-scan side by side on their own warps. 32 runs
//   rather than 16 halve a touched run's re-scan (the dense worst case).
// - The rounds stop at the first one that finds nothing; the rest are
//   written as empty.
// The list takes 8 bytes a score at most. Up to kSmemSamples scores a row it
// lives in dynamic shared memory, raised once per device, not at every
// launch; past that the same code keeps it in a scratch buffer in device
// memory that the caller allocates (8 bytes a score, a row's own part for
// each block), chosen before the launch from n. A block reads back only its
// own part, after a barrier; the rest of the code is the same.
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "smem_once.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                     // 16-byte loads a thread a pass
constexpr int kPass = kPer * 4 * kThreads;  // 16,384 scores a pass
constexpr int kNoPos = 0x7fffffff;
constexpr int kSmemSamples = 28000;  // 224,000 bytes of list, under 227 KB
static_assert(kPer * kWarps == 4 * 32, "one warp scans the totals, 4 a lane");

// A float's key: unsigned, in the float's order; -0 is +0.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = v == 0.0f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// -inf's key: a masked candidate; a key at or below it is nothing
constexpr unsigned kMasked = 0x007fffffu;

// The warp's largest key and, among its equals, the lowest position, in
// every lane: two warp reductions.
__device__ __forceinline__ void warp_best(unsigned& key, int& pos) {
  const unsigned k = __reduce_max_sync(0xffffffffu, key);
  pos = static_cast<int>(__reduce_min_sync(
      0xffffffffu, key == k ? static_cast<unsigned>(pos) : 0xffffffffu));
  key = k;
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// kGlobal: the list in `scratch` ([B, 2n] words, the row's part at
// blockIdx.x * 2n) instead of dynamic shared memory.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads, 1)
suppress_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                unsigned char* __restrict__ kept, unsigned* scratch, int n,
                int distance, int rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* ck;  // [n] candidate keys
  int* ci;       // [n] their indices
  if constexpr (kGlobal) {
    ck = scratch + 2 * static_cast<size_t>(blockIdx.x) * n;
    ci = reinterpret_cast<int*>(ck + n);
  } else {
    ck = reinterpret_cast<unsigned*>(smem);
    ci = reinterpret_cast<int*>(smem + 4 * static_cast<size_t>(n));
  }
  __shared__ int tot[kPer * kWarps];  // per (load, warp): count, then offset
  __shared__ int pass_count;
  __shared__ unsigned tab_k[2][kWarps];  // each run's best, double-buffered
  __shared__ int tab_p[2][kWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = scores + static_cast<size_t>(blockIdx.x) * n;
  float* out_v = vals + static_cast<size_t>(blockIdx.x) * rounds;
  unsigned char* out_k = kept + static_cast<size_t>(blockIdx.x) * rounds;
  const bool vec = (n & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(scores) & 15) == 0;

  // 1. compaction: scores in the order (pass, load k, warp, lane, 4)
  int m = 0;
  int nan = 0;
  for (int p0 = 0; p0 < n; p0 += kPass) {
    float x[kPer][4];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {  // every load in flight at once
      const int e = p0 + 4 * (k * kThreads + threadIdx.x);
      if (vec && e < n) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(row + e));
        x[k][0] = q.x; x[k][1] = q.y; x[k][2] = q.z; x[k][3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[k][j] = e + j < n ? row[e + j] : -CUDART_INF_F;
        }
      }
    }
    int excl[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nan |= isnan(x[k][j]);
        cnt += x[k][j] > -CUDART_INF_F;
      }
      const int incl = warp_incl_scan(cnt);
      excl[k] = incl - cnt;
      if (lane == 31) tot[k * kWarps + warp] = incl;
    }
    __syncthreads();
    if (warp == 0) {  // the totals' exclusive offsets, in (load, warp) order
      int t[4], s = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) { t[j] = tot[4 * lane + j]; s += t[j]; }
      const int incl = warp_incl_scan(s);
      int run = incl - s;
#pragma unroll
      for (int j = 0; j < 4; ++j) { tot[4 * lane + j] = run; run += t[j]; }
      if (lane == 31) pass_count = incl;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = p0 + 4 * (k * kThreads + threadIdx.x);
      int o = m + tot[k * kWarps + warp] + excl[k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (x[k][j] > -CUDART_INF_F) {
          ck[o] = order_key(x[k][j]);
          ci[o] = e + j;
          ++o;
        }
      }
    }
    m += pass_count;
    nan = __syncthreads_or(nan);  // tot and pass_count are read; the list is
  }                               // complete
  if (nan) m = 0;

  // 2. the rounds: warp w owns the list's run [a, e), indices [lo, hi]
  const int len = (m + kWarps - 1) / kWarps;
  const int a = min(warp * len, m), e = min(a + len, m);
  const int lo = a < e ? ci[a] : 0, hi = a < e ? ci[e - 1] : -1;
  unsigned wk = 0;
  int wp = kNoPos;
  for (int j = a + lane; j < e; j += 32) {
    const unsigned k = ck[j];
    if (k > wk) { wk = k; wp = j; }
  }
  warp_best(wk, wp);
  if (lane == 0) { tab_k[0][warp] = wk; tab_p[0][warp] = wp; }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    const int buf = r & 1;
    unsigned bk = lane < kWarps ? tab_k[buf][lane] : 0u;
    int bp = lane < kWarps ? tab_p[buf][lane] : kNoPos;
    warp_best(bk, bp);  // positions follow indices: ties -> lowest index
    if (bk <= kMasked) {  // nothing left: this round and the rest
      for (int q = r + threadIdx.x; q < rounds; q += kThreads) {
        out_v[q] = 0.0f;
        out_k[q] = 0;
      }
      break;
    }
    if (threadIdx.x == 0) { out_v[r] = key_value(bk); out_k[r] = 1; }
    const int idx = ci[bp];
    if (a < e && lo < idx + distance && hi > idx - distance) {
      // the window |index - idx| < distance meets this run: mask, re-scan
      wk = 0;
      wp = kNoPos;
      for (int j = a + lane; j < e; j += 32) {
        unsigned k = ck[j];
        if (k > kMasked && abs(ci[j] - idx) < distance) {
          k = kMasked;
          ck[j] = k;
        }
        if (k > wk) { wk = k; wp = j; }
      }
      warp_best(wk, wp);
    }
    if (lane == 0) { tab_k[buf ^ 1][warp] = wk; tab_p[buf ^ 1][warp] = wp; }
    __syncthreads();
  }
}

int g_smem[smem_once::kMaxDevices];

}  // namespace

// kept: one byte a round (a torch.bool tensor), 1 where a peak was kept.
// scratch: null for n <= kSmemSamples, else [b, 2n] 4-byte words.
extern "C" int suppress_peaks_launch(const float* scores, float* vals,
                                     unsigned char* kept, unsigned* scratch,
                                     int b, int n, int distance, int rounds,
                                     void* stream) {
  if (n < 1 || distance < 1 || rounds < 0 ||
      (n > kSmemSamples) != (scratch != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch != nullptr) {
    if (b == 0 || rounds == 0) return 0;
    suppress_kernel<true><<<b, kThreads, 0, s>>>(scores, vals, kept, scratch,
                                                 n, distance, rounds);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = 8 * n;
  const cudaError_t err = smem_once::raise(
      reinterpret_cast<const void*>(suppress_kernel<false>), smem, g_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || rounds == 0) return 0;
  suppress_kernel<false><<<b, kThreads, smem, s>>>(scores, vals, kept,
                                                   nullptr, n, distance,
                                                   rounds);
  return static_cast<int>(cudaGetLastError());
}
