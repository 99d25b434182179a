// scipy find_peaks greedy distance suppression, one block per clip.
//
// Replaces tpu_breath/ops/pallas/peaks_kernel.py::suppress_peaks_pallas (XLA
// twin: ops/peaks.py find_peaks_stats fast path). Input: candidate scores
// [B, n] (envelope height at local maxima >= height, -inf elsewhere). Each of
// `rounds` rounds takes the clip's maximum (ties -> lowest index), records
// it, and masks |pos - idx| < distance to -inf. Every kept peak of scipy's
// greedy pass is such a round's argmax, so rounds = n // distance + 2 is
// exact.
//
// What bounds it: the 64 KB score row is read once from device memory into
// shared memory; each round is one block-wide argmax over shared memory (two
// __syncthreads) plus a window store of 2*distance-1 elements. 12 rounds of
// 16k-element reductions: latency-bound, a few microseconds per clip.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
suppress_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                unsigned char* __restrict__ kept, int n, int distance,
                int rounds) {
  extern __shared__ float s[];  // [n]
  __shared__ float wv[32];
  __shared__ int wi[32];
  __shared__ float best_v;
  __shared__ int best_i;

  const float* src = scores + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < rounds; ++r) {
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float v = s[i];
      if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { wv[warp] = bv; wi[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      const bool live = lane < (blockDim.x >> 5);
      bv = live ? wv[lane] : -CUDART_INF_F;
      bi = live ? wi[lane] : 0x7fffffff;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) { best_v = bv; best_i = bi; }
    }
    __syncthreads();
    const float m = best_v;
    const int idx = best_i;
    const bool take = m > -CUDART_INF_F;
    if (threadIdx.x == 0) {
      const size_t o = static_cast<size_t>(blockIdx.x) * rounds + r;
      vals[o] = take ? m : 0.0f;
      kept[o] = take ? 1 : 0;
    }
    if (take) {
      const int lo = max(idx - distance + 1, 0);
      const int hi = min(idx + distance, n);  // exclusive
      for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) s[i] = -CUDART_INF_F;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int suppress_peaks_launch(const float* scores, float* vals,
                                     unsigned char* kept, int b, int n,
                                     int distance, int rounds, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  suppress_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      scores, vals, kept, n, distance, rounds);
  return static_cast<int>(cudaGetLastError());
}
