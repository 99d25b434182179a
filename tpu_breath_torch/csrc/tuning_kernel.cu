// Tuning-estimate tail (librosa estimate_tuning after piptrack), one block
// per clip.
//
// Replaces tpu_breath/ops/pallas/tuning_kernel.py::estimate_tuning_index_pallas
// (and its XLA twin ops/chroma.py::estimate_tuning_index). Per clip:
//   1. masked median of mags where pitch > 0: exact rank select by a 32-step
//      bit descent over order-preserving u32 keys, both middle ranks per pass;
//   2. sel = pitch > 0 && mag >= median;
//   3. residual = mod(bpo * f32(log2(f32(pitch / 27.5))), 1) in [-0.5, 0.5),
//      the divide and log2 in float64 rounded once to f32 (correctly rounded,
//      which is what the TPU's double-float dd.div_cr / dd.log2_cr emulate);
//   4. 100-bin histogram against np.histogram's exact f32 edges, first-max
//      argmax, 50 when nothing is selected.
//
// What bounds it: ~16k (pitch, mag) pairs per clip (126 KB) are read once
// from device memory into shared memory; the 32 descent passes and the
// histogram pass then read shared memory only, so the kernel is bound by
// the 32 block-wide reductions (one __syncthreads round trip each), not by
// bytes. One block per clip gives 8..128 blocks on 132 SMs at the serving
// batch sizes; more clips per block would not help until B >> 132.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBins = 100;

__device__ __forceinline__ uint32_t ordered_u32(float x) {
  int32_t b = __float_as_int(x);
  return static_cast<uint32_t>(b < 0 ? ~b : (b ^ INT32_MIN));
}

__device__ __forceinline__ float u32_f32(uint32_t u) {
  int32_t i = static_cast<int32_t>(u);
  return __int_as_float(i < 0 ? (i ^ INT32_MIN) : ~i);
}

// Sum of two ints over the block; every thread gets the totals.
__device__ __forceinline__ int2 block_sum2(int2 v, int2* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, off);
    v.y += __shfl_down_sync(0xffffffffu, v.y, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int2 w = lane < (blockDim.x >> 5) ? scratch[lane] : make_int2(0, 0);
    for (int off = 16; off > 0; off >>= 1) {
      w.x += __shfl_down_sync(0xffffffffu, w.x, off);
      w.y += __shfl_down_sync(0xffffffffu, w.y, off);
    }
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  int2 total = scratch[32];
  __syncthreads();  // scratch is reused by the next call
  return total;
}

__global__ void __launch_bounds__(kThreads)
tuning_tail_kernel(const float* __restrict__ pitches,
                   const float* __restrict__ mags,
                   const float* __restrict__ edges,  // [kBins + 1]
                   int* __restrict__ out, int n, float bpo) {
  extern __shared__ uint32_t smem[];
  uint32_t* keys = smem;                                  // [n]
  float* pit = reinterpret_cast<float*>(smem + n);        // [n]
  __shared__ int2 scratch[33];
  __shared__ int hist[kBins];
  __shared__ float sedges[kBins + 1];

  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  int k_local = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float p = pitches[base + i];
    const float m = mags[base + i];
    const bool valid = p > 0.0f;
    pit[i] = p;
    keys[i] = ordered_u32(valid ? m : __int_as_float(0x7f800000));
    k_local += valid;
  }
  for (int i = threadIdx.x; i <= kBins; i += blockDim.x) sedges[i] = edges[i];
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist[i] = 0;
  const int k = block_sum2(make_int2(k_local, 0), scratch).x;

  // exact order statistics: ranks (k-1)//2 and k//2 of the masked keys
  const int rank_lo = k > 0 ? (k - 1) / 2 : 0;
  const int rank_hi = k / 2;
  uint32_t p_lo = 0, p_hi = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t c_lo = p_lo | (1u << bit), c_hi = p_hi | (1u << bit);
    int2 below = make_int2(0, 0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t key = keys[i];
      below.x += key < c_lo;
      below.y += key < c_hi;
    }
    below = block_sum2(below, scratch);
    if (below.x <= rank_lo) p_lo = c_lo;
    if (below.y <= rank_hi) p_hi = c_hi;
  }
  const float thresh =
      k > 0 ? __fmul_rn(0.5f, __fadd_rn(u32_f32(p_lo), u32_f32(p_hi))) : 0.0f;

  int sel_local = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float p = pit[i];
    if (!(p > 0.0f) || !(u32_f32(keys[i]) >= thresh)) continue;
    ++sel_local;
    const float q = __double2float_rn(__ddiv_rn(static_cast<double>(p), 27.5));
    const float octs = __double2float_rn(log2(static_cast<double>(q)));
    float r = fmodf(__fmul_rn(bpo, octs), 1.0f);  // exact, sign of dividend
    if (r != 0.0f && r < 0.0f) r = __fadd_rn(r, 1.0f);  // jnp.mod: sign of 1
    if (r >= 0.5f) r = __fsub_rn(r, 1.0f);
    if (!(r >= sedges[0]) || !(r < sedges[kBins])) continue;
    int lo = 0, hi = kBins;  // edges[lo] <= r < edges[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (r >= sedges[mid]) lo = mid; else hi = mid;
    }
    atomicAdd(&hist[lo], 1);
  }
  const int n_sel = block_sum2(make_int2(sel_local, 0), scratch).x;
  if (threadIdx.x == 0) {
    int best = 0, best_count = -1;
    for (int b = 0; b < kBins; ++b) {
      if (hist[b] > best_count) { best_count = hist[b]; best = b; }
    }
    out[blockIdx.x] = n_sel > 0 ? best : kBins / 2;
  }
}

}  // namespace

extern "C" int tuning_index_launch(const float* pitches, const float* mags,
                                   const float* edges, int* out, int b, int n,
                                   int bpo, void* stream) {
  const size_t smem = static_cast<size_t>(n) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      tuning_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  tuning_tail_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pitches, mags, edges, out, n, static_cast<float>(bpo));
  return static_cast<int>(cudaGetLastError());
}
