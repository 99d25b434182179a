// The gammatone channel's epilogue for one clip, shared by kernels B, B'
// (epilogue_kernel.cu) and B'' (gammatone_kernel.cu):
//   out[g, t] = znorm(f32(log1p(sum_f fb[g, f] * mag[f, t])))
// over the whole [G, T] clip, by one thread block. The z-score's mean and
// variance are float64 sums of the f32 values, each rounded to f32 once.
#pragma once
#include <cuda_runtime.h>

namespace gt_epilogue {

__device__ __forceinline__ double block_sum(double v, double* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double w = lane < (blockDim.x >> 5) ? scratch[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1) w += __shfl_down_sync(0xffffffffu, w, off);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  const double total = scratch[32];
  __syncthreads();
  return total;
}

// smag [F * T] (shared, f-major), fb [G, F] (global), sval [G * T] shared
// scratch, dst [G * T] (global). scratch holds 33 doubles. kF32 selects the
// native-f32 variant (f32 FMA chain, log1pf); otherwise the product
// accumulates in float64 and log1p is rounded once. blockDim.x must be a
// multiple of 32, at most 1024.
template <bool kF32>
__device__ __forceinline__ void epilogue_clip(const float* smag,
                                              const float* __restrict__ fb,
                                              float* sval, float* dst, int F,
                                              int T, int G, double* scratch) {
  const int gt = G * T;
  double part = 0.0;
  for (int o = threadIdx.x; o < gt; o += blockDim.x) {
    const int g = o / T, t = o - g * T;
    const float* row = fb + static_cast<size_t>(g) * F;
    float v;
    if (kF32) {
      float acc = 0.0f;
      for (int f = 0; f < F; ++f) acc = fmaf(__ldg(row + f), smag[f * T + t], acc);
      v = log1pf(acc);
    } else {
      double acc = 0.0;
      for (int f = 0; f < F; ++f) {
        acc = fma(static_cast<double>(__ldg(row + f)),
                  static_cast<double>(smag[f * T + t]), acc);
      }
      v = __double2float_rn(log1p(acc));
    }
    sval[o] = v;
    part += v;
  }
  const float mean = __double2float_rn(block_sum(part, scratch) / gt);

  part = 0.0;
  for (int o = threadIdx.x; o < gt; o += blockDim.x) {
    const float d = __fsub_rn(sval[o], mean);
    part += static_cast<double>(d) * d;
  }
  const float var = __double2float_rn(block_sum(part, scratch) / gt);
  const float denom = __fadd_rn(__fsqrt_rn(var), 1e-8f);

  for (int o = threadIdx.x; o < gt; o += blockDim.x) {
    dst[o] = __fdiv_rn(__fsub_rn(sval[o], mean), denom);
  }
}

}  // namespace gt_epilogue
