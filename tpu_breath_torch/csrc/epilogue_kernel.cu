// Gammatone-channel epilogue, one block per clip:
//   out = znorm(f32(log1p(fb @ mag)))   over the whole [G, T] clip.
//
// Replaces tpu_breath/ops/pallas/epilogue_kernel.py::fused_epilogue in both
// of its variants:
//  - B, the default double-float variant (same math as the XLA branch
//    features.py:137-141, dd.matmul_dd + dd.log1p_cr + znorm). The TPU
//    kernel carried the product in two_sum chains because the TPU has no
//    float64; here the [G, F] x [F, T] product accumulates in native float64,
//    log1p runs in float64 and is rounded once. The z-score divides by a std
//    of ~0.005 on quiet clips, which is why f32 accumulation is not enough.
//  - B', plain=True (epilogue_kernel.py:69-72): an f32 FMA chain and log1pf,
//    the like-for-like partner of a plain f32 GEMM + log1p.
// Both take the z-score's mean and variance as float64 sums (gt_epilogue.cuh).
//
// What bounds it: per clip 2*G*F*T = 2.1 MFLOP (float64 for B, at half the
// card's f32 CUDA-core rate; f32 for B') on 65 KB of magnitudes staged once
// in shared memory; fb (66 KB, shared by every clip) is read through L1/L2.
// At 8..128 clips the grid fills at most 128 of 132 SMs, so the kernel is
// latency- and FMA-bound, never bandwidth-bound.
#include <cuda_runtime.h>

#include "gt_epilogue.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kF32>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(const float* __restrict__ mag,  // [B, F, T]
                const float* __restrict__ fb,   // [G, F]
                float* __restrict__ out,        // [B, G, T]
                int F, int T, int G) {
  extern __shared__ float smem[];
  float* smag = smem;           // [F * T]
  float* sval = smem + F * T;   // [G * T]
  __shared__ double scratch[33];

  const int ft = F * T;
  const float* m = mag + static_cast<size_t>(blockIdx.x) * ft;
  for (int i = threadIdx.x; i < ft; i += blockDim.x) smag[i] = m[i];
  __syncthreads();
  gt_epilogue::epilogue_clip<kF32>(
      smag, fb, sval, out + static_cast<size_t>(blockIdx.x) * G * T, F, T, G,
      scratch);
}

template <bool kF32>
int launch(const float* mag, const float* fb, float* out, int b, int F,
           int T, int G, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(F * T + G * T) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      epilogue_kernel<kF32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  epilogue_kernel<kF32><<<b, kThreads, smem, stream>>>(mag, fb, out, F, T, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_epilogue_launch(const float* mag, const float* fb,
                                     float* out, int b, int F, int T, int G,
                                     int f32, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<true>(mag, fb, out, b, F, T, G, s)
             : launch<false>(mag, fb, out, b, F, T, G, s);
}
