// Gammatone-channel epilogue, one block per clip:
//   out = znorm(f32(log1p(fb @ mag)))   over the whole [G, T] clip.
//
// Replaces tpu_breath/ops/pallas/epilogue_kernel.py::fused_epilogue (its
// default double-float variant; same math as the XLA branch
// features.py:137-141, dd.matmul_dd + dd.log1p_cr + znorm). The TPU kernel
// carried the product in two_sum chains because the TPU has no float64; here
// the [G, F] x [F, T] product accumulates in native float64, log1p runs in
// float64 and is rounded once. The z-score divides by a std of ~0.005 on
// quiet clips, which is why f32 accumulation is not enough.
//
// What bounds it: per clip 2*G*F*T = 2.1 MFLOP of float64 FMA (the H100 does
// float64 at ~1/2 of its float32 CUDA-core rate) on 65 KB of magnitudes
// staged once in shared memory; fb (66 KB, shared by every clip) is read
// through L1/L2. At 8..128 clips the grid fills at most 128 of 132 SMs, so
// the kernel is latency- and FP64-bound, never bandwidth-bound.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
epilogue_kernel(const float* __restrict__ mag,  // [B, F, T]
                const float* __restrict__ fb,   // [G, F]
                float* __restrict__ out,        // [B, G, T]
                int F, int T, int G) {
  extern __shared__ float smem[];
  float* smag = smem;           // [F * T]
  float* sval = smem + F * T;   // [G * T]
  __shared__ double scratch[33];

  const int ft = F * T, gt = G * T;
  const float* m = mag + static_cast<size_t>(blockIdx.x) * ft;
  for (int i = threadIdx.x; i < ft; i += blockDim.x) smag[i] = m[i];
  __syncthreads();

  double part = 0.0;
  for (int o = threadIdx.x; o < gt; o += blockDim.x) {
    const int g = o / T, t = o - g * T;
    const float* row = fb + static_cast<size_t>(g) * F;
    double acc = 0.0;
    for (int f = 0; f < F; ++f) {
      acc = fma(static_cast<double>(__ldg(row + f)),
                static_cast<double>(smag[f * T + t]), acc);
    }
    const float v = __double2float_rn(log1p(acc));
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

  float* dst = out + static_cast<size_t>(blockIdx.x) * gt;
  for (int o = threadIdx.x; o < gt; o += blockDim.x) {
    dst[o] = __fdiv_rn(__fsub_rn(sval[o], mean), denom);
  }
}

}  // namespace

extern "C" int fused_epilogue_launch(const float* mag, const float* fb,
                                     float* out, int b, int F, int T, int G,
                                     void* stream) {
  const size_t smem = static_cast<size_t>(F * T + G * T) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  epilogue_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mag, fb, out, F, T, G);
  return static_cast<int>(cudaGetLastError());
}
