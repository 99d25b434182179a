// The whole gammatone channel, one block per clip:
//   S[t, f]  = | sum_k frames[t, k] * basis[k, f] + i * basis[k, F + f] |
//   out      = znorm(f32(log1p(fb @ f32(S))))          [G, T]
//
// Replaces tpu_breath/ops/pallas/epilogue_kernel.py::fused_gammatone (its
// _gammatone_kernel, :78-102): frames -> double-float real DFT -> |S| ->
// double-float filterbank GEMM -> log1p_cr -> z-score. The TPU kernel
// emulated float64 with two_sum chains over 8-wide slices; here both
// products accumulate in native float64, |S| is taken in float64 and rounded
// to f32 once, and the filterbank product, log1p and z-score are the shared
// epilogue of kernel B (gt_epilogue.cuh).
//
// What bounds it: per clip 2*T*K*2F = 33 MFLOP of float64 FMA for the DFT
// (+ 2.1 MFLOP for the filterbank), against 129 KB of frames in and 16 KB
// out; the 1 MB window-folded basis is shared by every clip and read
// through L2. It is FP64-bound: one block per clip computes the whole
// clip's z-score without a second pass, and at 8..128 clips fills at most
// 128 of 132 SMs.
//
// Design: the block walks the clip in groups of kTT = 16 frames. Each group
// is staged in shared memory as float64, k-major (64 KB), so each float is
// converted once per clip and each thread reads its 16 frame values for a
// given k as consecutive doubles. Thread f keeps the 16 frames' re/im sums
// in registers and reads basis[k, f] and basis[k, F + f] from global
// memory once per group (coalesced over f), so the basis is read T/16 = 4
// times per clip instead of T times. |S| of the whole clip (65 KB) stays in
// shared memory for the epilogue.
#include <cuda_runtime.h>

#include "gt_epilogue.cuh"

namespace {

constexpr int kThreads = 288;  // 9 warps: F = 257 frequencies in one pass
constexpr int kTT = 16;        // frames per register tile

__global__ void __launch_bounds__(kThreads)
gammatone_kernel(const float* __restrict__ frames,  // [B, T, K]
                 const float* __restrict__ basis,   // [K, 2F]
                 const float* __restrict__ fb,      // [G, F]
                 float* __restrict__ out,           // [B, G, T]
                 int T, int K, int F, int G) {
  extern __shared__ double smem_d[];
  double* sfr = smem_d;                                      // [K * kTT]
  float* smag = reinterpret_cast<float*>(smem_d + K * kTT);  // [F * T]
  float* sval = smag + F * T;                                // [G * T]
  __shared__ double scratch[33];

  const float* fr = frames + static_cast<size_t>(blockIdx.x) * T * K;
  const size_t row = 2 * static_cast<size_t>(F);
  for (int t0 = 0; t0 < T; t0 += kTT) {
    const int nt = min(kTT, T - t0);
    for (int i = threadIdx.x; i < K * kTT; i += blockDim.x) {
      const int j = i / K, k = i - j * K;  // coalesced over k
      sfr[k * kTT + j] =
          j < nt ? static_cast<double>(fr[static_cast<size_t>(t0 + j) * K + k])
                 : 0.0;
    }
    __syncthreads();
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      double re[kTT], im[kTT];
#pragma unroll
      for (int j = 0; j < kTT; ++j) re[j] = im[j] = 0.0;
      const float* b = basis + f;
      for (int k = 0; k < K; ++k) {
        const double br = static_cast<double>(__ldg(b + k * row));
        const double bi = static_cast<double>(__ldg(b + k * row + F));
        const double* x = sfr + k * kTT;
#pragma unroll
        for (int j = 0; j < kTT; ++j) {
          re[j] = fma(x[j], br, re[j]);
          im[j] = fma(x[j], bi, im[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kTT; ++j) {
        if (j < nt) {
          const double p = __dadd_rn(__dmul_rn(re[j], re[j]),
                                     __dmul_rn(im[j], im[j]));
          smag[f * T + t0 + j] = __double2float_rn(__dsqrt_rn(p));
        }
      }
    }
    __syncthreads();
  }
  gt_epilogue::epilogue_clip<false>(
      smag, fb, sval, out + static_cast<size_t>(blockIdx.x) * G * T, F, T, G,
      scratch);
}

}  // namespace

extern "C" int fused_gammatone_launch(const float* frames, const float* basis,
                                      const float* fb, float* out, int b,
                                      int T, int K, int F, int G,
                                      void* stream) {
  const size_t smem = static_cast<size_t>(K) * kTT * sizeof(double) +
                      static_cast<size_t>(F * T + G * T) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gammatone_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  gammatone_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, basis, fb, out, T, K, F, G);
  return static_cast<int>(cudaGetLastError());
}
