// Gammatone-channel epilogue, one block per clip:
//   out = znorm(f32(log1p(fb @ mag)))   over the whole [G, T] clip.
//
// Replaces tpu_breath/ops/pallas/epilogue_kernel.py::fused_epilogue (its
// pallas_call at :160) in both of its variants:
//  - B, the default double-float variant (same math as the XLA branch
//    features.py:137-141, dd.matmul_dd + dd.log1p_cr + znorm). The TPU
//    kernel carried the product in two_sum chains because the TPU has no
//    float64; here the [G, F] x [F, T] product accumulates in native float64,
//    log1p runs in float64 and is rounded once. The z-score divides by a std
//    of ~0.005 on quiet clips, which is why f32 accumulation is not enough.
//  - B', plain=True (epilogue_kernel.py:69-72): an f32 FMA chain and log1pf,
//    the like-for-like partner of a plain f32 GEMM + log1p at HIGHEST
//    precision (no TF32, no tensor cores).
// Both take the z-score's mean and variance as float64 sums in tile order
// (gt_epilogue.cuh, znorm_tiles).
//
// What bounds B on the H100: per clip 2 * G * F * T = 2.1 MFLOP of float64
// (2.2 MFLOP with the padding) against 130 KB in (65 KB of magnitudes, fb's
// 66 KB shared by every clip and read from L2) and 16 KB out: operations,
// at the 67 TFLOP/s of the float64 tensor cores. Its design is the
// epilogue of kernel B'' with |S| read from memory (gt_epilogue.cuh,
// fb_znorm_tiles, shared by both): a clip's magnitudes come by cp.async of
// 4 bytes (a clip's rows of 63 floats are not 16-byte aligned) into the
// f-major |S| layout, padded with zeros to 264 frequencies and 64 frames,
// and fb into rows padded with zeros; the product is 32 output tiles of
// 16 x 8 on DMMA (33 k-steps each, 1,056 DMMAs a clip), 2 tiles a warp on
// 16 warps sharing their A fragments; the z-score's sums go in tile order,
// so a clip's bits depend neither on B nor on its place in the batch. One
// clip is ~4 us of DMMA on one SM at the peak rate, so at B <= 132 the
// kernel is latency bound: one wave, each SM one clip. Measured on the
// card (PERF.md): the staging takes ~5 us of a call, log1p in float64
// ~3 us, the DMMAs at most ~1 us. Tried and not kept: |S| widened to
// float64 in shared memory (no faster); 16-byte loads of fb and |S| into
// registers in place of the 4-byte cp.async (slower); a cluster of 2
// blocks a clip, each half the frames (faster at B = 8, slower at
// B = 128, where every block stages all of fb).
//
// A clip past one block's tiles (T > 64 frames, F > 264 frequencies or
// G > 64 bands; the main path's clips are 63 x 257 -> 64) takes a second
// instantiation (kRanges), chosen on the host, so the main path keeps its
// code: the block walks the clip's outputs in tiles of 64 bands x 64
// frames, each tile's product summed over staged ranges of 264
// frequencies, with the log1p values kept in `out` and the z-score's sums
// carried in tile order; a second pass reads them back for the variance
// and a third normalises them in place (gt_epilogue.cuh, fb_znorm_ranges).
//
// B' is the same kernel with the product on the CUDA cores
// (fb_znorm_tiles_f32): per clip 2 * G * F * T = 2.1 MFLOP of f32, again
// operations-bound on paper (67 TFLOP/s) and latency-bound in fact, one
// clip an SM. The staging, the 16 warps and their tiles are B's; each lane
// runs the 8 f32 FMA chains of its accumulator fragment (2 bands by 4
// frames) side by side, f = 0 .. F - 1 in order and then the zero padding,
// so each output's bits are those of one serial chain; four steps of f
// read 2 x 4 fb values by 16-byte loads and 8 pairs of |S| values from
// shared memory (broadcast, conflict-free) for 32 FMAs. Measured on the
// card (PERF.md): ~4 us more than B a call, the product's issue rate. Not
// kept: staging |S| and fb in four ranges of f, the product starting on
// the first (slower: four barriers). Its first design, one block of 8
// warps a clip, each thread working through ~16 outputs one serial chain
// at a time with fb read through L1 and two block-wide sums for the
// z-score, was slower than its plain version.
#include <cuda_runtime.h>

#include "gt_epilogue.cuh"
#include "smem_once.cuh"

namespace {

using namespace gt_epilogue;

constexpr int kThreads = 512;  // 16 warps, 2 output tiles each
constexpr int kTilesPerWarp = kTiles / (kThreads / 32);
constexpr int kSmemBytes = (kSFloats + kFbFloats) * 4;
static_assert(kNTiles % kTilesPerWarp == 0, "a warp's tiles share a row");

// kF32: kernel B' (the product in f32 on the CUDA cores), else B.
// kRanges: a clip past one block's tiles (T > kRows, F > kMaxF or
// G > kBands), in tile ranges (gt_epilogue.cuh, fb_znorm_ranges); else the
// clip in one set of tiles, staged whole.
template <bool kF32, bool kRanges>
__global__ void __launch_bounds__(kThreads, 1)
epilogue_kernel(const float* __restrict__ mag,  // [B, F, T]
                const float* __restrict__ fb,   // [G, F]
                float* __restrict__ out,        // [B, G, T]
                int F, int T, int G) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double part[2][kTiles];
  float* S = smem;               // [kMaxF][kSStride]
  float* fbs = smem + kSFloats;  // [kBands][kFbStride]
  const float* m = mag + static_cast<size_t>(blockIdx.x) * F * T;
  const auto publish = [&](int k, int tile, double x) { part[k][tile] = x; };
  const auto sync = [] { __syncthreads(); };
  constexpr int kWarpsPerRow = kNTiles / kTilesPerWarp;
  if constexpr (kRanges) {
    const int warp = threadIdx.x >> 5;
    fb_znorm_ranges<kTilesPerWarp, kF32, kThreads>(
        S, fbs, m, fb, F, T, G, warp / kWarpsPerRow,
        kTilesPerWarp * (warp % kWarpsPerRow), true, part,
        out + static_cast<size_t>(blockIdx.x) * G * T, publish, sync);
  } else {
    for (int c = threadIdx.x; c < kSFloats; c += kThreads) {
      const int f = c / kSStride, t = c % kSStride;
      if (f < F && t < T) {
        cp_async4(S + c, m + f * T + t);
      } else {
        S[c] = 0.0f;
      }
    }
    stage_fb<kThreads>(fbs, fb, G, F);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int mt = warp / kWarpsPerRow;
    const int nt0 = kTilesPerWarp * (warp % kWarpsPerRow);
    float* dst = out + static_cast<size_t>(blockIdx.x) * G * T;
    if constexpr (kF32) {
      fb_znorm_tiles_f32<kTilesPerWarp>(fbs, S, F, mt, nt0, true, G, T,
                                        part, dst, publish, sync);
    } else {
      fb_znorm_tiles<kTilesPerWarp>(fbs, S, mt, nt0, true, G, T, part, dst,
                                    publish, sync);
    }
  }
}

int g_smem[2][2][smem_once::kMaxDevices];

template <bool kF32, bool kRanges>
cudaError_t launch_tiles(const float* mag, const float* fb, float* out,
                         int b, int F, int T, int G, cudaStream_t s) {
  const cudaError_t err = smem_once::raise(
      reinterpret_cast<const void*>(epilogue_kernel<kF32, kRanges>),
      kSmemBytes, g_smem[kF32][kRanges]);
  if (err != cudaSuccess || b == 0) return err;
  epilogue_kernel<kF32, kRanges><<<b, kThreads, kSmemBytes, s>>>(
      mag, fb, out, F, T, G);
  return cudaGetLastError();
}

template <bool kF32>
cudaError_t launch(const float* mag, const float* fb, float* out, int b,
                   int F, int T, int G, cudaStream_t s) {
  return T > kRows || F > kMaxF || G > kBands
             ? launch_tiles<kF32, true>(mag, fb, out, b, F, T, G, s)
             : launch_tiles<kF32, false>(mag, fb, out, b, F, T, G, s);
}

}  // namespace

extern "C" int fused_epilogue_launch(const float* mag, const float* fb,
                                     float* out, int b, int F, int T, int G,
                                     int f32, void* stream) {
  if (T < 1 || F < 1 || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(f32 ? launch<true>(mag, fb, out, b, F, T, G, s)
                              : launch<false>(mag, fb, out, b, F, T, G, s));
}
