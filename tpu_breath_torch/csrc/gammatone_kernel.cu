// Kernel B'': the whole gammatone channel, one cluster of 3 blocks per clip:
//   S[t, f]  = | sum_k frames[t, k] * basis[k, f] + i * basis[k, F + f] |
//   out      = znorm(f32(log1p(fb @ f32(S))))          [G, T]
//
// Replaces tpu_breath/ops/pallas/epilogue_kernel.py::fused_gammatone (its
// pallas_call at :126, _gammatone_kernel :78-102): frames -> double-float
// real DFT -> |S| -> double-float filterbank GEMM -> log1p_cr -> z-score.
// Here both products run on the float64 tensor cores (DMMA,
// mma.sync.m16n8k8.f64), the f32 inputs widened exactly; |S| is taken in
// float64 and rounded to f32 once, log1p in float64 rounded once, and the
// z-score's mean and variance are float64 sums rounded to f32 once.
//
// What bounds it on the H100: per clip 2 * 64 * 512 * 528 = 34.6 MFLOP of
// float64 for the DFT (63 frames padded to 64, 257 frequencies to 264) and
// 2.2 MFLOP for the filterbank, against 129 KB of frames in and 16 KB out:
// operations, at the 67 TFLOP/s of the float64 tensor cores. The basis
// (1 MB) and fb (66 KB) are shared by every clip and stay in L2.
//
// Design:
// - A clip is a cluster of 3 blocks; block r computes frequencies
//   [88 r, 88 r + 88) of the DFT for all 64 (padded) frames, so even B = 8
//   runs on 24 SMs. Each of its 11 warps owns 8 frequencies, their re and im
//   columns side by side: a 64 x 16 tile, 8 DMMAs per k-step of 8, so each
//   lane holds re and im of the same (frame, frequency) and takes |S| in
//   registers.
// - The frames and the basis stream through a 3-stage ring of k-tiles of 32
//   (cp.async, 31 KB a stage): no DMMA waits on L2. Both stay f32 in
//   shared memory, half the bytes of float64, and are widened as a
//   fragment is loaded; widening the frames once per k-tile into a shared
//   float64 tile measured slower on the H100 (one more barrier a k-tile).
//   The frames' rows are padded to 36 floats (conflict-free fragment
//   loads); the basis comes tiled (tiled_basis, built once per device as
//   a spectral.device_const): each block's columns in fragment order, so
//   a warp's fragment is one contiguous 128-byte load. fb is copied in
//   4-byte pieces into rows padded with zeros (conflict-free fragment
//   loads) with the second stage and lands during the DFT.
// - Once every block of the cluster is done with its ring, each block
//   writes its |S| rows into all three blocks' shared memory (distributed
//   shared memory). The filterbank product [64 x 264] x [264 x 64] is 32
//   output tiles of 16 x 8 on the cluster's 33 warps, again on DMMA
//   (gt_epilogue.cuh, fb_znorm_tiles, which kernel B shares).
// - The z-score's sums: each warp sums its tile in a fixed order, writes
//   the sum into every block's table of 32, and every block adds the table
//   in tile order. So the mean and variance are the same in the three
//   blocks, and a clip's bits do not depend on B or on its place in the
//   batch: no atomics, and no part of the decomposition depends on B.
// - The grid is one-dimensional, the clip on x (blockIdx.x / 3), so it
//   takes any number of clips.
// - A clip past the cluster's tiles (T > 64 frames, F > 264 frequencies,
//   G > 64 bands, or K not a multiple of 32; the main path's clips are
//   63 frames of 512 -> 257 -> 64) takes a second instantiation (kRanges),
//   chosen on the host, so the main path keeps its code: the DFT runs over
//   frame ranges of 64 and frequency ranges of 264, with K padded to the
//   next multiple of 32 inside the kernel (zero frames against zero basis
//   rows add exact zeros), and writes |S| into a [B, F, T] scratch in
//   device memory; after a cluster barrier the three blocks run kernel B's
//   range epilogue on it (gt_epilogue.cuh, fb_znorm_ranges), their tile
//   sums shared as above. The basis tiles then cover every frequency
//   range (tiled_basis).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gt_epilogue.cuh"
#include "smem_once.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gt_epilogue;

constexpr int kSplit = 3;                    // blocks per clip (the cluster)
constexpr int kWarps = 11;                   // 8 frequencies per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kFreqs = 8 * kWarps;           // 88 a block
static_assert(kSplit * kFreqs == kMaxF, "the blocks cover |S|'s padding");
constexpr int kKT = 32;                      // k per ring stage
constexpr int kStages = 3;
constexpr int kAStride = kKT + 4;            // conflict-free A fragments
constexpr int kAFloats = kRows * kAStride;   // a stage's frames
constexpr int kBFloats = kKT * 2 * kFreqs;   // [k8 step][warp][re|im][2][32]
constexpr int kStageFloats = kAFloats + kBFloats;
constexpr int kRingFloats = kStages * kStageFloats;
static_assert(kSFloats <= kRingFloats, "|S| must fit in the ring");
constexpr int kSmemBytes = (kRingFloats + kFbFloats) * 4;

// The DFT of frames [0, rows) at fr (a clip's rows of K floats) by this
// block's kFreqs frequencies, the basis tiles at bt (n_kt k-tiles):
// acc[m tile][re, im][fragment]. The frames and the basis stream through
// the ring; frames rows..63 are zeros in every stage. kRanges: so are the
// k columns from K on (K need not be a multiple of kKT); else fb is staged
// into fbs with the second stage.
template <bool kRanges>
__device__ __forceinline__ void dft(double (&acc)[kRows / 16][2][4],
                                    float* smem, const float* fr,
                                    const float* bt, int rows, int K,
                                    int n_kt, float* fbs, const float* fb,
                                    int G, int F) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // frames rows..63 are zero in every stage; cp.async never writes them
  const int pad = (kRows - rows) * kAStride;
  for (int i = threadIdx.x; i < kStages * pad; i += kThreads) {
    smem[(i / pad) * kStageFloats + rows * kAStride + i % pad] = 0.0f;
  }
  auto load_stage = [&](int kt, int slot) {
    float* a = smem + slot * kStageFloats;
    float* b = a + kAFloats;
    const int a_chunks = rows * (kKT / 4);
    for (int c = threadIdx.x; c < a_chunks + kBFloats / 4; c += kThreads) {
      if (c < a_chunks) {
        const int row = c / (kKT / 4), q = c % (kKT / 4);
        if (kRanges && kt * kKT + 4 * q >= K) {
          *reinterpret_cast<float4*>(a + row * kAStride + 4 * q) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
          cp_async16(a + row * kAStride + 4 * q,
                     fr + static_cast<size_t>(row) * K + kt * kKT + 4 * q);
        }
      } else {
        const int q = c - a_chunks;
        cp_async16(b + 4 * q, bt + static_cast<size_t>(kt) * kBFloats + 4 * q);
      }
    }
  };

#pragma unroll
  for (int mt = 0; mt < kRows / 16; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][0][i] = acc[mt][1][i] = 0.0;
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_stage(s, s);
    if (s == 1 && !kRanges) stage_fb<kThreads>(fbs, fb, G, F);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < n_kt) {
      load_stage(kt + kStages - 1, (kt + kStages - 1) % kStages);
    }
    cp_async_commit();
    const float* a = smem + (kt % kStages) * kStageFloats;
    const float* b = a + kAFloats + warp * 128 + lane;
#pragma unroll
    for (int s = 0; s < kKT / 8; ++s) {
      const float* bs = b + s * kWarps * 128;
      const double br0 = bs[0], br1 = bs[32], bi0 = bs[64], bi1 = bs[96];
#pragma unroll
      for (int mt = 0; mt < kRows / 16; ++mt) {
        double af[4];
        load_a<kAStride>(af, a + (16 * mt + g) * kAStride + 8 * s + t);
        mma_f64(acc[mt][0], af, br0, br1);
        mma_f64(acc[mt][1], af, bi0, bi1);
      }
    }
  }
  cp_async_wait<0>();
}

// |S| of fragment value i of m tile mt, rounded to f32 once.
__device__ __forceinline__ float magnitude(
    const double (&acc)[kRows / 16][2][4], int mt, int i) {
  const double re = acc[mt][0][i], im = acc[mt][1][i];
  return __double2float_rn(
      __dsqrt_rn(__dadd_rn(__dmul_rn(re, re), __dmul_rn(im, im))));
}

// Grid (kSplit * B), the clip on x (no limit on B): cluster blockIdx.x /
// kSplit takes that clip. kRanges: a clip past the cluster's tiles
// (T > kRows, F > kMaxF, G > kBands or K not a multiple of kKT) in ranges;
// mag is then a [B, F, T] scratch for its |S|. Else mag is unused.
template <bool kRanges>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 1)
gammatone_kernel(const float* __restrict__ frames,  // [B, T, K]
                 const float* __restrict__ tiles,   // tile_basis(basis)
                 const float* __restrict__ fb,      // [G, F]
                 float* __restrict__ out,           // [B, G, T]
                 float* __restrict__ mag,           // [B, F, T] or unused
                 int T, int K, int F, int G) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double part[2][kTiles];  // per output tile: sum, sum of squares
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int clip = blockIdx.x / kSplit;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* fr = frames + static_cast<size_t>(clip) * T * K;
  float* fbs = smem + kRingFloats;  // [kBands][kFbStride]
  // the filterbank product and the z-score: tile (mt, nt) of [64 bands x
  // 64 frames] on warp tile = 11 r + warp; tile 32 has no work
  const int tile = r * kWarps + warp;
  const auto publish = [&](int k, int q, double x) {
    for (int rank = 0; rank < kSplit; ++rank) {
      cluster.map_shared_rank(part[k], rank)[q] = x;
    }
  };
  const auto sync = [&] { cluster.sync(); };
  double acc[kRows / 16][2][4];

  if constexpr (!kRanges) {
    dft<false>(acc, smem, fr, tiles + static_cast<size_t>(r) * K * 2 * kFreqs,
               T, K, K / kKT, fbs, fb, G, F);

    // every block of the clip is done with its ring: |S| replaces it
    cluster.sync();
    float* S = smem;  // [kMaxF][kSStride], all 264 frequencies
#pragma unroll
    for (int q = 0; q < kSplit; ++q) {
      float* dst = cluster.map_shared_rank(S, q);
#pragma unroll
      for (int mt = 0; mt < kRows / 16; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 16 * mt + g + 8 * (i >> 1);
          const int f = r * kFreqs + 8 * warp + 2 * t + (i & 1);
          dst[f * kSStride + row] = magnitude(acc, mt, i);
        }
      }
    }
    cluster.sync();
    fb_znorm_tiles<1>(fbs, S, tile / kNTiles, tile % kNTiles, tile < kTiles,
                      G, T, part, out + static_cast<size_t>(clip) * G * T,
                      publish, sync);  // the last sync: the last access to
                                       // another block's shared memory
  } else {
    // |S| in frame ranges of kRows and frequency ranges of kMaxF (this
    // block's kFreqs of each) into mag, then kernel B's range epilogue
    const int n_kt = (K + kKT - 1) / kKT;
    float* m = mag + static_cast<size_t>(clip) * F * T;
    for (int t0 = 0; t0 < T; t0 += kRows) {
      for (int f0 = 0; f0 < F; f0 += kMaxF) {
        __syncthreads();  // the last range's reads of the ring are done
        dft<true>(acc, smem, fr + static_cast<size_t>(t0) * K,
                  tiles + (static_cast<size_t>(f0 / kMaxF) * kSplit + r) *
                              n_kt * kBFloats,
                  min(T - t0, kRows), K, n_kt, fbs, fb, G, F);
#pragma unroll
        for (int mt = 0; mt < kRows / 16; ++mt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = t0 + 16 * mt + g + 8 * (i >> 1);
            const int f = f0 + r * kFreqs + 8 * warp + 2 * t + (i & 1);
            if (row < T && f < F) {
              m[static_cast<size_t>(f) * T + row] = magnitude(acc, mt, i);
            }
          }
        }
      }
    }
    __threadfence();
    cluster.sync();  // the clip's |S| is whole in mag
    fb_znorm_ranges<1, false, kThreads>(
        smem, fbs, m, fb, F, T, G, tile / kNTiles, tile % kNTiles,
        tile < kTiles, part, out + static_cast<size_t>(clip) * G * T,
        publish, sync);
  }
}

int g_smem[2][smem_once::kMaxDevices];

template <bool kRanges>
cudaError_t launch(const float* frames, const float* tiles, const float* fb,
                   float* out, float* mag, int b, int T, int K, int F, int G,
                   cudaStream_t s) {
  const cudaError_t err = smem_once::raise(
      reinterpret_cast<const void*>(gammatone_kernel<kRanges>), kSmemBytes,
      g_smem[kRanges]);
  if (err != cudaSuccess || b == 0) return err;
  gammatone_kernel<kRanges><<<kSplit * b, kThreads, kSmemBytes, s>>>(
      frames, tiles, fb, out, mag, T, K, F, G);
  return cudaGetLastError();
}

}  // namespace

// tiles: the basis as tiled_basis lays it out, [ceil(F / 264) * 3,
// ceil(K / 32) * 4, 11, 2, 2, 32]. mag: null for a clip that fits the
// cluster's tiles (T <= 64, F <= 264, G <= 64, K a multiple of 32), else
// a [b, F, T] scratch. K a multiple of 4, frames 16-byte aligned.
extern "C" int fused_gammatone_launch(const float* frames, const float* tiles,
                                      const float* fb, float* out, float* mag,
                                      int b, int T, int K, int F, int G,
                                      void* stream) {
  const bool ranges = T > kRows || F > kMaxF || G > kBands || K % kKT != 0;
  if (T < 1 || K < 4 || K % 4 != 0 || F < 1 || G < 1 ||
      (reinterpret_cast<size_t>(frames) & 15) != 0 ||
      ranges != (mag != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      ranges ? launch<true>(frames, tiles, fb, out, mag, b, T, K, F, G, s)
             : launch<false>(frames, tiles, fb, out, mag, b, T, K, F, G, s));
}
