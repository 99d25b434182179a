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
//   output tiles of 16 x 8 on the cluster's 33 warps, again on DMMA.
// - The z-score's sums: each warp sums its tile in a fixed order, writes
//   the sum into every block's table of 32, and every block adds the table
//   in tile order. So the mean and variance are the same in the three
//   blocks, and a clip's bits do not depend on B or on its place in the
//   batch: no atomics, and no part of the decomposition depends on B.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 3;                    // blocks per clip (the cluster)
constexpr int kWarps = 11;                   // 8 frequencies per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kFreqs = 8 * kWarps;           // 88 a block
constexpr int kMaxF = kSplit * kFreqs;       // 264
constexpr int kRows = 64;                    // frames, padded: 4 m16 tiles
constexpr int kBands = 64;                   // filterbank rows: 4 m16 tiles
constexpr int kKT = 32;                      // k per ring stage
constexpr int kStages = 3;
constexpr int kAStride = kKT + 4;            // conflict-free A fragments
constexpr int kAFloats = kRows * kAStride;   // a stage's frames
constexpr int kBFloats = kKT * 2 * kFreqs;   // [k8 step][warp][re|im][2][32]
constexpr int kStageFloats = kAFloats + kBFloats;
constexpr int kRingFloats = kStages * kStageFloats;
constexpr int kSStride = kRows + 8;          // |S| [f][t]: conflict-free
constexpr int kFbStride = kMaxF + 4;         // fb [g][f]: conflict-free
constexpr int kSFloats = kMaxF * kSStride;   // |S| reuses the ring
constexpr int kFbFloats = kBands * kFbStride;
static_assert(kSFloats <= kRingFloats, "|S| must fit in the ring");
constexpr int kSmemBytes = (kRingFloats + kFbFloats) * 4;
constexpr int kTiles = (kBands / 16) * (kRows / 8);  // 32 output tiles

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d[16 x 8] += a[16 x 8] * b[8 x 8] in float64. With g = lane / 4 and
// t = lane % 4: a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)], b[i] = B[t + 4 i][g],
// d[i] = D[g + 8 (i / 2)][2 t + i % 2].
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// The A fragment at p = &A[g][t] of a row-major f32 matrix, widened.
template <int kStride>
__device__ __forceinline__ void load_a(double (&a)[4], const float* p) {
  a[0] = p[0];
  a[1] = p[8 * kStride];
  a[2] = p[4];
  a[3] = p[8 * kStride + 4];
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 1)
gammatone_kernel(const float* __restrict__ frames,  // [B, T, K]
                 const float* __restrict__ tiles,   // tile_basis(basis)
                 const float* __restrict__ fb,      // [G, F]
                 float* __restrict__ out,           // [B, G, T]
                 int T, int K, int F, int G) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double part[2][kTiles];  // per output tile: sum, sum of squares
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* fr = frames + static_cast<size_t>(blockIdx.y) * T * K;
  const float* bt = tiles + static_cast<size_t>(r) * K * 2 * kFreqs;
  const int n_kt = K / kKT;
  float* fbs = smem + kRingFloats;  // [kBands][kFbStride]

  // frames T..63 are zero in every stage; cp.async never writes them
  const int pad = (kRows - T) * kAStride;
  for (int i = threadIdx.x; i < kStages * pad; i += kThreads) {
    smem[(i / pad) * kStageFloats + T * kAStride + i % pad] = 0.0f;
  }
  auto load_stage = [&](int kt, int slot) {
    float* a = smem + slot * kStageFloats;
    float* b = a + kAFloats;
    const int a_chunks = T * (kKT / 4);
    for (int c = threadIdx.x; c < a_chunks + kBFloats / 4; c += kThreads) {
      if (c < a_chunks) {
        const int row = c / (kKT / 4), q = c % (kKT / 4);
        cp_async16(a + row * kAStride + 4 * q,
                   fr + static_cast<size_t>(row) * K + kt * kKT + 4 * q);
      } else {
        const int q = c - a_chunks;
        cp_async16(b + 4 * q, bt + static_cast<size_t>(kt) * kBFloats + 4 * q);
      }
    }
  };

  // the DFT: acc[m tile][re, im][fragment]
  double acc[kRows / 16][2][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_stage(s, s);
    if (s == 1) {  // fb rides with the second stage; zero past G and F
      for (int c = threadIdx.x; c < kFbFloats; c += kThreads) {
        const int row = c / kFbStride, f = c % kFbStride;
        if (row < G && f < F) {
          cp_async4(fbs + c, fb + row * F + f);
        } else {
          fbs[c] = 0.0f;
        }
      }
    }
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

  // every block of the clip is done with its ring: |S| replaces it
  cluster.sync();
  float* S = smem;  // [kMaxF][kSStride], all 264 frequencies
  float mag[kRows / 16][4];
#pragma unroll
  for (int mt = 0; mt < kRows / 16; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double re = acc[mt][0][i], im = acc[mt][1][i];
      mag[mt][i] = __double2float_rn(
          __dsqrt_rn(__dadd_rn(__dmul_rn(re, re), __dmul_rn(im, im))));
    }
  }
#pragma unroll
  for (int q = 0; q < kSplit; ++q) {
    float* dst = cluster.map_shared_rank(S, q);
#pragma unroll
    for (int mt = 0; mt < kRows / 16; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * mt + g + 8 * (i >> 1);
        const int f = r * kFreqs + 8 * warp + 2 * t + (i & 1);
        dst[f * kSStride + row] = mag[mt][i];
      }
    }
  }
  cluster.sync();

  // the filterbank product: output tile (mt, nt) of [64 bands x 64 frames]
  const int tile = r * kWarps + warp;  // 0..32; tile 32 has no work
  const int mt = tile / (kRows / 8), nt = tile % (kRows / 8);
  double c[4] = {0.0, 0.0, 0.0, 0.0};
  if (tile < kTiles) {
#pragma unroll 3
    for (int s = 0; s < kMaxF / 8; ++s) {
      double af[4];
      load_a<kFbStride>(af, fbs + (16 * mt + g) * kFbStride + 8 * s + t);
      const float* bp = S + (8 * s + t) * kSStride + 8 * nt + g;
      mma_f64(c, af, bp[0], bp[4 * kSStride]);
    }
  }
  float v[4];
  bool valid[4];
  double sum = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = 16 * mt + g + 8 * (i >> 1), tc = 8 * nt + 2 * t + (i & 1);
    valid[i] = tile < kTiles && gr < G && tc < T;
    v[i] = __double2float_rn(log1p(c[i]));
    if (valid[i]) sum += v[i];
  }

  // z-score: tile sums in every block's table, added in tile order
  const double n = static_cast<double>(G) * T;
  sum = warp_sum(sum);
  if (lane == 0 && tile < kTiles) {
    for (int q = 0; q < kSplit; ++q) {
      cluster.map_shared_rank(part[0], q)[tile] = sum;
    }
  }
  cluster.sync();
  double total = 0.0;
  for (int j = 0; j < kTiles; ++j) total += part[0][j];
  const float mean = __double2float_rn(total / n);

  double sq = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = __fsub_rn(v[i], mean);
    if (valid[i]) sq += static_cast<double>(d) * d;
  }
  sq = warp_sum(sq);
  if (lane == 0 && tile < kTiles) {
    for (int q = 0; q < kSplit; ++q) {
      cluster.map_shared_rank(part[1], q)[tile] = sq;
    }
  }
  cluster.sync();  // the last access to another block's shared memory
  total = 0.0;
  for (int j = 0; j < kTiles; ++j) total += part[1][j];
  const float var = __double2float_rn(total / n);
  const float denom = __fadd_rn(__fsqrt_rn(var), 1e-8f);
  float* dst = out + static_cast<size_t>(blockIdx.y) * G * T;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (valid[i]) {
      dst[(16 * mt + g + 8 * (i >> 1)) * T + 8 * nt + 2 * t + (i & 1)] =
          __fdiv_rn(__fsub_rn(v[i], mean), denom);
    }
  }
}

}  // namespace

// tiles: the basis as tiled_basis lays it out, [3, K / 8, 11, 2, 2, 32].
extern "C" int fused_gammatone_launch(const float* frames, const float* tiles,
                                      const float* fb, float* out, int b,
                                      int T, int K, int F, int G,
                                      void* stream) {
  if (T < 1 || T > kRows || K % kKT != 0 || F > kMaxF || G > kBands) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      gammatone_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  gammatone_kernel<<<dim3(kSplit, b), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      frames, tiles, fb, out, T, K, F, G);
  return static_cast<int>(cudaGetLastError());
}
