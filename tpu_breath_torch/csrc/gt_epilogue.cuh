// The gammatone channel's epilogue for one clip,
//   out[g, t] = znorm(f32(log1p(sum_f fb[g, f] * mag[f, t])))
// over the whole [G, T] clip, in two forms:
// - fb_znorm_tiles, the float64 form of kernels B (epilogue_kernel.cu) and
//   B'' (gammatone_kernel.cu): |S| and fb in shared memory, padded with
//   zeros; the product on the float64 tensor cores (mma.sync.m16n8k8.f64)
//   in 32 output tiles of 16 x 8, log1p in float64 rounded once;
// - epilogue_clip_f32, kernel B' (epilogue_kernel.cu): an f32 FMA chain and
//   log1pf, one block a clip.
// Both take the z-score's mean and variance as float64 sums of the f32
// values, each rounded to f32 once. This header also holds the cp.async and
// DMMA helpers that gammatone_kernel.cu's DFT uses.
#pragma once
#include <cuda_runtime.h>

namespace gt_epilogue {

constexpr int kMaxF = 264;            // frequencies, padded: 33 k-steps of 8
constexpr int kRows = 64;             // frames, padded: 8 n-tiles of 8
constexpr int kBands = 64;            // filterbank rows: 4 m-tiles of 16
constexpr int kSStride = kRows + 8;   // |S| [f][t]: conflict-free B loads
constexpr int kFbStride = kMaxF + 4;  // fb [g][f]: conflict-free A loads
constexpr int kSFloats = kMaxF * kSStride;
constexpr int kFbFloats = kBands * kFbStride;
constexpr int kNTiles = kRows / 8;               // output tiles in a row
constexpr int kTiles = (kBands / 16) * kNTiles;  // 32 output tiles

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

// fb [G, F] (global) into fbs [kBands][kFbStride], zero past G and F: the
// entries by cp.async of 4 bytes (fb's rows are not 16-byte aligned), the
// padding by plain stores. The caller commits the group and waits for it.
template <int kThreads>
__device__ __forceinline__ void stage_fb(float* fbs,
                                         const float* __restrict__ fb, int G,
                                         int F) {
  for (int c = threadIdx.x; c < kFbFloats; c += kThreads) {
    const int row = c / kFbStride, f = c % kFbStride;
    if (row < G && f < F) {
      cp_async4(fbs + c, fb + row * F + f);
    } else {
      fbs[c] = 0.0f;
    }
  }
}

// The output tiles (mt, nt0 + j), j < N, of one clip, by one warp: DMMA of
// fbs [kBands][kFbStride] by S [kMaxF][kSStride] (|S| f-major, both padded
// with zeros), f32(log1p) of the sums, then the z-score over the clip's
// [G, T] into dst [G, T] (global). live = false: the warp has no tiles but
// takes part in the syncs. The z-score's sums: each tile's sum (the warp's
// lanes' values added in fragment order, then across the warp) goes to
// publish(k, tile, sum) (k = 0 the values, 1 the squared deviations), which
// writes it into part[k][tile] of every block the clip spans; sync() makes
// the tables whole; each block adds its table in tile order. So a clip's
// bits depend neither on N nor on how many blocks share it, and not on B.
template <int N, class Publish, class Sync>
__device__ __forceinline__ void fb_znorm_tiles(
    const float* fbs, const float* S, int mt, int nt0, bool live, int G,
    int T, double (*part)[kTiles], float* __restrict__ dst, Publish publish,
    Sync sync) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  double c[N][4] = {};
  if (live) {
#pragma unroll 3
    for (int s = 0; s < kMaxF / 8; ++s) {
      double af[4];
      load_a<kFbStride>(af, fbs + (16 * mt + g) * kFbStride + 8 * s + t);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float* bp = S + (8 * s + t) * kSStride + 8 * (nt0 + j) + g;
        mma_f64(c[j], af, bp[0], bp[4 * kSStride]);
      }
    }
  }
  float v[N][4];
  bool valid[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    double sum = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = 16 * mt + g + 8 * (i >> 1);
      const int tc = 8 * (nt0 + j) + 2 * t + (i & 1);
      valid[j][i] = live && gr < G && tc < T;
      v[j][i] = __double2float_rn(log1p(c[j][i]));
      if (valid[j][i]) sum += v[j][i];
    }
    sum = warp_sum(sum);
    if (lane == 0 && live) publish(0, mt * kNTiles + nt0 + j, sum);
  }
  const double n = static_cast<double>(G) * T;
  sync();
  double total = 0.0;
  for (int q = 0; q < kTiles; ++q) total += part[0][q];
  const float mean = __double2float_rn(total / n);

#pragma unroll
  for (int j = 0; j < N; ++j) {
    double sq = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d = __fsub_rn(v[j][i], mean);
      if (valid[j][i]) sq += static_cast<double>(d) * d;
    }
    sq = warp_sum(sq);
    if (lane == 0 && live) publish(1, mt * kNTiles + nt0 + j, sq);
  }
  sync();
  total = 0.0;
  for (int q = 0; q < kTiles; ++q) total += part[1][q];
  const float var = __double2float_rn(total / n);
  const float denom = __fadd_rn(__fsqrt_rn(var), 1e-8f);
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (valid[j][i]) {
        dst[(16 * mt + g + 8 * (i >> 1)) * T + 8 * (nt0 + j) + 2 * t +
            (i & 1)] = __fdiv_rn(__fsub_rn(v[j][i], mean), denom);
      }
    }
  }
}

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

// Kernel B': smag [F * T] (shared, f-major), fb [G, F] (global), sval
// [G * T] shared scratch, dst [G * T] (global); scratch holds 33 doubles.
// The product is an f32 FMA chain, then log1pf. blockDim.x must be a
// multiple of 32, at most 1024.
__device__ __forceinline__ void epilogue_clip_f32(const float* smag,
                                                  const float* __restrict__ fb,
                                                  float* sval, float* dst,
                                                  int F, int T, int G,
                                                  double* scratch) {
  const int gt = G * T;
  double part = 0.0;
  for (int o = threadIdx.x; o < gt; o += blockDim.x) {
    const int g = o / T, t = o - g * T;
    const float* row = fb + static_cast<size_t>(g) * F;
    float acc = 0.0f;
    for (int f = 0; f < F; ++f) acc = fmaf(__ldg(row + f), smag[f * T + t], acc);
    const float v = log1pf(acc);
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
