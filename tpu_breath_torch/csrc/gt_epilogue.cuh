// The gammatone channel's epilogue for one clip,
//   out[g, t] = znorm(f32(log1p(sum_f fb[g, f] * mag[f, t])))
// over the whole [G, T] clip, from |S| and fb in shared memory, padded with
// zeros, in 32 output tiles of 16 x 8, in two forms:
// - fb_znorm_tiles, the float64 form of kernels B (epilogue_kernel.cu) and
//   B'' (gammatone_kernel.cu): the product on the float64 tensor cores
//   (mma.sync.m16n8k8.f64), log1p in float64 rounded once;
// - fb_znorm_tiles_f32, kernel B' (epilogue_kernel.cu): each output one f32
//   FMA chain in f order on the CUDA cores, then log1pf.
// A lane holds the outputs of its DMMA accumulator fragment in both, and
// both end in znorm_tiles: the z-score's mean and variance as float64 sums
// of the f32 values in tile order, each rounded to f32 once. This header
// also holds the cp.async and DMMA helpers that gammatone_kernel.cu's DFT
// uses.
#pragma once
#include <cuda_runtime.h>

#include <type_traits>

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

// The z-score of one clip over its [G, T] outputs, from the f32 values
// v[j][i] a lane holds of the output tiles (mt, nt0 + j), j < N, in the
// DMMA accumulator layout (row 16 mt + g + 8 (i / 2), column
// 8 (nt0 + j) + 2 t + i % 2, g = lane / 4, t = lane % 4), written into
// dst [G, T] (global). live = false: the warp has no tiles but takes part
// in the syncs. Each tile's sum (the warp's lanes' values added in fragment
// order, then across the warp) goes to publish(k, tile, sum) (k = 0 the
// values, 1 the squared deviations), which writes it into part[k][tile] of
// every block the clip spans; sync() makes the tables whole; each block
// adds its table in tile order. So a clip's bits depend neither on N nor on
// how many blocks share it, and not on B.
template <int N, class Publish, class Sync>
__device__ __forceinline__ void znorm_tiles(
    const float (&v)[N][4], int mt, int nt0, bool live, int G, int T,
    double (*part)[kTiles], float* __restrict__ dst, Publish publish,
    Sync sync) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bool valid[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    double sum = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = 16 * mt + g + 8 * (i >> 1);
      const int tc = 8 * (nt0 + j) + 2 * t + (i & 1);
      valid[j][i] = live && gr < G && tc < T;
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

// c[j] += fbs [kBands][kFbStride] times S [kMaxF][kSStride] (|S| f-major,
// both padded with zeros) for the output tiles (mt, nt0 + j), j < N, by
// DMMA over the kMaxF / 8 k-steps, in the accumulator layout.
template <int N>
__device__ __forceinline__ void fb_dmma(double (&c)[N][4], const float* fbs,
                                        const float* S, int mt, int nt0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
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

// The output tiles (mt, nt0 + j), j < N, of one clip, by one warp: DMMA of
// fbs [kBands][kFbStride] by S [kMaxF][kSStride] (|S| f-major, both padded
// with zeros), f32(log1p) of the sums, then znorm_tiles (the arguments
// after nt0 are its own).
template <int N, class Publish, class Sync>
__device__ __forceinline__ void fb_znorm_tiles(
    const float* fbs, const float* S, int mt, int nt0, bool live, int G,
    int T, double (*part)[kTiles], float* __restrict__ dst, Publish publish,
    Sync sync) {
  double c[N][4] = {};
  if (live) fb_dmma<N>(c, fbs, S, mt, nt0);
  float v[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[j][i] = __double2float_rn(log1p(c[j][i]));
  }
  znorm_tiles<N>(v, mt, nt0, live, G, T, part, dst, publish, sync);
}

// Kernel B''s product: c[j] += sum_f fb[g, f] * mag[f, t] for the output
// tiles (mt, nt0 + j), j < N, each output one f32 FMA chain for
// f = 0 .. F - 1 in order (a lane's 8 chains side by side: 2 bands by 4
// frames, its fragment's outputs), from fbs and S as fb_dmma reads them.
template <int N>
__device__ __forceinline__ void fb_f32(float (&c)[N][4], const float* fbs,
                                       const float* S, int F, int mt,
                                       int nt0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a = fbs + (16 * mt + g) * kFbStride;
  const float* b = S + 8 * nt0 + 2 * t;
  // f in fours, fb by 16-byte loads; the padding's terms (f >= F, zero
  // fb and |S|) leave the sums as they are
#pragma unroll 1
  for (int f4 = 0; f4 < F; f4 += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + f4);
    const float4 a1 = *reinterpret_cast<const float4*>(a + 8 * kFbStride + f4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float w0 = e == 0 ? a0.x : e == 1 ? a0.y : e == 2 ? a0.z : a0.w;
      const float w1 = e == 0 ? a1.x : e == 1 ? a1.y : e == 2 ? a1.z : a1.w;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(
            b + (f4 + e) * kSStride + 8 * j);
        c[j][0] = fmaf(w0, x.x, c[j][0]);
        c[j][1] = fmaf(w0, x.y, c[j][1]);
        c[j][2] = fmaf(w1, x.x, c[j][2]);
        c[j][3] = fmaf(w1, x.y, c[j][3]);
      }
    }
  }
}

// Kernel B': the same tiles as fb_znorm_tiles, the product by fb_f32, then
// log1pf and znorm_tiles (the arguments after nt0 are its own).
template <int N, class Publish, class Sync>
__device__ __forceinline__ void fb_znorm_tiles_f32(
    const float* fbs, const float* S, int F, int mt, int nt0, bool live,
    int G, int T, double (*part)[kTiles], float* __restrict__ dst,
    Publish publish, Sync sync) {
  float c[N][4] = {};
  if (live) fb_f32<N>(c, fbs, S, F, mt, nt0);
  float v[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[j][i] = log1pf(c[j][i]);
  }
  znorm_tiles<N>(v, mt, nt0, live, G, T, part, dst, publish, sync);
}

// A clip past one block's tiles (T > kRows, F > kMaxF or G > kBands), for
// kernels B and B' (kF32) and B'': its outputs in tiles of kBands bands by
// kRows frames, band ranges inside frame ranges, each tile's product
// summed over frequency ranges of kMaxF in order (so B' keeps one f32
// chain an output, f = 0 .. F - 1). mag [F, T] is the clip's |S| in device
// memory; each frequency range of |S| and fb is staged into S and fbs as
// kernel B stages a whole clip. Three passes over the tiles in that order:
// f32(log1p) of the sums into dst, each tile's sum published as
// znorm_tiles does and added in tile order; the squared deviations, read
// back from dst; the z-score, written over dst. A lane reads back only the
// values it wrote. The tables alternate between part[0] and part[1], so
// one sync() a tile both completes a table and frees the other.
template <int N, bool kF32, int kThreads, class Publish, class Sync>
__device__ __forceinline__ void fb_znorm_ranges(
    float* S, float* fbs, const float* __restrict__ mag,
    const float* __restrict__ fb, int F, int T, int G, int mt, int nt0,
    bool live, double (*part)[kTiles], float* __restrict__ dst,
    Publish publish, Sync sync) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the index in dst of value i of a lane's tile j in the range (g0, t0),
  // or -1 past G or T
  const auto at = [&](int g0, int t0, int j, int i) {
    const int row = g0 + 16 * mt + g + 8 * (i >> 1);
    const int col = t0 + 8 * (nt0 + j) + 2 * t + (i & 1);
    return live && row < G && col < T ? row * T + col : -1;
  };
  int k = 0;  // the table the next tile sums go to
  // adds the tile sums of lane values x(j, i) of the range (g0, t0) to
  // total in tile order
  const auto add_tiles = [&](double& total, int g0, int t0, auto x) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      double sum = 0.0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (at(g0, t0, j, i) >= 0) sum += x(j, i);
      }
      sum = warp_sum(sum);
      if (lane == 0 && live) publish(k, mt * kNTiles + nt0 + j, sum);
    }
    sync();
    for (int q = 0; q < kTiles; ++q) total += part[k][q];
    k ^= 1;
  };
  const double n = static_cast<double>(G) * T;

  double total = 0.0;
  for (int t0 = 0; t0 < T; t0 += kRows) {
    for (int g0 = 0; g0 < G; g0 += kBands) {
      using Acc = typename std::conditional<kF32, float, double>::type;
      Acc c[N][4] = {};
      for (int f0 = 0; f0 < F; f0 += kMaxF) {
        __syncthreads();  // the last range's reads of S and fbs are done
        for (int q = threadIdx.x; q < kSFloats; q += kThreads) {
          const int f = f0 + q / kSStride, tc = q % kSStride;
          if (f < F && tc < kRows && t0 + tc < T) {
            cp_async4(S + q, mag + static_cast<size_t>(f) * T + t0 + tc);
          } else {
            S[q] = 0.0f;
          }
        }
        for (int q = threadIdx.x; q < kFbFloats; q += kThreads) {
          const int row = g0 + q / kFbStride, f = f0 + q % kFbStride;
          if (row < G && q % kFbStride < kMaxF && f < F) {
            cp_async4(fbs + q, fb + static_cast<size_t>(row) * F + f);
          } else {
            fbs[q] = 0.0f;
          }
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (live) {
          if constexpr (kF32) {
            fb_f32<N>(c, fbs, S, min(F - f0, kMaxF), mt, nt0);
          } else {
            fb_dmma<N>(c, fbs, S, mt, nt0);
          }
        }
      }
      float v[N][4];
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kF32) {
            v[j][i] = log1pf(c[j][i]);
          } else {
            v[j][i] = __double2float_rn(log1p(c[j][i]));
          }
          const int o = at(g0, t0, j, i);
          if (o >= 0) dst[o] = v[j][i];
        }
      }
      add_tiles(total, g0, t0, [&](int j, int i) { return double(v[j][i]); });
    }
  }
  const float mean = __double2float_rn(total / n);

  total = 0.0;
  for (int t0 = 0; t0 < T; t0 += kRows) {
    for (int g0 = 0; g0 < G; g0 += kBands) {
      add_tiles(total, g0, t0, [&](int j, int i) {
        const float d = __fsub_rn(dst[at(g0, t0, j, i)], mean);
        return static_cast<double>(d) * d;
      });
    }
  }
  const float var = __double2float_rn(total / n);
  const float denom = __fadd_rn(__fsqrt_rn(var), 1e-8f);
  for (int t0 = 0; t0 < T; t0 += kRows) {
    for (int g0 = 0; g0 < G; g0 += kBands) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int o = at(g0, t0, j, i);
          if (o >= 0) dst[o] = __fdiv_rn(__fsub_rn(dst[o], mean), denom);
        }
      }
    }
  }
}

}  // namespace gt_epilogue
