// Kernel F: a ConvBlock's BatchNorm and its activation, channels-last, as
// one kernel set: the training forward, its backward and the evaluation
// forward.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm and its
// activation to XLA (tpu_breath/models/layers.py), which fuses them on the
// TPU. It was added because torch runs them as separate channels-last
// BatchNorm kernels and elementwise activation passes: 13 passes over a
// step's activations in VGG, more in CNN8 (the conv-bias add, the ReLU and
// the bias-gradient sum besides), the statistics pass at ~17% of HBM's rate.
//
// Input x [M, C] (a channels-last [B, C, H, W] tensor: a row is one
// position, its C channels contiguous), bf16 or f32; the conv bias b (or
// none), gamma, beta and the statistics are f32 [C]. With t = x + b and
// r = 1 / sqrt(var + eps):
//   "bn_gelu" (VGG):  z = gelu(gamma (t - mean) r + beta), exact GELU;
//   "relu_bn" (CNN8): z = gamma (relu(t) - mean) r + beta.
// Training normalises with the batch's mean and biased variance of the
// normalised input (t, or relu(t)), and updates the running statistics as
// Flax does (momentum 0.9 in Flax's sense, the biased variance).
//
// What bounds it on the H100: HBM bytes. Normalisation and activation do a
// few operations a byte, far below the card's ridge. The least traffic is
// 8 passes over the activations in a training step: the forward reads x
// for the statistics, then reads x and writes z; the backward reads dz and
// x for the two sums, then reads them again and writes dx. Nothing else
// activation-sized is stored: the backward recomputes the normalised value
// and the activation's derivative from x. The design:
// - Every streaming pass deals the rows to G <= kMaxBlocks blocks in
//   contiguous ranges (G is the wrapper's, from M and C) and the channels
//   to the lanes of a row: a thread keeps one 16-byte group of channels
//   (8 bf16 or 4 f32) for the whole pass, so the channels' parameters sit
//   in registers and every load and store is one 16-byte vector; a thread
//   loads 4 rows (8 in the statistics pass) before it uses any.
// - The normalised value and the activation stay in f32 registers; z and dx
//   are rounded to the activation dtype once.
// - Sums across rows are deterministic, with no atomics: a thread adds its
//   rows in order (the statistics by Welford's update), the threads of a
//   channel group merge in a fixed tree (the statistics by Chan's formula),
//   each block writes its partials to scratch [G, C], and a small merge
//   kernel combines a channel's G partials in a fixed order: 64 slices of
//   at most 5 in order (all loaded before the first is used: the merge is
//   a chain of L2 reads), then a fixed tree. The bits depend on M, C, G
//   and the input alone, so a CUDA graph's replay equals the eager call.
// - Launches a training block: forward 3 (statistics, merge, apply),
//   backward 3 (sums, merge, dx) and one more merge for the conv bias's
//   gradient; the evaluation forward 1. The wrapper allocates every output
//   and scratch buffer; nothing syncs the host.
// Built without fast math: erff, expf, IEEE division and square root.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;  // one wave: 2 blocks an SM (132)
constexpr int kUnroll = 4;
constexpr int kStatsUnroll = 8;  // the statistics pass holds little else
constexpr int kSlices = 64;      // merge kernels: threads a channel
constexpr int kMergeChannels = 8;
constexpr int kPerSlice = (kMaxBlocks + kSlices - 1) / kSlices;
constexpr float kSqrt1_2 = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

enum Order { kBnGelu = 0, kReluBn = 1 };

template <typename T>
struct Pack;

// 16 bytes of T: loaded and stored as one vector (raw), worked on as f32

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& q, float (&v)[N]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  __device__ static uint4 pack(const float (&v)[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  // a 32-bit word holds two bf16, the lower address in the low half; a
  // bf16 is the top half of the f32 of the same value
  __device__ static void unpack(const uint4& q, float (&v)[N]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&v)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const uint4& q) {
  *reinterpret_cast<uint4*>(p) = q;
}

// The rows of block g: [lo, hi), G contiguous ranges as even as can be.
struct Rows {
  long long lo, hi;
  __device__ Rows(long long m, int g, int blocks)
      : lo(m * g / blocks), hi(m * (g + 1) / blocks) {}
};

// A thread's place in a streaming pass: its channel group (lane of a row),
// its first row and the stride between its rows.
template <typename T>
struct Lane {
  static constexpr int V = Pack<T>::N;
  int c0;    // first channel of the group
  int row;   // row offset inside the block's range
  int step;  // rows a block covers in one pass of its threads
  __device__ Lane(int c) {
    const int lanes = c / V;
    c0 = (threadIdx.x % lanes) * V;
    row = threadIdx.x / lanes;
    step = kThreads / lanes;
  }
};

__device__ __forceinline__ float inv_std(float var, float eps) {
  return 1.0f / sqrtf(var + eps);
}

__device__ __forceinline__ float gelu(float y) {
  return y * 0.5f * (1.0f + erff(y * kSqrt1_2));
}

// d gelu(y) / dy, as torch's GELU backward computes it (erff and expf)
__device__ __forceinline__ float gelu_grad(float y) {
  const float cdf = 0.5f * (1.0f + erff(y * kSqrt1_2));
  const float pdf = expf(-0.5f * y * y) * kInvSqrt2Pi;
  return cdf + y * pdf;
}

// Chan's merge of (nb, mb, m2b) into (na, ma, m2a), in this order (a, then
// b): the mean and sum of squared deviations of the union; the caller sets
// the count to na + nb.
__device__ __forceinline__ void chan(float na, float& ma, float& m2a,
                                     float nb, float mb, float m2b) {
  if (nb == 0.0f) return;
  const float d = mb - ma;
  const float f = nb / (na + nb);
  ma = ma + d * f;
  m2a = m2a + m2b + d * d * na * f;
}

// The threads of each channel group hold (n, mean[V], m2[V]) for their
// rows; on return the group's row-0 thread holds the block's, merged in a
// fixed tree. All threads must call it.
template <int V>
__device__ void block_merge(float& n, float (&mean)[V], float (&m2)[V],
                            int row, int step, int lanes) {
  __shared__ float s_n[kThreads];
  __shared__ float s_mean[kThreads * 8];
  __shared__ float s_m2[kThreads * 8];
  const int t = threadIdx.x;
  s_n[t] = n;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_mean[t * V + j] = mean[j];
    s_m2[t * V + j] = m2[j];
  }
  __syncthreads();
  for (int s = step / 2; s >= 1; s /= 2) {
    if (row < s) {
      const int o = t + s * lanes;
      const float nb = s_n[o];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        chan(n, mean[j], m2[j], nb, s_mean[o * V + j], s_m2[o * V + j]);
      }
      n += nb;
      s_n[t] = n;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s_mean[t * V + j] = mean[j];
        s_m2[t * V + j] = m2[j];
      }
    }
    __syncthreads();
  }
}

// The same for K plain sums a channel: on return the row-0 thread of each
// group holds the block's sums, added in a fixed tree.
template <int V, int K>
__device__ void block_sum(float (&acc)[K][V], int row, int step,
                          int lanes) {
  __shared__ float s_acc[K * kThreads * 8];
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) s_acc[(k * kThreads + t) * V + j] = acc[k][j];
  }
  __syncthreads();
  for (int s = step / 2; s >= 1; s /= 2) {
    if (row < s) {
      const int o = t + s * lanes;
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc[k][j] += s_acc[(k * kThreads + o) * V + j];
          s_acc[(k * kThreads + t) * V + j] = acc[k][j];
        }
      }
    }
    __syncthreads();
  }
}

// The normalised input of one element: t = x + b, relu'd for "relu_bn".
template <int ORDER>
__device__ __forceinline__ float pre(float x, float b) {
  const float t = x + b;
  return ORDER == kReluBn ? fmaxf(t, 0.0f) : t;
}

// Pass 1 of the training forward: each block's (mean, M2) of the normalised
// input per channel -> part_mean, part_m2 [G, C].
template <typename T, int ORDER>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_stats_kernel(const T* __restrict__ x, const float* __restrict__ b,
                        float* __restrict__ part_mean,
                        float* __restrict__ part_m2, long long m, int c) {
  constexpr int V = Pack<T>::N;
  const Lane<T> lane(c);
  const Rows rows(m, blockIdx.x, gridDim.x);
  float bias[V], mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    bias[j] = b ? b[lane.c0 + j] : 0.0f;
    mean[j] = 0.0f;
    m2[j] = 0.0f;
  }
  float n = 0.0f;
  for (long long r0 = rows.lo + lane.row; r0 < rows.hi;
       r0 += static_cast<long long>(lane.step) * kStatsUnroll) {
    uint4 raw[kStatsUnroll];
#pragma unroll
    for (int u = 0; u < kStatsUnroll; ++u) {
      const long long r = r0 + static_cast<long long>(u) * lane.step;
      if (r < rows.hi) raw[u] = load16(x + r * c + lane.c0);
    }
#pragma unroll
    for (int u = 0; u < kStatsUnroll; ++u) {
      if (r0 + static_cast<long long>(u) * lane.step >= rows.hi) break;
      float v[V];
      Pack<T>::unpack(raw[u], v);
      n += 1.0f;
      const float rn = __frcp_rn(n);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = pre<ORDER>(v[j], bias[j]);
        const float d = t - mean[j];
        mean[j] += d * rn;
        m2[j] += d * (t - mean[j]);
      }
    }
  }
  block_merge<V>(n, mean, m2, lane.row, lane.step, c / V);
  if (lane.row == 0) {
    float* pm = part_mean + static_cast<long long>(blockIdx.x) * c + lane.c0;
    float* p2 = part_m2 + static_cast<long long>(blockIdx.x) * c + lane.c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      pm[j] = mean[j];
      p2[j] = m2[j];
    }
  }
}

// Merge of the statistics: a channel's G partials (block g counts its rows)
// in a fixed order -> mean and biased variance [C]; the running statistics,
// if given, become keep * old + (1 - keep) * new, rounded as
// running.mul_(keep).add_(momentum * new) rounds.
__global__ void __launch_bounds__(kSlices * kMergeChannels)
    bn_act_merge_kernel(const float* __restrict__ part_mean,
                        const float* __restrict__ part_m2, long long m,
                        int c, int blocks, float* __restrict__ mean_out,
                        float* __restrict__ var_out,
                        float* __restrict__ running_mean,
                        float* __restrict__ running_var, float keep,
                        float momentum) {
  __shared__ float s_n[kSlices][kMergeChannels];
  __shared__ float s_mean[kSlices][kMergeChannels];
  __shared__ float s_m2[kSlices][kMergeChannels];
  const int lc = threadIdx.x % kMergeChannels;
  const int s = threadIdx.x / kMergeChannels;
  const int ch = blockIdx.x * kMergeChannels + lc;
  // slice s merges partials s, s + kSlices, ... in order, all loaded first
  float pm[kPerSlice], p2[kPerSlice];
#pragma unroll
  for (int k = 0; k < kPerSlice; ++k) {
    const int g = s + k * kSlices;
    const bool ok = ch < c && g < blocks;
    pm[k] = ok ? part_mean[static_cast<long long>(g) * c + ch] : 0.0f;
    p2[k] = ok ? part_m2[static_cast<long long>(g) * c + ch] : 0.0f;
  }
  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerSlice; ++k) {
    const int g = s + k * kSlices;
    if (g < blocks) {
      const float ng = static_cast<float>(m * (g + 1) / blocks -
                                          m * g / blocks);
      chan(n, mean, m2, ng, pm[k], p2[k]);
      n += ng;
    }
  }
  s_n[s][lc] = n;
  s_mean[s][lc] = mean;
  s_m2[s][lc] = m2;
  __syncthreads();
  for (int h = kSlices / 2; h >= 1; h /= 2) {
    if (s < h) {
      chan(n, mean, m2, s_n[s + h][lc], s_mean[s + h][lc], s_m2[s + h][lc]);
      n += s_n[s + h][lc];
      s_n[s][lc] = n;
      s_mean[s][lc] = mean;
      s_m2[s][lc] = m2;
    }
    __syncthreads();
  }
  if (s == 0 && ch < c) {
    const float var = fmaxf(m2 / static_cast<float>(m), 0.0f);
    mean_out[ch] = mean;
    var_out[ch] = var;
    if (running_mean) {
      running_mean[ch] = __fadd_rn(__fmul_rn(running_mean[ch], keep),
                                   __fmul_rn(momentum, mean));
      running_var[ch] = __fadd_rn(__fmul_rn(running_var[ch], keep),
                                  __fmul_rn(momentum, var));
    }
  }
}

// The forward's elementwise pass (training and evaluation): z from x and
// the statistics given.
template <typename T, int ORDER>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_apply_kernel(const T* __restrict__ x, const float* __restrict__ b,
                        const float* __restrict__ mean_in,
                        const float* __restrict__ var_in,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ z,
                        long long m, int c, float eps) {
  constexpr int V = Pack<T>::N;
  const Lane<T> lane(c);
  const Rows rows(m, blockIdx.x, gridDim.x);
  float bias[V], mu[V], sc[V], sh[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = lane.c0 + j;
    bias[j] = b ? b[ch] : 0.0f;
    mu[j] = mean_in[ch];
    sc[j] = gamma[ch] * inv_std(var_in[ch], eps);
    sh[j] = beta[ch];
  }
  for (long long r0 = rows.lo + lane.row; r0 < rows.hi;
       r0 += static_cast<long long>(lane.step) * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + static_cast<long long>(u) * lane.step;
      if (r < rows.hi) raw[u] = load16(x + r * c + lane.c0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + static_cast<long long>(u) * lane.step;
      if (r >= rows.hi) break;
      float v[V];
      Pack<T>::unpack(raw[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float y = (pre<ORDER>(v[j], bias[j]) - mu[j]) * sc[j] + sh[j];
        v[j] = ORDER == kBnGelu ? gelu(y) : y;
      }
      store16(z + r * c + lane.c0, Pack<T>::pack(v));
    }
  }
}

// Pass 1 of the backward: per block and channel, the sums of dy and of
// dy (p - mean), p the normalised input and dy the gradient of the
// BatchNorm's output (dz times GELU's derivative for "bn_gelu", dz for
// "relu_bn") -> part1, part2 [G, C].
template <typename T, int ORDER>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_reduce_kernel(const T* __restrict__ dz, const T* __restrict__ x,
                         const float* __restrict__ b,
                         const float* __restrict__ mean_in,
                         const float* __restrict__ var_in,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         float* __restrict__ part1, float* __restrict__ part2,
                         long long m, int c, float eps) {
  constexpr int V = Pack<T>::N;
  const Lane<T> lane(c);
  const Rows rows(m, blockIdx.x, gridDim.x);
  float bias[V], mu[V], sc[V], sh[V], acc[2][V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = lane.c0 + j;
    bias[j] = b ? b[ch] : 0.0f;
    mu[j] = mean_in[ch];
    sc[j] = gamma[ch] * inv_std(var_in[ch], eps);
    sh[j] = beta[ch];
    acc[0][j] = 0.0f;
    acc[1][j] = 0.0f;
  }
  for (long long r0 = rows.lo + lane.row; r0 < rows.hi;
       r0 += static_cast<long long>(lane.step) * kUnroll) {
    uint4 graw[kUnroll], xraw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + static_cast<long long>(u) * lane.step;
      if (r < rows.hi) {
        graw[u] = load16(dz + r * c + lane.c0);
        xraw[u] = load16(x + r * c + lane.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r0 + static_cast<long long>(u) * lane.step >= rows.hi) break;
      float g[V], v[V];
      Pack<T>::unpack(graw[u], g);
      Pack<T>::unpack(xraw[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xm = pre<ORDER>(v[j], bias[j]) - mu[j];
        const float dy =
            ORDER == kBnGelu ? g[j] * gelu_grad(xm * sc[j] + sh[j]) : g[j];
        acc[0][j] += dy;
        acc[1][j] += dy * xm;
      }
    }
  }
  block_sum<V, 2>(acc, lane.row, lane.step, c / V);
  if (lane.row == 0) {
    const long long o = static_cast<long long>(blockIdx.x) * c + lane.c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part1[o + j] = acc[0][j];
      part2[o + j] = acc[1][j];
    }
  }
}

// Merge of plain sums: a channel's G partials of part1 (and part2) in a
// fixed order. With part2 (the backward's two sums): d_beta = S1,
// d_gamma = S2 r, and the dx pass's coefficients c1 = S1 / M and
// c2 = S2 r^2 / M (zeros when `batch` is 0: the evaluation's statistics do
// not depend on x). Without it (the conv bias's gradient): out1 = S1.
__global__ void __launch_bounds__(kSlices * kMergeChannels)
    bn_act_sums_kernel(const float* __restrict__ part1,
                       const float* __restrict__ part2, long long m, int c,
                       int blocks, const float* __restrict__ var_in,
                       float eps, int batch, float* __restrict__ out1,
                       float* __restrict__ out2, float* __restrict__ c1,
                       float* __restrict__ c2) {
  __shared__ float s_acc[2][kSlices][kMergeChannels];
  const int lc = threadIdx.x % kMergeChannels;
  const int s = threadIdx.x / kMergeChannels;
  const int ch = blockIdx.x * kMergeChannels + lc;
  // slice s adds partials s, s + kSlices, ... in order, all loaded first
  float q1[kPerSlice], q2[kPerSlice];
#pragma unroll
  for (int k = 0; k < kPerSlice; ++k) {
    const int g = s + k * kSlices;
    const bool ok = ch < c && g < blocks;
    q1[k] = ok ? part1[static_cast<long long>(g) * c + ch] : 0.0f;
    q2[k] = ok && part2 ? part2[static_cast<long long>(g) * c + ch] : 0.0f;
  }
  float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerSlice; ++k) {
    a1 += q1[k];
    a2 += q2[k];
  }
  s_acc[0][s][lc] = a1;
  s_acc[1][s][lc] = a2;
  __syncthreads();
  for (int h = kSlices / 2; h >= 1; h /= 2) {
    if (s < h) {
      a1 += s_acc[0][s + h][lc];
      a2 += s_acc[1][s + h][lc];
      s_acc[0][s][lc] = a1;
      s_acc[1][s][lc] = a2;
    }
    __syncthreads();
  }
  if (s == 0 && ch < c) {
    out1[ch] = a1;
    if (part2) {
      const float r = inv_std(var_in[ch], eps);
      const float inv_m = 1.0f / static_cast<float>(m);
      out2[ch] = a2 * r;
      c1[ch] = batch ? a1 * inv_m : 0.0f;
      c2[ch] = batch ? a2 * r * r * inv_m : 0.0f;
    }
  }
}

// Pass 2 of the backward: dx = gamma r (dy - c1 - (p - mean) c2), times
// relu'(t) for "relu_bn"; with part_db, each block's sums of dx (f32,
// before rounding) per channel -> part_db [G, C], the conv bias's gradient.
template <typename T, int ORDER>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_elemt_kernel(const T* __restrict__ dz, const T* __restrict__ x,
                        const float* __restrict__ b,
                        const float* __restrict__ mean_in,
                        const float* __restrict__ var_in,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const float* __restrict__ c1,
                        const float* __restrict__ c2, T* __restrict__ dx,
                        float* __restrict__ part_db, long long m, int c,
                        float eps) {
  constexpr int V = Pack<T>::N;
  const Lane<T> lane(c);
  const Rows rows(m, blockIdx.x, gridDim.x);
  float bias[V], mu[V], sc[V], sh[V], k1[V], k2[V], acc[1][V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = lane.c0 + j;
    bias[j] = b ? b[ch] : 0.0f;
    mu[j] = mean_in[ch];
    sc[j] = gamma[ch] * inv_std(var_in[ch], eps);
    sh[j] = beta[ch];
    k1[j] = c1[ch];
    k2[j] = c2[ch];
    acc[0][j] = 0.0f;
  }
  for (long long r0 = rows.lo + lane.row; r0 < rows.hi;
       r0 += static_cast<long long>(lane.step) * kUnroll) {
    uint4 graw[kUnroll], xraw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + static_cast<long long>(u) * lane.step;
      if (r < rows.hi) {
        graw[u] = load16(dz + r * c + lane.c0);
        xraw[u] = load16(x + r * c + lane.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + static_cast<long long>(u) * lane.step;
      if (r >= rows.hi) break;
      float g[V], v[V];
      Pack<T>::unpack(graw[u], g);
      Pack<T>::unpack(xraw[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = v[j] + bias[j];
        const float xm = pre<ORDER>(v[j], bias[j]) - mu[j];
        const float dy =
            ORDER == kBnGelu ? g[j] * gelu_grad(xm * sc[j] + sh[j]) : g[j];
        float d = sc[j] * (dy - k1[j] - xm * k2[j]);
        if (ORDER == kReluBn && !(t > 0.0f)) d = 0.0f;
        acc[0][j] += d;
        v[j] = d;
      }
      store16(dx + r * c + lane.c0, Pack<T>::pack(v));
    }
  }
  if (part_db) {
    block_sum<V, 1>(acc, lane.row, lane.step, c / V);
    if (lane.row == 0) {
      const long long o = static_cast<long long>(blockIdx.x) * c + lane.c0;
#pragma unroll
      for (int j = 0; j < V; ++j) part_db[o + j] = acc[0][j];
    }
  }
}

// The shapes every streaming pass takes: C a multiple of the 16-byte group
// whose lane count divides the block, 1 <= G <= kMaxBlocks, aligned rows.
bool shape_ok(long long m, int c, int blocks, int v) {
  if (m < 1 || c < v || c % v != 0 || blocks < 1 || blocks > kMaxBlocks ||
      blocks > m) {
    return false;
  }
  const int lanes = c / v;
  return kThreads % lanes == 0;
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

// x, dz, z, dx: [m, c] of bf16 (is_bf16) or f32, 16-byte aligned; b (may be
// null), gamma, beta, the statistics and c1, c2: f32 [c]; part_*: f32
// [blocks, c]. order: 0 "bn_gelu", 1 "relu_bn". Each returns a cudaError_t.
extern "C" int bn_act_stats_launch(const void* x, const float* b,
                                   float* part_mean, float* part_m2,
                                   long long m, int c, int blocks,
                                   int is_bf16, int order, void* stream) {
  const int v = is_bf16 ? 8 : 4;
  if (!shape_ok(m, c, blocks, v) || (order != kBnGelu && order != kReluBn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = as_stream(stream);
#define BN_ACT_STATS(T, O)                                            \
  bn_act_stats_kernel<T, O><<<blocks, kThreads, 0, s>>>(              \
      static_cast<const T*>(x), b, part_mean, part_m2, m, c)
  if (is_bf16) {
    if (order == kBnGelu) BN_ACT_STATS(__nv_bfloat16, kBnGelu);
    else BN_ACT_STATS(__nv_bfloat16, kReluBn);
  } else {
    if (order == kBnGelu) BN_ACT_STATS(float, kBnGelu);
    else BN_ACT_STATS(float, kReluBn);
  }
#undef BN_ACT_STATS
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_act_merge_launch(const float* part_mean,
                                   const float* part_m2, long long m, int c,
                                   int blocks, float* mean_out,
                                   float* var_out, float* running_mean,
                                   float* running_var, float keep,
                                   float momentum, void* stream) {
  if (m < 1 || c < 1 || blocks < 1 || blocks > kMaxBlocks ||
      (running_mean == nullptr) != (running_var == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (c + kMergeChannels - 1) / kMergeChannels;
  bn_act_merge_kernel<<<grid, kSlices * kMergeChannels, 0,
                        as_stream(stream)>>>(
      part_mean, part_m2, m, c, blocks, mean_out, var_out, running_mean,
      running_var, keep, momentum);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_act_apply_launch(const void* x, const float* b,
                                   const float* mean, const float* var,
                                   const float* gamma, const float* beta,
                                   void* z, long long m, int c, int blocks,
                                   float eps, int is_bf16, int order,
                                   void* stream) {
  const int v = is_bf16 ? 8 : 4;
  if (!shape_ok(m, c, blocks, v) || (order != kBnGelu && order != kReluBn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = as_stream(stream);
#define BN_ACT_APPLY(T, O)                                                \
  bn_act_apply_kernel<T, O><<<blocks, kThreads, 0, s>>>(                  \
      static_cast<const T*>(x), b, mean, var, gamma, beta,                \
      static_cast<T*>(z), m, c, eps)
  if (is_bf16) {
    if (order == kBnGelu) BN_ACT_APPLY(__nv_bfloat16, kBnGelu);
    else BN_ACT_APPLY(__nv_bfloat16, kReluBn);
  } else {
    if (order == kBnGelu) BN_ACT_APPLY(float, kBnGelu);
    else BN_ACT_APPLY(float, kReluBn);
  }
#undef BN_ACT_APPLY
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_act_reduce_launch(const void* dz, const void* x,
                                    const float* b, const float* mean,
                                    const float* var, const float* gamma,
                                    const float* beta, float* part1,
                                    float* part2, long long m, int c,
                                    int blocks, float eps, int is_bf16,
                                    int order, void* stream) {
  const int v = is_bf16 ? 8 : 4;
  if (!shape_ok(m, c, blocks, v) || (order != kBnGelu && order != kReluBn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = as_stream(stream);
#define BN_ACT_REDUCE(T, O)                                               \
  bn_act_reduce_kernel<T, O><<<blocks, kThreads, 0, s>>>(                 \
      static_cast<const T*>(dz), static_cast<const T*>(x), b, mean, var,  \
      gamma, beta, part1, part2, m, c, eps)
  if (is_bf16) {
    if (order == kBnGelu) BN_ACT_REDUCE(__nv_bfloat16, kBnGelu);
    else BN_ACT_REDUCE(__nv_bfloat16, kReluBn);
  } else {
    if (order == kBnGelu) BN_ACT_REDUCE(float, kBnGelu);
    else BN_ACT_REDUCE(float, kReluBn);
  }
#undef BN_ACT_REDUCE
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_act_sums_launch(const float* part1, const float* part2,
                                  long long m, int c, int blocks,
                                  const float* var, float eps, int batch,
                                  float* out1, float* out2, float* c1,
                                  float* c2, void* stream) {
  if (m < 1 || c < 1 || blocks < 1 || blocks > kMaxBlocks ||
      (part2 && !(var && out2 && c1 && c2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (c + kMergeChannels - 1) / kMergeChannels;
  bn_act_sums_kernel<<<grid, kSlices * kMergeChannels, 0,
                       as_stream(stream)>>>(part1, part2, m, c, blocks, var,
                                            eps, batch, out1, out2, c1, c2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_act_elemt_launch(const void* dz, const void* x,
                                   const float* b, const float* mean,
                                   const float* var, const float* gamma,
                                   const float* beta, const float* c1,
                                   const float* c2, void* dx,
                                   float* part_db, long long m, int c,
                                   int blocks, float eps, int is_bf16,
                                   int order, void* stream) {
  const int v = is_bf16 ? 8 : 4;
  if (!shape_ok(m, c, blocks, v) || (order != kBnGelu && order != kReluBn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = as_stream(stream);
#define BN_ACT_ELEMT(T, O)                                                \
  bn_act_elemt_kernel<T, O><<<blocks, kThreads, 0, s>>>(                  \
      static_cast<const T*>(dz), static_cast<const T*>(x), b, mean, var,  \
      gamma, beta, c1, c2, static_cast<T*>(dx), part_db, m, c, eps)
  if (is_bf16) {
    if (order == kBnGelu) BN_ACT_ELEMT(__nv_bfloat16, kBnGelu);
    else BN_ACT_ELEMT(__nv_bfloat16, kReluBn);
  } else {
    if (order == kBnGelu) BN_ACT_ELEMT(float, kBnGelu);
    else BN_ACT_ELEMT(float, kReluBn);
  }
#undef BN_ACT_ELEMT
  return static_cast<int>(cudaGetLastError());
}
