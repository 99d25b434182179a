// Kernel A: the tuning-estimate tail (librosa estimate_tuning after
// piptrack), one block of 1,024 threads per clip.
//
// Replaces tpu_breath/ops/pallas/tuning_kernel.py::estimate_tuning_index_pallas
// (its pallas_call at :125; XLA twin ops/chroma.py::estimate_tuning_index).
// Per clip:
//   1. masked median of mags where pitch > 0: ranks (k-1)//2 and k//2 of the
//      order-preserving u32 keys (masked pairs key as +inf);
//   2. sel = pitch > 0 && mag >= median;
//   3. residual = mod(bpo * f32(log2(f32(pitch / 27.5))), 1) in [-0.5, 0.5),
//      the divide and log2 in float64 rounded once to f32 (correctly rounded,
//      which is what the TPU's double-float dd.div_cr / dd.log2_cr emulate);
//   4. 100-bin histogram against np.histogram's exact f32 edges, first-max
//      argmax, 50 when nothing is selected.
//
// What bounds it on the H100: the bytes are 63 KB (bpo 12) and 126 KB
// (bpo 36) of (pitch, mag) pairs per clip, read once, one int out: 7.2 us
// for both calls at B = 128 at 3.35 TB/s, 0.5 us at B = 8. A block per clip
// is latency bound: its time is the chain of block-wide barriers between
// the passes over the keys, and that chain is the same at B = 8 and 128.
//
// Design: the block first compacts the clip's valid pairs (pitch > 0) into
// shared memory, (key, pitch) at 8 bytes a pair, one slot per valid pair,
// taken by one atomic per warp; the masked pairs stay a count, keyed +inf.
// Every later pass reads only the k valid pairs. A clip of more than
// kSmemPairs pairs (about 1.7 s of audio at n_fft 2048; the main path's 1 s
// clips have 7,875 and 15,808) keeps its list in device memory (a scratch
// the wrapper allocates, 8 bytes a pair) in a second instantiation, chosen
// on the host, so the main path keeps its code. Rank (k-1)//2 is found by
// 4 radix passes of 8 bits: each pass counts the keys that match the digits
// fixed so far into a 256-bin shared histogram, one atomic per distinct
// digit in a warp (__match_any_sync), and one warp scans the 256 counts to
// fix the next digit. Rank k//2 differs from it by at most one: one pass
// counts the keys <= the low key and takes the least key above it, one
// block reduction of both: the two order statistics cost 14 barriers, not
// the 96 of a 32-step bit descent. The histogram's first-max argmax is one
// warp reduction, the lower bin winning ties. The residual arithmetic is
// the plain version's, op for op, so the index is exactly equal to it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 100;
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;
constexpr int kBatch = 8;  // pairs a thread loads at once
constexpr uint32_t kInfKey = 0xff800000u;  // the key of +inf
// pairs a clip whose compacted list stays in shared memory: 8 bytes a
// pair, under the 227 KB cap (the wrapper's SMEM_PAIRS)
constexpr int kSmemPairs = 28000;

__device__ __forceinline__ uint32_t ordered_u32(float x) {
  int32_t b = __float_as_int(x);
  return static_cast<uint32_t>(b < 0 ? ~b : (b ^ INT32_MIN));
}

__device__ __forceinline__ float u32_f32(uint32_t u) {
  int32_t i = static_cast<int32_t>(u);
  return __int_as_float(i < 0 ? (i ^ INT32_MIN) : ~i);
}

// Sum of an int and min of a u32 over the block; every thread gets both.
// red holds kWarps int2.
__device__ __forceinline__ int2 block_sum_min(int s, uint32_t m, int2* red) {
  s = __reduce_add_sync(0xffffffffu, s);
  m = __reduce_min_sync(0xffffffffu, m);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = make_int2(s, static_cast<int>(m));
  __syncthreads();
  const int2 w = red[lane];  // kWarps == 32
  const int2 total = make_int2(
      __reduce_add_sync(0xffffffffu, w.x),
      static_cast<int>(__reduce_min_sync(0xffffffffu,
                                         static_cast<uint32_t>(w.y))));
  __syncthreads();  // red is reused by the next call
  return total;
}

// The key of rank `rank` (0-based, ascending) among the block's k keys in
// shared memory and n_inf more keys of +inf, by radix digits from the top.
// hist holds kRadix ints, bcast 2.
__device__ __forceinline__ uint32_t select_rank(const uint32_t* keys, int k,
                                                int n_inf, int rank,
                                                int* hist, int* bcast) {
  uint32_t prefix = 0, fixed = 0;
#pragma unroll
  for (int shift = 32 - kDigitBits; shift >= 0; shift -= kDigitBits) {
    if (threadIdx.x < kRadix) hist[threadIdx.x] = 0;
    __syncthreads();
    if (threadIdx.x == 0 && n_inf > 0 && (kInfKey & fixed) == prefix) {
      atomicAdd(&hist[(kInfKey >> shift) & (kRadix - 1)], n_inf);
    }
    for (int i0 = 0; i0 < k; i0 += kThreads) {  // uniform trip count
      const int i = i0 + threadIdx.x;
      const uint32_t key = i < k ? keys[i] : 0u;
      const bool live = i < k && (key & fixed) == prefix;
      const uint32_t digit = (key >> shift) & (kRadix - 1);
      const unsigned active = __ballot_sync(0xffffffffu, live);
      if (live) {
        const unsigned peers = __match_any_sync(active, digit);
        if ((threadIdx.x & 31) == __ffs(peers) - 1) {
          atomicAdd(&hist[digit], __popc(peers));
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // lane owns bins 8 * lane .. 8 * lane + 7
      const int lane = threadIdx.x;
      int c[kRadix / 32], s = 0;
#pragma unroll
      for (int q = 0; q < kRadix / 32; ++q) s += c[q] = hist[lane * 8 + q];
      int incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      int below = incl - s;
      const unsigned hit =
          __ballot_sync(0xffffffffu, below <= rank && rank < incl);
      if (lane == __ffs(hit) - 1) {  // the first of its bins past rank
        int q = 0;
        bool past = false;
#pragma unroll
        for (int j = 0; j < kRadix / 32; ++j) {
          past = past || below + c[j] > rank;
          if (!past) {
            below += c[j];
            ++q;
          }
        }
        bcast[0] = lane * 8 + q;
        bcast[1] = rank - below;
      }
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(bcast[0]) << shift;
    fixed |= static_cast<uint32_t>(kRadix - 1) << shift;
    rank = bcast[1];
  }
  return prefix;
}

// kGlobal: the compacted pairs in `scratch` ([B, 2n] words, the clip's part
// at blockIdx.x * 2n) instead of dynamic shared memory: a clip of more than
// kSmemPairs pairs. The code is the same either way.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
tuning_tail_kernel(const float* __restrict__ pitches,
                   const float* __restrict__ mags,
                   const float* __restrict__ edges,  // [kBins + 1]
                   int* __restrict__ out, uint32_t* scratch, int n,
                   float bpo) {
  extern __shared__ uint32_t smem[];
  uint32_t* keys;  // [n], k used
  float* pit;      // [n], k used
  if constexpr (kGlobal) {
    keys = scratch + 2 * static_cast<size_t>(blockIdx.x) * n;
  } else {
    keys = smem;
  }
  pit = reinterpret_cast<float*>(keys + n);
  __shared__ int hist[kRadix];  // radix counts, then the 100-bin histogram
  __shared__ int2 red[kWarps];
  __shared__ int bcast[2];
  __shared__ int count;
  __shared__ float sedges[kBins + 1];

  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) count = 0;
  if (threadIdx.x <= kBins) sedges[threadIdx.x] = edges[threadIdx.x];
  __syncthreads();
  // compact the valid pairs: kBatch loads a thread in flight, then one slot
  // range a warp
  for (int i0 = 0; i0 < n; i0 += kBatch * kThreads) {  // uniform trip count
    float p[kBatch], m[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads + threadIdx.x;
      p[j] = i < n ? pitches[base + i] : 0.0f;
      m[j] = i < n ? mags[base + i] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool valid = p[j] > 0.0f;
      const unsigned vote = __ballot_sync(0xffffffffu, valid);
      int slot = 0;
      if (lane == 0 && vote) slot = atomicAdd(&count, __popc(vote));
      slot = __shfl_sync(0xffffffffu, slot, 0) +
             __popc(vote & ((1u << lane) - 1u));
      if (valid) {
        keys[slot] = ordered_u32(m[j]);
        pit[slot] = p[j];
      }
    }
  }
  __syncthreads();
  const int k = count, n_inf = n - k;

  // exact order statistics: ranks (k-1)//2 and k//2 of the masked keys
  float thresh = 0.0f;
  if (k > 0) {
    const int rank_lo = (k - 1) / 2, rank_hi = k / 2;
    const uint32_t lo = select_rank(keys, k, n_inf, rank_lo, hist, bcast);
    uint32_t hi = lo;
    if (rank_hi != rank_lo) {
      int le = 0;
      uint32_t above = 0xffffffffu;
      for (int i = threadIdx.x; i < k; i += kThreads) {
        if (keys[i] <= lo) ++le; else above = min(above, keys[i]);
      }
      if (threadIdx.x == 0 && n_inf > 0) {
        if (kInfKey <= lo) le += n_inf; else above = min(above, kInfKey);
      }
      const int2 r = block_sum_min(le, above, red);
      hi = r.x > rank_hi ? lo : static_cast<uint32_t>(r.y);
    }
    thresh = __fmul_rn(0.5f, __fadd_rn(u32_f32(lo), u32_f32(hi)));
  }

  if (threadIdx.x < kBins) hist[threadIdx.x] = 0;
  __syncthreads();
  int sel_local = 0;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const float p = pit[i];  // > 0: only valid pairs were kept
    if (!(u32_f32(keys[i]) >= thresh)) continue;
    ++sel_local;
    const float q = __double2float_rn(__ddiv_rn(static_cast<double>(p), 27.5));
    const float octs = __double2float_rn(log2(static_cast<double>(q)));
    float r = fmodf(__fmul_rn(bpo, octs), 1.0f);  // exact, sign of dividend
    if (r != 0.0f && r < 0.0f) r = __fadd_rn(r, 1.0f);  // jnp.mod: sign of 1
    if (r >= 0.5f) r = __fsub_rn(r, 1.0f);
    if (!(r >= sedges[0]) || !(r < sedges[kBins])) continue;
    int lo = 0, hi = kBins;  // edges[lo] <= r < edges[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (r >= sedges[mid]) lo = mid; else hi = mid;
    }
    atomicAdd(&hist[lo], 1);
  }
  const int any_sel = __syncthreads_or(sel_local);
  if (threadIdx.x < 32) {  // first-max argmax: lane scans bins lane + 32 q
    int best = threadIdx.x, cnt = -1;
    for (int b = threadIdx.x; b < kBins; b += 32) {
      if (hist[b] > cnt) { cnt = hist[b]; best = b; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int oc = __shfl_xor_sync(0xffffffffu, cnt, off);
      const int ob = __shfl_xor_sync(0xffffffffu, best, off);
      if (oc > cnt || (oc == cnt && ob < best)) { cnt = oc; best = ob; }
    }
    if (threadIdx.x == 0) out[blockIdx.x] = any_sel ? best : kBins / 2;
  }
}

}  // namespace

// scratch: null for n <= kSmemPairs, else [b, 2n] 4-byte words.
extern "C" int tuning_index_launch(const float* pitches, const float* mags,
                                   const float* edges, int* out,
                                   uint32_t* scratch, int b, int n, int bpo,
                                   void* stream) {
  if (n < 0 || (n > kSmemPairs) != (scratch != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch != nullptr) {
    if (b == 0) return 0;
    tuning_tail_kernel<true><<<b, kThreads, 0, s>>>(
        pitches, mags, edges, out, scratch, n, static_cast<float>(bpo));
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(n) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      tuning_tail_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  tuning_tail_kernel<false><<<b, kThreads, smem, s>>>(
      pitches, mags, edges, out, nullptr, n, static_cast<float>(bpo));
  return static_cast<int>(cudaGetLastError());
}
