// Direct |CQT| at tuning 0:
//   out[b, k, t] = | sum_l ypad[b, hop*t + l] * K[k, l] |      [B, K, T]
// with ypad = y padded by `half` zeros on the left and K the conjugate
// wavelet bank with 1/sqrt(length) folded in.
//
// Replaces tpu_breath/ops/pallas/cqt_kernel.py::cqt_mag_pallas (its
// _cqt_kernel, :55-76): there the grid walks 100 bank tiles of 256 samples
// in order, carrying the complex sums in VMEM scratch across grid steps.
// Here no state crosses blocks or warps: a warp computes a work item whole.
//
// What bounds it: f32 FMAs on the CUDA cores. Per clip 2 (re, im) FMAs for
// each frame and bank entry whose sample of ypad lies in the clip: each
// bin's kernel is a centred window of its own length (25,412 samples at C1
// down to 202 at the top bin, 1.32 M of the 6.5 M bank entries at 252
// bins), and of a frame's window only the part over the clip's 16,000
// samples is not zero (80% of windows x frames at hop 256): 265 MFLOP a
// clip, at 67 TFLOP/s. The bank (10.6 MB of nonzero entries) stays in the
// 50 MB L2.
//
// Design:
// - A work item is a group of kBins adjacent bins over a group of kFrames
//   frames, summed by one warp. Adjacent bins' windows nest around the same
//   centre, so the item runs over its group's widest window, clipped to the
//   samples where one of its frames meets the clip; the narrower members'
//   extra terms multiply zeros of the bank and add exact zeros. The lanes
//   split the range (lane i takes l = l0 + i + 32 s, in order) and each
//   keeps the item's kBins x kFrames complex sums in f32 registers (128, at
//   most ~620 terms each at hop 256): each signal value read from shared
//   memory feeds 2 kBins FMAs and each bank value in a register kFrames.
// - At small B the longest items are cut into two halves of kFrames / 2
//   frames over the same samples (each output's sum unchanged), so that one
//   item does not set the pace (work_table).
// - The bank comes packed by group (ops/cuda/cqt_kernel.py, packed_bank):
//   for each l of the group's window the kBins re then the kBins im values,
//   32 bytes, so a lane reads its step's bank by two 16-byte loads and a
//   warp a contiguous KB, kAhead steps ahead of the FMAs that use it: an
//   L2 read takes longer than two steps at B = 128 (3 steps ahead measured
//   8% faster than 2, 4 no faster than 3; kAheadHalf below).
// - The items come from a table built on the host (work_table), dealt to
//   `shares` blocks a clip by cost, longest first to the least loaded warp:
//   at B = 8 16 blocks share a clip, at B >= 67 a block takes a whole clip;
//   one block an SM (its registers).
// - Each block stages its clip's samples once in shared memory with
//   kFrames - 1 hops of zeros on each side (23,712 floats at hop 256,
//   95 KB), which every item of the clip reads; the padding of ypad beyond
//   that is never read. A row too long for shared memory (past ~50,000
//   samples at hop 256; the main path's clips are 16,000) takes a second
//   instantiation (kGlobal, chosen on the host, the hop at run time), which
//   reads the same staged row from device memory, padded by the wrapper:
//   the main path keeps its code.
// - The lanes' partial sums are reduced in float64 by a butterfly that
//   halves the values a lane holds at each of its 5 steps (xor 16, 8, 4, 2,
//   1), so a lane ends with the (re, im) sums of 1 or 2 outputs; each
//   output's sum is the same tree of the same partials whichever lane holds
//   it. The magnitude is taken in float64 and rounded once.
// - An item's arithmetic depends only on its bins and frames, not on the
//   block, the warp, the cut in half or B: a clip's rows are bit-equal
//   whatever the batch.
// Its first design staged the whole padded row (167 KB, one block of
// 8 warps an SM on a grid of (B, 4)), gave each warp one bin of 64 frames
// (2 FMAs a signal load) and dealt the bins round robin; it was slower than
// its plain version at B = 8. Tried and not kept (PERF.md):
// two clips a block, their warps on the same items (slower: the L1 left
// beside two staged rows is small); the bank through a cp.async ring in
// shared memory in place of the register ring (2x slower).
#include <cuda_runtime.h>

#include "smem_once.cuh"

namespace {

// the wrapper's BINS, FRAMES and WARPS (ops/cuda/cqt_kernel.py)
constexpr int kBins = 4;      // bins an item sums
constexpr int kFrames = 16;   // frames an item sums (or half of them)
constexpr int kWarps = 8;     // warps a block
constexpr int kAhead = 3;     // steps the bank loads run ahead
// The same for half items. 7 is kept for its effect on the whole kernel's
// register allocation, not for the depth: at B = 128, where no item is cut,
// it ran 9-10% faster than 3, and 6 or 8 slower than 3 (nvcc 12.9.86, the
// build at 254 registers and 16 bytes of spill; PERF.md). A version that
// built to 255 registers and 24 bytes of spill ran 7 and 3 alike, both
// slower. Measure it again (utils/kernel_times.py) after any change to this
// file or to nvcc.
constexpr int kAheadHalf = 7;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = kBins / 2;  // 16-byte bank loads a sample
constexpr unsigned kAll = 0xffffffffu;
static_assert(kBins % 2 == 0, "a sample's bank is whole 16-byte loads");

// Component i (a compile-time constant once unrolled) of v.
__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One butterfly step: of the n values in `in` a lane keeps the upper half
// if (lane & off) else the lower, adds its partner's copy of that half and
// writes the n / 2 sums in float64 to `out`.
template <int n, class In>
__device__ __forceinline__ void halve(const In (&in)[n], double (&out)[n / 2],
                                      int off, bool up) {
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const In send = up ? in[i] : in[i + n / 2];
    const In keep = up ? in[i + n / 2] : in[i];
    out[i] = static_cast<double>(keep) +
             static_cast<double>(__shfl_xor_sync(kAll, send, off));
  }
}

// Item (k0, t0): sums for bins k0 .. k0 + kBins - 1 and frames t0 .. t0 +
// kF - 1 over `steps` steps of 32 samples. sig: the staged row at the
// item's first sample for frame t0 and lane 0; bank: the packed group at
// the item's first sample (2 kBins floats a sample). kHop > 0: the hop at
// compile time, else `hop`.
template <int kHop, int kF>
__device__ __forceinline__ void item(const float* sig,
                                     const float4* __restrict__ bank,
                                     int steps, int hop, int lane, int k0,
                                     int t0, int n_bins, int n_frames,
                                     float* __restrict__ out) {
  constexpr int kVals = 2 * kBins * kF;  // f32 sums a lane holds
  constexpr int kKept = kVals / 32;      // float64 sums it ends with
  static_assert(kKept % 2 == 0, "a lane ends with whole (re, im) pairs");
  const int h = kHop > 0 ? kHop : hop;
  float acc[kVals];  // [bin][frame][re, im]
#pragma unroll
  for (int v = 0; v < kVals; ++v) acc[v] = 0.0f;
  const float* sp = sig + lane;
  const float4* bp = bank + kVec * lane;
  constexpr int kA = kF == kFrames ? kAhead : kAheadHalf;
  float4 w[kA + 1][kVec];  // a ring of the next steps' bank
#pragma unroll
  for (int a = 0; a < kA; ++a) {
    if (a < steps) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) w[a][c] = __ldg(bp + 32 * kVec * a + c);
    }
  }
#pragma unroll 1
  for (int s = 0; s < steps; s += kA + 1) {
#pragma unroll
    for (int u = 0; u <= kA; ++u) {
      if (s + u < steps) {
        // the load kA steps on goes into the slot this step frees
        const int ahead = s + u + kA;
        const int slot = (u + kA) % (kA + 1);
        if (ahead < steps) {
#pragma unroll
          for (int c = 0; c < kVec; ++c)
            w[slot][c] = __ldg(bp + 32 * kVec * ahead + c);
        }
        float wr[kBins], wi[kBins];
#pragma unroll
        for (int j = 0; j < kBins; ++j) {
          wr[j] = part(w[u][j / 4], j % 4);
          wi[j] = part(w[u][(kBins + j) / 4], (kBins + j) % 4);
        }
        const float* row = sp + 32 * (s + u);
#pragma unroll
        for (int t = 0; t < kF; ++t) {
          const float x = row[t * h];
#pragma unroll
          for (int j = 0; j < kBins; ++j) {
            acc[(j * kF + t) * 2] = fmaf(x, wr[j], acc[(j * kF + t) * 2]);
            acc[(j * kF + t) * 2 + 1] =
                fmaf(x, wi[j], acc[(j * kF + t) * 2 + 1]);
          }
        }
      }
    }
  }
  // the butterfly: lane q ends with values kKept q .. kKept (q + 1) - 1 of
  // acc's order, the (re, im) sums of (bin, frame) = divmod(p, kF) for
  // p = kKept q / 2 ...
  double h1[kVals / 2], h2[kVals / 4], h3[kVals / 8], h4[kVals / 16],
      h5[kKept];
  halve<kVals>(acc, h1, 16, lane & 16);
  halve<kVals / 2>(h1, h2, 8, lane & 8);
  halve<kVals / 4>(h2, h3, 4, lane & 4);
  halve<kVals / 8>(h3, h4, 2, lane & 2);
  halve<kVals / 16>(h4, h5, 1, lane & 1);
#pragma unroll
  for (int o = 0; o < kKept / 2; ++o) {
    const int p = kKept / 2 * lane + o;
    const int k = k0 + p / kF, t = t0 + p % kF;
    if (k < n_bins && t < n_frames) {
      out[static_cast<size_t>(k) * n_frames + t] = static_cast<float>(
          sqrt(h5[2 * o] * h5[2 * o] + h5[2 * o + 1] * h5[2 * o + 1]));
    }
  }
}

// Grid (B, shares), the clip on x (no limit on B): block (b, p) takes clip
// b and its warp w the items of slot p * kWarps + w. table: the item
// offsets of the shares * kWarps slots
// ([shares * kWarps + 1], padded to a multiple of 4 ints), then 4 ints an
// item: k0 | t0 << 16 | half << 31 (half: the item sums kFrames / 2
// frames), the item's first sample in the staged row (for frame t0, lane
// 0), its first sample in the packed bank, steps. The staged row (dynamic
// shared memory): y[b] at [pad, pad + n), zeros in [0, pad) and
// [pad + n, sig_len). kGlobal: a row too long for shared memory; y is then
// the rows already staged so in device memory ([B, sig_len], the wrapper
// pads them), which the items read through L1 and L2.
template <int kHop, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 1)
cqt_kernel(const float* __restrict__ y,        // [B, n] or [B, sig_len]
           const float4* __restrict__ bank,    // packed, kVec float4 a sample
           const int* __restrict__ table,
           float* __restrict__ out,            // [B, n_bins, n_frames]
           int n, int pad, int sig_len, int hop, int n_bins, int n_frames) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const float* s = smem;
  if constexpr (kGlobal) {
    s = y + static_cast<size_t>(b) * sig_len;
  } else {
    const float* src = y + static_cast<size_t>(b) * n;
    const bool vec = ((n | pad) & 3) == 0 &&
                     (reinterpret_cast<size_t>(y) & 15) == 0;
    for (int i = 4 * threadIdx.x; i < sig_len; i += 4 * kThreads) {
      const int j = i - pad;
      if (vec && j >= 0 && j + 3 < n) {
        *reinterpret_cast<float4*>(smem + i) =
            __ldg(reinterpret_cast<const float4*>(src + j));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          smem[i + e] = (j + e >= 0 && j + e < n) ? src[j + e] : 0.0f;
      }
    }
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = blockIdx.y * kWarps + warp;
  const int* items = table + ((gridDim.y * kWarps + 4) & ~3);
  float* dst = out + static_cast<size_t>(b) * n_bins * n_frames;
  for (int q = table[slot]; q < table[slot + 1]; ++q) {
    const int4 it = reinterpret_cast<const int4*>(items)[q];
    const unsigned head = static_cast<unsigned>(it.x);
    const int k0 = head & 0xffffu, t0 = (head >> 16) & 0x7fffu;
    const float4* bk = bank + kVec * static_cast<size_t>(it.z);
    if (head >> 31) {
      item<kHop, kFrames / 2>(s + it.y, bk, it.w, hop, lane, k0, t0,
                              n_bins, n_frames, dst);
    } else {
      item<kHop, kFrames>(s + it.y, bk, it.w, hop, lane, k0, t0, n_bins,
                          n_frames, dst);
    }
  }
}

int g_smem[2][smem_once::kMaxDevices];  // one for each instantiation
                                        // with a staged row

template <int kHop, bool kGlobal>
cudaError_t launch(const float* y, const float4* bank, const int* table,
                   float* out, int b, int n, int pad, int sig_len, int hop,
                   int n_bins, int n_frames, int shares, cudaStream_t st) {
  const int smem = kGlobal ? 0 : sig_len * static_cast<int>(sizeof(float));
  if constexpr (!kGlobal) {
    const cudaError_t err = smem_once::raise(
        reinterpret_cast<const void*>(cqt_kernel<kHop, kGlobal>), smem,
        g_smem[kHop > 0]);
    if (err != cudaSuccess) return err;
  }
  if (b == 0) return cudaSuccess;
  cqt_kernel<kHop, kGlobal><<<dim3(b, shares), kThreads, smem, st>>>(
      y, bank, table, out, n, pad, sig_len, hop, n_bins, n_frames);
  return cudaGetLastError();
}

}  // namespace

// table's items must hold the clip's every (bin, frame) exactly once and
// stay inside the staged row and the packed bank (work_items checks).
// staged: 0, y [b, n]; 1, y the rows staged in device memory [b, sig_len]
// (a row too long for shared memory).
extern "C" int cqt_mag_launch(const float* y, const float* bank,
                              const int* table, float* out, int b, int n,
                              int pad, int sig_len, int hop, int n_bins,
                              int n_frames, int shares, int staged,
                              void* stream) {
  if (n < 1 || hop < 1 || shares < 1 || (sig_len & 3) != 0 ||
      (reinterpret_cast<size_t>(bank) & 15) != 0 ||
      (reinterpret_cast<size_t>(table) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* b4 = reinterpret_cast<const float4*>(bank);
  // the features' hop (256) at compile time, the 16 frames' offsets then
  // immediates: at B = 128 1.14 ms against 1.34 with the hop at run time
  // (the same at B = 8; PERF.md); other hops take the run-time one
  if (staged) {  // rows past shared memory: the hop at run time
    return static_cast<int>(launch<0, true>(y, b4, table, out, b, n, pad,
                                            sig_len, hop, n_bins, n_frames,
                                            shares, st));
  }
  return static_cast<int>(
      hop == 256 ? launch<256, false>(y, b4, table, out, b, n, pad, sig_len,
                                      hop, n_bins, n_frames, shares, st)
                 : launch<0, false>(y, b4, table, out, b, n, pad, sig_len,
                                    hop, n_bins, n_frames, shares, st));
}
