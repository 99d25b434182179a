// Kernel E: Burg LPC of every frame of a batch of clips, one warp a frame.
//
// Replaces no TPU kernel: the JAX package leaves the lpc stage to XLA
// (tpu_breath/ops/lpc.py). It was added because the port's eager version,
// a 12-step Python loop of float64 elementwise ops and sums over the
// [B, 98, 400] frames (ops/cuda/lpc_kernel.py::burg_lpc), moved ~11 GB of
// op traffic a 128-clip chunk through HBM (utils/feature_roofline.py) to
// write 1,176 coefficients a clip.
//
// Input: the pre-emphasised clips y [B, n] f32 and the float64 Hamming
// window w [L]; frame t of a clip is y[t hop + k] * w[k], k < L, formed as
// the plain path forms it ((double) y * w, one rounding). Output:
// [B, n_frames, order] f32, the coefficients a[1..order] of each frame,
// which the wrapper returns transposed as [B, order, n_frames]: the plain
// path's layout, so the channel's z-norm sums in the same order.
//
// What bounds it on the H100: float64 operations. A clip is read once
// (64 KB) and its coefficients written once (4.7 KB); the recursion does
// about 10 float64 operations a sample a step (three sums of products, two
// window updates): 0.58 GFLOP a 128-clip chunk, 17 us at the CUDA cores'
// 33.5 TFLOP/s against 2.6 us for the bytes. The design:
// - One warp a frame, 4 frames a block. Lane l holds samples
//   [l K, l K + K) of both windows (fwd = x[1:], bwd = x[:-1]) in
//   registers through all `order` steps, K = 13 for frames up to 417
//   samples (32 up to 1,025). Slots past a window hold exact zeros, so
//   they add nothing to a sum. Only the coefficients leave the chip.
// - The windows shrink a sample a step, as in the plain path: bwd loses its
//   last sample (zeroed in place) and fwd its first, so fwd moves down one
//   slot, and one shuffle a step brings each lane the sample that crosses
//   in from the lane above.
// - A step's three sums (bwd.fwd, fwd.fwd, bwd.bwd) are a chain over each
//   lane's own slots, then a butterfly over the warp's 32 lanes. At every
//   level a lane adds the same two values as its partner (a + b == b + a),
//   so every lane ends with the same bits, in an order fixed by L alone:
//   no atomics, and a frame's result depends neither on its clip's batch
//   position nor on B. den is the sum over the shrunk windows each step,
//   as the plain path recomputes it (not librosa's incremental update).
// - Lane j holds a[j] (order <= 31): a step's update a[j] += r a[i+1-j],
//   1 <= j <= i+1, is one shuffle of the old values.
// - A frame whose coefficients are not all finite (silence: 0 / 0) is
//   written as zeros, the plain path's failure -> zeros rule. IEEE division;
//   built without fast math.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;      // frames a block
constexpr int kMaxOrder = 31;  // lane j holds a[j]
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

template <int K>
__global__ void __launch_bounds__(32 * kWarps)
    burg_lpc_kernel(const float* __restrict__ y,
                    const double* __restrict__ w, float* __restrict__ out,
                    int n, int hop, int frame_len, int n_frames, int order,
                    long long frames) {
  const int lane = threadIdx.x & 31;
  const long long g =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (g >= frames) return;  // the whole warp
  const long long clip = g / n_frames;
  const int t = static_cast<int>(g - clip * n_frames);
  const float* x = y + clip * n + static_cast<long long>(t) * hop;
  const int m = frame_len - 1;  // the windows' length before step 0
  const int k0 = lane * K;

  double fw[K], bw[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int k = k0 + j;
    bw[j] = k < m ? static_cast<double>(x[k]) * w[k] : 0.0;
    fw[j] = k < m ? static_cast<double>(x[k + 1]) * w[k + 1] : 0.0;
  }

  double a = lane == 0 ? 1.0 : 0.0;
  for (int i = 0; i < order; ++i) {
    double dot = 0.0, ff = 0.0, bb = 0.0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      dot += bw[j] * fw[j];
      ff += fw[j] * fw[j];
      bb += bw[j] * bw[j];
    }
    dot = warp_sum(dot);
    const double den = warp_sum(ff) + warp_sum(bb);
    const double r = -2.0 * dot / den;
    const double mirror = __shfl_sync(kFull, a, (i + 1 - lane) & 31);
    if (lane >= 1 && lane <= i + 1) a += r * mirror;
    if (i + 1 == order) break;
    const int keep = m - i - 1;  // the windows' length after this step
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const double f = fw[j];
      fw[j] = f + r * bw[j];
      bw[j] = k0 + j < keep ? bw[j] + r * f : 0.0;
    }
    const double above = __shfl_down_sync(kFull, fw[0], 1);
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) fw[j] = fw[j + 1];
    fw[K - 1] = lane == 31 ? 0.0 : above;
  }

  const bool ok = __all_sync(kFull, lane > order || isfinite(a));
  if (lane >= 1 && lane <= order) {
    out[g * order + lane - 1] = ok ? static_cast<float>(a) : 0.0f;
  }
}

}  // namespace

// y [b, n] f32 and w [frame_len] f64 contiguous; out [b, n_frames, order]
// f32. Frames lie inside the clip: (n_frames - 1) hop + frame_len <= n.
extern "C" int burg_lpc_launch(const float* y, const double* w, float* out,
                               int b, int n, int hop, int frame_len,
                               int n_frames, int order, void* stream) {
  if (b < 0 || n_frames < 0 || hop < 1 || frame_len < 2 ||
      frame_len - 1 > 32 * 32 || order < 1 || order > kMaxOrder ||
      (n_frames > 0 &&
       static_cast<long long>(n_frames - 1) * hop + frame_len > n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long frames = static_cast<long long>(b) * n_frames;
  if (frames == 0) return 0;
  const long long blocks = (frames + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (frame_len - 1 <= 32 * 13) {
    burg_lpc_kernel<13><<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
                          s>>>(y, w, out, n, hop, frame_len, n_frames, order,
                               frames);
  } else {
    burg_lpc_kernel<32><<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
                          s>>>(y, w, out, n, hop, frame_len, n_frames, order,
                               frames);
  }
  return static_cast<int>(cudaGetLastError());
}
