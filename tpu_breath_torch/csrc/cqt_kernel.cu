// Direct |CQT| at tuning 0:
//   out[b, k, t] = | sum_l ypad[b, hop*t + l] * K[k, l] |      [B, K, T]
// with ypad = y padded by `half` zeros on the left and K the conjugate
// wavelet bank with 1/sqrt(length) folded in.
//
// Replaces tpu_breath/ops/pallas/cqt_kernel.py::cqt_mag_pallas (its
// _cqt_kernel, :55-76): there the grid walks 100 bank tiles of 256 samples
// in order, carrying the complex sums in VMEM scratch across grid steps.
// Here no state crosses blocks: a block stages one clip's whole padded row
// in shared memory (41,728 f32 = 167 KB at hop 256, opted in above 48 KB)
// and each warp sums a whole bin for 64 frames at once.
//
// What bounds it: per clip 2 * 2 * T * nnz(K) = 335 MFLOP of f32 FMA (nnz
// = 1.33 M of the 6.5 M bank entries at 252 bins: each bin's kernel is a
// centred window of its own length, and only that window is summed),
// against 64 KB of signal in, 63 KB out and 10.6 MB of nonzero bank, which
// stays in the 50 MB L2. Each signal value read from shared memory feeds
// two FMAs (re, im), so shared-memory bandwidth caps this design at half the
// FMA rate. A later design can hold several bins per warp to reuse each
// signal load.
//
// Design: grid (B, kBlocksPerClip); the 8 warps of the kBlocksPerClip
// blocks of a clip are 32 streams that take bins round robin. For its bin a
// warp's lanes stride the bin's nonzero window by 32 samples (bank loads
// coalesced, signal loads conflict-free), each lane keeping 64 frames' re/im
// sums in f32 registers (at most 25,414 / 32 = 795 terms each); the lanes'
// partial sums are reduced in float64 and the magnitude is rounded once.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // 8 warps
constexpr int kBlocksPerClip = 4;   // 32 bin streams per clip
constexpr int kFrameGroup = 64;     // frames per register tile

__global__ void __launch_bounds__(kThreads, 1)
cqt_kernel(const float* __restrict__ y,      // [B, n]
           const float* __restrict__ k_re,   // [n_bins, l_pad]
           const float* __restrict__ k_im,   // [n_bins, l_pad]
           const int* __restrict__ win,      // [n_bins, 2]: nonzero [lo, hi)
           float* __restrict__ out,          // [B, n_bins, n_frames]
           int n, int half, int sig_len, int hop, int l_pad, int n_bins,
           int n_frames) {
  extern __shared__ float s[];  // [sig_len]: the padded row
  const int b = blockIdx.x;
  const float* src = y + static_cast<size_t>(b) * n;
  for (int i = threadIdx.x; i < sig_len; i += blockDim.x) {
    const int j = i - half;
    s[i] = (j >= 0 && j < n) ? src[j] : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps = kThreads / 32;
  const int stream = blockIdx.y * warps + (threadIdx.x >> 5);
  const int n_streams = gridDim.y * warps;
  for (int k = stream; k < n_bins; k += n_streams) {
    const int lo = win[2 * k], hi = win[2 * k + 1];
    const float* kr = k_re + static_cast<size_t>(k) * l_pad;
    const float* ki = k_im + static_cast<size_t>(k) * l_pad;
    float* dst = out + (static_cast<size_t>(b) * n_bins + k) * n_frames;
    for (int t0 = 0; t0 < n_frames; t0 += kFrameGroup) {
      float ar[kFrameGroup], ai[kFrameGroup];
#pragma unroll
      for (int t = 0; t < kFrameGroup; ++t) {
        ar[t] = 0.0f;
        ai[t] = 0.0f;
      }
      const float* row = s + t0 * hop;
      for (int l = lo + lane; l < hi; l += 32) {
        const float wr = __ldg(kr + l), wi = __ldg(ki + l);
#pragma unroll
        for (int t = 0; t < kFrameGroup; ++t) {
          const float v = row[t * hop + l];
          ar[t] = fmaf(v, wr, ar[t]);
          ai[t] = fmaf(v, wi, ai[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kFrameGroup; ++t) {
        double re = ar[t], im = ai[t];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          re += __shfl_xor_sync(0xffffffffu, re, off);
          im += __shfl_xor_sync(0xffffffffu, im, off);
        }
        if (lane == (t & 31) && t0 + t < n_frames)
          dst[t0 + t] = static_cast<float>(sqrt(re * re + im * im));
      }
    }
  }
}

}  // namespace

extern "C" int cqt_mag_launch(const float* y, const float* k_re,
                              const float* k_im, const int* win, float* out,
                              int b, int n, int half, int sig_len, int hop,
                              int l_pad, int n_bins, int n_frames,
                              void* stream) {
  const size_t smem = static_cast<size_t>(sig_len) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cqt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  const dim3 grid(b, kBlocksPerClip);
  cqt_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, k_re, k_im, win, out, n, half, sig_len, hop, l_pad, n_bins,
      n_frames);
  return static_cast<int>(cudaGetLastError());
}
