"""Kernel B'': the whole gammatone channel (csrc/gammatone_kernel.cu).

Counterpart of tpu_breath/ops/pallas/epilogue_kernel.py::fused_gammatone:
frames [B, T, K] (raw signal values) times the window-folded real-DFT
basis [K, 2F] -> |S| -> z-normed log1p(fb @ |S|) [B, G, T]. Both products
accumulate in float64; |S| is taken in float64 and rounded to f32 once.
The kernel reads the basis in the tile order of its fragments
(tiled_basis), built once per device as a spectral.device_const. It takes
any B, T, G and any K that is a multiple of 8 (the JAX kernel's rule): a
clip past one cluster's tiles (T > MAX_FRAMES, F > MAX_FREQS,
G > MAX_BANDS or K not a multiple of K_TILE) runs the kernel's range
instantiation, its |S| in a [B, F, T] scratch that the wrapper allocates.
Frames that do not start on a 16-byte boundary are copied once.

Call the wrapper through the module, as
`gammatone_kernel.fused_gammatone(...)`, never as a name imported from it:
utils/feature_roofline.count_kernels swaps the module's attribute to count
the kernel's bytes, and an imported name would escape the count.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_breath_torch.ops import spectral
from tpu_breath_torch.ops.cuda import _build
from tpu_breath_torch.ops.cuda import epilogue_kernel

# the kernel's tiling (kSplit, kWarps, kRows, kBands, kKT in the .cu file):
# a clip is SPLIT blocks of WARPS warps, each warp 8 frequencies; one set of
# tiles holds MAX_FRAMES x MAX_FREQS of |S| and MAX_BANDS bands
SPLIT = 3
WARPS = 11
MAX_FREQS = SPLIT * WARPS * 8  # 264
MAX_FRAMES = 64
MAX_BANDS = 64
K_TILE = 32

LAUNCHES = 0


def fits_tiles(t: int, k: int, f: int, g: int) -> bool:
    """Whether a clip fits one cluster's tiles (the main path's kernel)."""
    return (t <= MAX_FRAMES and f <= MAX_FREQS and g <= MAX_BANDS
            and k % K_TILE == 0)


@functools.lru_cache(maxsize=None)
def tiled_basis(n_fft: int) -> np.ndarray:
    """framedft_basis(n_fft) [K, 2F] -> [R * SPLIT, Kp/8, WARPS, 2, 2, 32]
    f32, R = ceil(F / MAX_FREQS) frequency ranges and Kp = K rounded up to
    a multiple of K_TILE: the re and im columns padded with zeros to
    R * MAX_FREQS frequencies and Kp rows, laid out in the order the kernel
    loads its B fragments: entry [SPLIT q + r, s, w, ri, i, lane] is
    basis[k, ri * F + f] with k = 8 s + 4 i + lane % 4 and
    f = MAX_FREQS q + 88 r + 8 w + lane // 4 (0 where f >= F or k >= K).
    The main path's (K = 512, F = 257) has R = 1 and Kp = K."""
    basis = spectral.framedft_basis(n_fft)
    k, f = basis.shape[0], basis.shape[1] // 2
    n_ranges, kp = -(-f // MAX_FREQS), -(-k // K_TILE) * K_TILE
    x = np.zeros((2, kp, n_ranges * MAX_FREQS), np.float32)
    x[0, :k, :f], x[1, :k, :f] = basis[:, :f], basis[:, f:]
    x = x.reshape(2, kp // 8, 2, 4, n_ranges * SPLIT, WARPS, 8)
    # axes: ri, s, i, t, (q, r), w, g -> (q, r), s, w, ri, i, g, t
    return x.transpose(4, 1, 5, 0, 2, 6, 3).reshape(
        n_ranges * SPLIT, kp // 8, WARPS, 2, 2, 32)


def fused_gammatone_plain(frames: torch.Tensor, basis: torch.Tensor,
                          fb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a float64 matmul of frames by basis, |S| in
    float64 rounded to f32, then kernel B's plain version."""
    ri = torch.matmul(frames.double(), basis.double())      # [B, T, 2F]
    f = basis.shape[1] // 2
    re, im = ri[..., :f], ri[..., f:]
    mag = torch.sqrt(re * re + im * im).float().transpose(-1, -2)
    return epilogue_kernel.fused_epilogue_plain(mag, fb)


def fused_gammatone(frames: torch.Tensor, basis: torch.Tensor,
                    fb: torch.Tensor) -> torch.Tensor:
    """frames [B, T, K], basis [K, 2F], fb [G, F] f32 -> z-normed gammatone
    [B, G, T]. CPU tensors run the plain version; CUDA tensors the kernel,
    which takes as basis spectral.device_const(framedft_basis, K) only: it
    reads that basis as tiled_basis(K) lays it out."""
    global LAUNCHES
    if (frames.dim() != 3 or basis.dim() != 2 or fb.dim() != 2
            or basis.shape[0] != frames.shape[2] or basis.shape[1] % 2
            or fb.shape[1] != basis.shape[1] // 2):
        raise ValueError(f"frames {tuple(frames.shape)} / basis "
                         f"{tuple(basis.shape)} / fb {tuple(fb.shape)}: want "
                         "[B, T, K], [K, 2F] and [G, F]")
    if frames.device.type == "cpu":
        return fused_gammatone_plain(frames, basis, fb)
    if (frames.device.type != "cuda" or basis.device != frames.device
            or fb.device != frames.device):
        raise ValueError(f"unsupported devices {frames.device}/"
                         f"{basis.device}/{fb.device}")
    if not all(x.dtype == torch.float32 for x in (frames, basis, fb)):
        raise TypeError("gammatone kernel takes float32 frames, basis, fb")
    if not all(x.is_contiguous() for x in (frames, basis, fb)):
        raise ValueError("gammatone kernel takes contiguous tensors")
    b, t, k = frames.shape
    f, g = basis.shape[1] // 2, fb.shape[0]
    if t < 1 or k % 8 or f < 1 or g < 1:
        raise ValueError(f"T {t}, K {k}, F {f}, G {g}: the kernel takes "
                         "T, F, G >= 1 and K a multiple of 8")
    if basis is not spectral.device_const(spectral.framedft_basis, k,
                                          device=frames.device):
        raise ValueError("kernel B'' takes the basis "
                         "spectral.device_const(framedft_basis, K) builds")
    if frames.data_ptr() % 16:
        frames = frames.clone()  # a fresh allocation starts 16-byte aligned
    tiles = spectral.device_const(tiled_basis, k, device=frames.device)
    out = torch.empty(b, g, t, dtype=torch.float32, device=frames.device)
    mag = (None if fits_tiles(t, k, f, g) else
           torch.empty(b, f, t, dtype=torch.float32, device=frames.device))
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    rc = _build.lib().fused_gammatone_launch(
        frames.data_ptr(), tiles.data_ptr(), fb.data_ptr(), out.data_ptr(),
        None if mag is None else mag.data_ptr(), b, t, k, f, g, stream)
    _build.check(rc, "fused_gammatone_launch")
    LAUNCHES += 1
    return out
