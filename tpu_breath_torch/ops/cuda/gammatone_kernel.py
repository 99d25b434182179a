"""Kernel B'': the whole gammatone channel (csrc/gammatone_kernel.cu).

Counterpart of tpu_breath/ops/pallas/epilogue_kernel.py::fused_gammatone:
frames [B, T, K] (raw signal values) times the window-folded real-DFT
basis [K, 2F] -> |S| -> z-normed log1p(fb @ |S|) [B, G, T]. Both products
accumulate in float64; |S| is taken in float64 and rounded to f32 once.
The kernel reads the basis in the tile order of its fragments
(tiled_basis), built once per device as a spectral.device_const.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_breath_torch.ops import spectral
from tpu_breath_torch.ops.cuda import _build
from tpu_breath_torch.ops.cuda import epilogue_kernel

# the kernel's tiling (kSplit, kWarps, kRows, kBands, kKT in the .cu file):
# a clip is SPLIT blocks of WARPS warps, each warp 8 frequencies
SPLIT = 3
WARPS = 11
MAX_FREQS = SPLIT * WARPS * 8  # 264
MAX_FRAMES = 64
MAX_BANDS = 64
K_TILE = 32

LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def tiled_basis(n_fft: int) -> np.ndarray:
    """framedft_basis(n_fft) [K, 2F] -> [SPLIT, K/8, WARPS, 2, 2, 32] f32:
    the re and im columns padded with zeros to MAX_FREQS frequencies and
    laid out in the order the kernel loads its B fragments: entry
    [r, s, w, ri, i, lane] is basis[k, ri * F + f] with
    k = 8 s + 4 i + lane % 4 and f = 88 r + 8 w + lane // 4 (0 where
    f >= F)."""
    basis = spectral.framedft_basis(n_fft)
    k, f = basis.shape[0], basis.shape[1] // 2
    x = np.zeros((2, k, MAX_FREQS), np.float32)
    x[0, :, :f], x[1, :, :f] = basis[:, :f], basis[:, f:]
    x = x.reshape(2, k // 8, 2, 4, SPLIT, WARPS, 8)
    # axes: ri, s, i, t, r, w, g -> r, s, w, ri, i, g, t
    return x.transpose(4, 1, 5, 0, 2, 6, 3).reshape(
        SPLIT, k // 8, WARPS, 2, 2, 32)


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
    if (not 1 <= t <= MAX_FRAMES or k % K_TILE or f > MAX_FREQS
            or g > MAX_BANDS or b > 65_535 or frames.data_ptr() % 16):
        raise ValueError(f"B {b}, T {t}, K {k}, F {f}, G {g}: the kernel "
                         f"takes T <= {MAX_FRAMES}, K a multiple of {K_TILE}, "
                         f"F <= {MAX_FREQS}, G <= {MAX_BANDS}, B <= 65,535 "
                         "and 16-byte aligned frames")
    if basis is not spectral.device_const(spectral.framedft_basis, k,
                                          device=frames.device):
        raise ValueError("kernel B'' takes the basis "
                         "spectral.device_const(framedft_basis, K) builds")
    tiles = spectral.device_const(tiled_basis, k, device=frames.device)
    out = torch.empty(b, g, t, dtype=torch.float32, device=frames.device)
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    rc = _build.lib().fused_gammatone_launch(
        frames.data_ptr(), tiles.data_ptr(), fb.data_ptr(), out.data_ptr(),
        b, t, k, f, g, stream)
    _build.check(rc, "fused_gammatone_launch")
    LAUNCHES += 1
    return out
