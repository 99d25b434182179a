"""Kernel D: direct |CQT| at tuning 0 (csrc/cqt_kernel.cu).

Counterpart of tpu_breath/ops/pallas/cqt_kernel.py::cqt_mag_pallas: each
clip's padded signal row stays in fast memory while the kernel bank (1/sqrt
of each bin's length folded in, as the Pallas kernel does) streams past it:

    out[b, k, t] = |sum_l ypad[b, hop*t + l] * K[k, l]|,

ypad = y padded by half the longest kernel on the left. The bank rows are
centred windows of their own length (25,414 samples at C1 down to 203 at
the top bin); the kernel sums each row over its nonzero window only, which
computes the same function. No path of the system calls it: the CENS
channel runs the multirate CQT (ops/cqt.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_breath_torch.baseline import dsp_np as _oracle
from tpu_breath_torch.ops import cqt as cqt_ops
from tpu_breath_torch.ops import spectral
from tpu_breath_torch.ops.cuda import _build

TILE_L = 256  # the Pallas kernel's L tile: the bank is padded to it
FRAME_GROUP = 64  # frames a warp accumulates at once (csrc: kFrameGroup)
SMEM_LIMIT = 232_448  # bytes of shared memory a block may opt in to

LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _kernel_bank(sr: int, fmin: float, n_bins: int, bins_per_octave: int
                 ) -> tuple[np.ndarray, np.ndarray, int, int]:
    """(k_re, k_im [n_bins, L_pad] f32, half, l_pad): conj(kernels) /
    sqrt(length), zero-padded to a multiple of TILE_L samples: the rows of
    tpu_breath/ops/pallas/cqt_kernel.py::_kernel_bank that hold bins (it
    pads the bins to a multiple of 128 too)."""
    kernels, lengths = _oracle.cqt_kernel_bank(sr, fmin, n_bins,
                                               bins_per_octave)
    max_len = kernels.shape[1]
    l_pad = -(-max_len // TILE_L) * TILE_L
    bank = np.zeros((n_bins, l_pad), dtype=np.complex128)
    bank[:, :max_len] = np.conj(kernels) / np.sqrt(lengths)[:, None]
    return (bank.real.astype(np.float32), bank.imag.astype(np.float32),
            max_len // 2, l_pad)


def _bank_re(*key) -> np.ndarray:
    return _kernel_bank(*key)[0]


def _bank_im(*key) -> np.ndarray:
    return _kernel_bank(*key)[1]


@functools.lru_cache(maxsize=None)
def bank_windows(sr: int, fmin: float, n_bins: int, bins_per_octave: int
                 ) -> np.ndarray:
    """[n_bins, 2] int32: each bank row's nonzero window [lo, hi)."""
    k_re, k_im = _kernel_bank(sr, fmin, n_bins, bins_per_octave)[:2]
    out = np.zeros((n_bins, 2), np.int32)
    for k in range(n_bins):
        nz = np.flatnonzero((k_re[k] != 0) | (k_im[k] != 0))
        if nz.size:
            out[k] = nz[0], nz[-1] + 1
    return out


def cqt_mag_plain(y: torch.Tensor, sr: int, hop_length: int, fmin: float,
                  n_bins: int, bins_per_octave: int) -> torch.Tensor:
    """Plain PyTorch version: the float64 direct |CQT| of ops/cqt.py."""
    return cqt_ops.cqt_mag(y, sr, hop_length, fmin, n_bins, bins_per_octave)


def cqt_mag(y: torch.Tensor, sr: int, hop_length: int, fmin: float,
            n_bins: int, bins_per_octave: int) -> torch.Tensor:
    """|CQT| of y[B, n] f32 -> [B, n_bins, 1 + n//hop] f32, librosa
    scale=True semantics at tuning 0. CPU tensors run the plain version;
    CUDA tensors run the kernel."""
    global LAUNCHES
    if y.dim() != 2:
        raise ValueError(f"y {tuple(y.shape)}: want [B, n_samples]")
    if y.device.type == "cpu":
        return cqt_mag_plain(y, sr, hop_length, fmin, n_bins,
                             bins_per_octave)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype != torch.float32 or not y.is_contiguous():
        raise TypeError("cqt kernel takes a contiguous float32 tensor")
    key = (sr, fmin, n_bins, bins_per_octave)
    half, l_pad = _kernel_bank(*key)[2:4]
    b, n = y.shape
    n_frames = 1 + n // hop_length
    groups = -(-n_frames // FRAME_GROUP)
    # the padded row, long enough for every frame of the last group
    sig_len = hop_length * (groups * FRAME_GROUP - 1) + l_pad
    if sig_len * 4 > SMEM_LIMIT:
        raise ValueError(f"{n} samples at hop {hop_length}: the padded row "
                         f"exceeds the kernel's shared memory")
    k_re = spectral.device_const(_bank_re, *key, device=y.device)
    k_im = spectral.device_const(_bank_im, *key, device=y.device)
    win = spectral.device_const(bank_windows, *key, device=y.device,
                                dtype=torch.int32)
    out = torch.empty(b, n_bins, n_frames, dtype=torch.float32,
                      device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    rc = _build.lib().cqt_mag_launch(
        y.data_ptr(), k_re.data_ptr(), k_im.data_ptr(), win.data_ptr(),
        out.data_ptr(), b, n, half, sig_len, hop_length, l_pad, n_bins,
        n_frames, stream)
    _build.check(rc, "cqt_mag_launch")
    LAUNCHES += 1
    return out
