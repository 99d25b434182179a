"""Multirate constant-Q transform + CENS chroma (counterpart of
tpu_breath/ops/cqt.py).

librosa's recursive CQT: per octave, frame the (decimated) signal and apply
one tuning-gathered time-domain kernel [2*bpo, n_fft]; between octaves
decimate 2:1 with scipy's resample_poly FIR. The per-clip tuning comes from
the same piptrack + kernel A chain as chroma_stft, at bins_per_octave 36.
The transforms run in float64 and the magnitude is rounded to f32 once.

cqt_mag is the direct single-GEMM |CQT| at tuning 0 that the JAX package
keeps for comparison (kernel D's function); no feature uses it.
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import torch

from tpu_breath_torch.baseline import dsp_np as _oracle
from tpu_breath_torch.ops import spectral
from tpu_breath_torch.ops import chroma as chroma_ops

_TUNING_RESOLUTION = 0.01
_TINY = float(np.finfo(np.float32).tiny)


@functools.lru_cache(maxsize=None)
def _fir_taps_reversed() -> np.ndarray:
    """scipy.signal.resample_poly(y, 1, 2)'s 41-tap kaiser-5.0 lowpass,
    reversed (a correlation with it is the convolution)."""
    return scipy.signal.firwin(41, 0.5, window=("kaiser", 5.0))[::-1].copy()


def decimate2(y: torch.Tensor) -> torch.Tensor:
    """librosa.resample(y, orig_sr=2, target_sr=1, res_type='polyphase',
    scale=True) == scipy.signal.resample_poly(y, 1, 2) * sqrt(2): full
    convolution with the 41-tap FIR, offset 20, stride 2, ceil(n/2) samples."""
    taps = spectral.device_const(_fir_taps_reversed, device=y.device,
                                 dtype=y.dtype)
    n_out = -(-y.shape[-1] // 2)
    ypad = torch.nn.functional.pad(y, (20, 21))
    frames = spectral.frame_signal(ypad, taps.shape[0], 2, n_out)
    return torch.matmul(frames, taps) * np.sqrt(2.0)


@functools.lru_cache(maxsize=None)
def _vqt_time_kernels(sr: int, fmin: float, bins_per_octave: int,
                      n_octaves: int = 7) -> np.ndarray:
    """Tuning-gathered time-domain response kernels: for each of the 100
    tuning values, K[k, l] = sum_f basis[k, f] exp(-2 pi i f l / n_fft), the
    per-octave FFT-basis projection folded with the DFT into one float64
    constant. Returns [n_tunings, 2*bpo, n_fft] packed (re | im)."""
    n_t = int(np.ceil(1.0 / _TUNING_RESOLUTION))
    outs = []
    n_fft_ref = None
    for ti in range(n_t):
        tau = -0.5 + ti * _TUNING_RESOLUTION
        fmin_t = fmin * 2.0 ** (tau / bins_per_octave)
        k = np.arange((n_octaves - 1) * bins_per_octave,
                      n_octaves * bins_per_octave)
        freqs_top = fmin_t * 2.0 ** (k / bins_per_octave)
        fft_basis, n_fft = _oracle._vqt_filter_fft(
            sr, freqs_top, bins_per_octave)
        lengths, _ = _oracle.wavelet_lengths(
            freqs_top, sr, bins_per_octave=bins_per_octave)
        b = fft_basis / np.sqrt(lengths)[:, None]
        if n_fft_ref is None:
            n_fft_ref = n_fft
        if n_fft != n_fft_ref:
            raise ValueError("kernel n_fft must be tuning-independent")
        E = np.exp(-2j * np.pi * np.outer(np.arange(n_fft // 2 + 1),
                                          np.arange(n_fft)) / n_fft)
        Kt = b @ E
        outs.append(np.concatenate([Kt.real, Kt.imag], axis=0))
    return np.stack(outs)


def cqt_mag_multirate(y: torch.Tensor, tuning_idx: torch.Tensor, sr: int,
                      hop_length: int, fmin: float, bins_per_octave: int,
                      n_octaves: int) -> torch.Tensor:
    """|CQT| via librosa's recursion, float64. y[B, n], tuning_idx[B] int
    -> [B, n_bins, 1 + n//hop] (librosa cqt(scale=True) semantics)."""
    K_all = spectral.device_const(_vqt_time_kernels, sr, fmin,
                                  bins_per_octave, n_octaves,
                                  device=y.device, dtype=torch.float64)
    n_fft = K_all.shape[-1]
    K = K_all[tuning_idx.long()]                      # [B, 2*bpo, n_fft]
    bpo = bins_per_octave
    octaves = []
    my_y, my_hop = y.double(), hop_length
    for o in range(n_octaves):
        n_frames = 1 + my_y.shape[-1] // my_hop
        ypad = torch.nn.functional.pad(my_y, (n_fft // 2, n_fft // 2))
        frames = spectral.frame_signal(ypad, n_fft, my_hop, n_frames)
        resp = torch.matmul(K, frames.transpose(-1, -2))   # [B, 2bpo, T]
        rr, ri = resp[..., :bpo, :], resp[..., bpo:, :]
        octaves.append(torch.sqrt(rr * rr + ri * ri))
        if o < n_octaves - 1:
            if my_hop % 2:
                raise ValueError("hop must have n_octaves-1 factors of 2")
            my_hop //= 2
            my_y = decimate2(my_y)
    n_frames = min(oc.shape[-1] for oc in octaves)
    return torch.cat([oc[..., :n_frames] for oc in octaves[::-1]], dim=-2)


@functools.lru_cache(maxsize=None)
def _direct_consts(sr: int, fmin: float, n_bins: int, bins_per_octave: int
                   ) -> tuple[np.ndarray, np.ndarray, int]:
    """(conj(kernels) packed (re | im) [2*n_bins, L_pad] float64 with L_pad
    a multiple of 128, 1/sqrt(length) [n_bins], half the kernel length):
    tpu_breath/ops/cqt.py::_kernel_consts without the f32 rounding."""
    kernels, lengths = _oracle.cqt_kernel_bank(sr, fmin, n_bins,
                                               bins_per_octave)
    max_len = kernels.shape[1]
    k = np.zeros((n_bins, -(-max_len // 128) * 128), np.complex128)
    k[:, :max_len] = np.conj(kernels)
    return (np.concatenate([k.real, k.imag]), 1.0 / np.sqrt(lengths),
            max_len // 2)


def _direct_bank(*key) -> np.ndarray:
    return _direct_consts(*key)[0]


def _direct_inv_sqrt(*key) -> np.ndarray:
    return _direct_consts(*key)[1]


def cqt_mag(y: torch.Tensor, sr: int, hop_length: int, fmin: float,
            n_bins: int, bins_per_octave: int) -> torch.Tensor:
    """Direct |CQT| (librosa scale=True, tuning 0) of y[B, n] -> f32
    [B, n_bins, 1 + n//hop]: hop-strided frames [B, T, L_pad] of y padded
    by half a kernel on the left, times the conjugate bank, in float64;
    the scaled magnitude is rounded to f32 once. Kernel D's plain
    version."""
    key = (sr, fmin, n_bins, bins_per_octave)
    bank = spectral.device_const(_direct_bank, *key, device=y.device,
                                 dtype=torch.float64)
    inv_sqrt = spectral.device_const(_direct_inv_sqrt, *key,
                                     device=y.device, dtype=torch.float64)
    half = _direct_consts(*key)[2]
    l_pad = bank.shape[-1]
    n_frames = 1 + y.shape[-1] // hop_length
    ypad = torch.nn.functional.pad(y.double(), (half, l_pad))
    frames = spectral.frame_signal(ypad, l_pad, hop_length, n_frames)
    resp = frames.reshape(-1, l_pad) @ bank.T           # [B*T, 2*n_bins]
    re, im = resp[:, :n_bins], resp[:, n_bins:]
    mag = torch.sqrt(re * re + im * im) * inv_sqrt
    return mag.reshape(y.shape[0], n_frames, n_bins).transpose(-1, -2
                                                               ).float()


@functools.lru_cache(maxsize=None)
def _cq_to_chroma(n_bins: int, bins_per_octave: int, n_chroma: int,
                  fmin: float) -> np.ndarray:
    return _oracle.cq_to_chroma(n_bins, bins_per_octave, n_chroma, fmin)


@functools.lru_cache(maxsize=None)
def _cens_window(win_len_smooth: int) -> np.ndarray:
    win = _oracle.hann(win_len_smooth + 2, periodic=False)
    return win / win.sum()


def _norm_cols(x: torch.Tensor, norm: int) -> torch.Tensor:
    if norm == 1:
        length = torch.sum(x.abs(), dim=-2, keepdim=True)
    else:
        length = torch.sqrt(torch.sum(x * x, dim=-2, keepdim=True))
    return x / torch.where(length < _TINY, 1.0, length)


def chroma_cens(y: torch.Tensor, sr: int, hop_length: int, fmin: float,
                n_chroma: int = 12, bins_per_octave: int = 36,
                n_octaves: int = 7, win_len_smooth: int = 41,
                stft2048_mag: torch.Tensor | None = None) -> torch.Tensor:
    """y[B, n] -> CENS chroma [B, n_chroma, T] (librosa chroma_cens(y=...)):
    tuning from piptrack on |STFT(2048, hop 512)|, multirate CQT, chroma
    fold, l1 norm, 4-level quantization, Hann smoothing, l2 norm.

    stft2048_mag: optional |STFT(2048, hop_length)| [B, F, T]; its even
    frames are the hop-512 frames piptrack reads."""
    if 2048 // 4 != 2 * hop_length:
        raise ValueError("the tuning frame subset needs hop 256")
    if stft2048_mag is None:
        stft2048_mag = spectral.stft_mag(y, 2048, hop_length)
    tuning_idx = chroma_ops.estimate_tuning_index(
        stft2048_mag[..., ::2], sr, 2048, bins_per_octave)
    n_bins = n_octaves * bins_per_octave
    C = cqt_mag_multirate(y, tuning_idx, sr, hop_length, fmin,
                          bins_per_octave, n_octaves)
    # the tuning-dependent roll of cq_to_chroma is 0 for every representable
    # tuning here (|tuning / 3| < 0.5 semitone), so the fold is a constant
    ctc = spectral.device_const(_cq_to_chroma, n_bins, bins_per_octave,
                                n_chroma, fmin, device=y.device,
                                dtype=torch.float64)
    chroma = _norm_cols(torch.matmul(ctc, C), 1)
    quant = torch.zeros_like(chroma)
    for step in (0.4, 0.2, 0.1, 0.05):
        quant = quant + 0.25 * (chroma > step).double()
    win = spectral.device_const(_cens_window, win_len_smooth,
                                device=y.device, dtype=torch.float64)
    w = win.shape[0]
    qpad = torch.nn.functional.pad(quant, (w // 2, w - 1 - w // 2))
    smoothed = torch.matmul(qpad.unfold(-1, w, 1), win)
    return _norm_cols(smoothed, 2).float()
