"""STFT chroma with per-clip tuning estimation (counterpart of
tpu_breath/ops/chroma.py).

piptrack runs on the static candidate band of rows, in f32 with the
parabolic-shift divide in float64 rounded once; the tuning tail after it
(masked median, residual histogram, argmax) is kernel A
(ops/cuda/tuning_kernel.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_breath_torch.ops import spectral
from tpu_breath_torch.ops.cuda import tuning_kernel

A440_OVER16 = 27.5
_TINY = float(np.finfo(np.float32).tiny)
# librosa piptrack defaults, as estimate_tuning calls it
FMIN, FMAX, THRESHOLD = 150.0, 4000.0, 0.1


def _localmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """librosa.util.localmax: > predecessor, >= successor, edge-padded."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)],
                    dim=dim)
    return (x > prev) & (x >= nxt)


@functools.lru_cache(maxsize=None)
def _band_rows(F: int, sr: float) -> tuple[int, int]:
    """Row slice [lo, hi) covering the piptrack band [FMIN, FMAX) plus one
    margin row each side (the localmax and parabolic stencils read +/-1)."""
    fft_freqs = np.linspace(0, sr / 2, F)
    band = (fft_freqs >= FMIN) & (fft_freqs < min(FMAX, sr / 2.0))
    lo = max(int(np.argmax(band)) - 1, 0)
    hi = min(F - int(np.argmax(band[::-1])) + 1, F)
    return lo, hi


@functools.lru_cache(maxsize=None)
def _band_mask(F: int, sr: float) -> np.ndarray:
    lo, hi = _band_rows(F, sr)
    freqs = np.linspace(0, sr / 2, F)[lo:hi]
    return ((FMIN <= freqs) & (freqs < min(FMAX, sr / 2.0)))[:, None]


def _piptrack_band(S: torch.Tensor, sr: float, n_fft: int):
    """piptrack on the candidate band of S[B, F, T] -> (pitches, mags)
    [B, hi-lo, T]; the threshold uses the full-spectrum column max."""
    F = S.shape[-2]
    lo, hi = _band_rows(F, sr)
    ref_value = THRESHOLD * torch.amax(S, dim=-2, keepdim=True)  # full F
    Sb = S[..., lo:hi, :]
    avg = 0.5 * (Sb[..., 2:, :] - Sb[..., :-2, :])
    shift = 2 * Sb[..., 1:-1, :] - Sb[..., 2:, :] - Sb[..., :-2, :]
    denom = shift + (shift.abs() < _TINY).float()
    shift = (avg.double() / denom.double()).float()
    avg = torch.nn.functional.pad(avg, (0, 0, 1, 1))
    shift = torch.nn.functional.pad(shift, (0, 0, 1, 1))
    dskew = 0.5 * avg * shift
    freq_mask = spectral.device_const(_band_mask, F, float(sr),
                                      device=S.device, dtype=torch.bool)
    idx = (freq_mask & _localmax(Sb * freq_mask.float(), dim=-2)
           & (Sb > ref_value))
    bins = torch.arange(lo, hi, dtype=S.dtype, device=S.device)[:, None]
    pitches = torch.where(idx, (bins + shift) * float(sr) / n_fft, 0.0)
    mags = torch.where(idx, Sb + dskew, 0.0)
    return pitches, mags


def estimate_tuning_index(S: torch.Tensor, sr: float, n_fft: int,
                          bins_per_octave: int = 12) -> torch.Tensor:
    """librosa.estimate_tuning(S=...) as the histogram bin index, batched:
    S[B, F, T] -> int32 [B]; tuning = -0.5 + index * 0.01."""
    pitches, mags = _piptrack_band(S, sr, n_fft)
    return tuning_kernel.estimate_tuning_index(
        pitches.contiguous(), mags.contiguous(), bins_per_octave)


def estimate_tuning(S: torch.Tensor, sr: float, n_fft: int,
                    bins_per_octave: int = 12) -> torch.Tensor:
    """librosa.estimate_tuning(S=...) -> f32 tuning in [-0.5, 0.5) bins."""
    best = estimate_tuning_index(S, sr, n_fft, bins_per_octave)
    return -0.5 + best.float() * 0.01


@functools.lru_cache(maxsize=None)
def _chroma_fb_consts(sr: int, n_fft: int, n_chroma: int) -> np.ndarray:
    """Tuning-independent pieces of librosa.filters.chroma: [2, n_fft]
    (base octave bins, bin widths), f32."""
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    base = n_chroma * np.log2(frequencies / A440_OVER16)
    base = np.concatenate(([base[0] - 1.5 * n_chroma], base))
    binwidth = np.concatenate((np.maximum(np.diff(base), 1.0), [1.0]))
    return np.stack([base, binwidth]).astype(np.float32)


CTROCT, OCTWIDTH = 5.0, 2.0  # librosa.filters.chroma's octave weighting


def chroma_filterbank(tuning: torch.Tensor, sr: int, n_fft: int,
                      n_chroma: int = 12) -> torch.Tensor:
    """Per-clip filterbanks for tuning [B] -> [B, n_chroma, 1 + n_fft//2]."""
    consts = spectral.device_const(_chroma_fb_consts, sr, n_fft, n_chroma,
                                   device=tuning.device)
    base, binwidth = consts[0], consts[1]
    frqbins = base[None, :] - tuning[:, None]                   # [B, n_fft]
    chroma_idx = torch.arange(n_chroma, dtype=torch.float32,
                              device=tuning.device)[:, None]
    D = frqbins[:, None, :] - chroma_idx                         # [B, C, n]
    half = round(n_chroma / 2)
    D = torch.remainder(D + half + 10 * n_chroma, n_chroma) - half
    wts = torch.exp(-0.5 * (2 * D / binwidth) ** 2)
    norm = torch.sqrt(torch.sum(wts * wts, dim=-2, keepdim=True))
    wts = wts / torch.where(norm < _TINY, 1.0, norm)
    wts = wts * torch.exp(-0.5 * (((frqbins / n_chroma - CTROCT)
                                   / OCTWIDTH) ** 2))[:, None, :]
    wts = torch.roll(wts, -3 * (n_chroma // 12), dims=-2)   # base_c
    return wts[..., : n_fft // 2 + 1]


def _norm_inf_cols(x: torch.Tensor) -> torch.Tensor:
    length = torch.amax(x.abs(), dim=-2, keepdim=True)
    return x / torch.where(length < _TINY, 1.0, length)


def chroma_stft(S: torch.Tensor, sr: int, n_chroma: int = 12) -> torch.Tensor:
    """S[B, F, T] magnitudes -> chroma [B, n_chroma, T]."""
    n_fft = 2 * (S.shape[-2] - 1)
    tuning = estimate_tuning(S, sr, n_fft, bins_per_octave=n_chroma)
    fb = chroma_filterbank(tuning, sr, n_fft, n_chroma)
    return _norm_inf_cols(torch.matmul(fb, S))
