"""Batched STFT / mel spectrogram ops (PyTorch).

Counterpart of tpu_breath/ops/spectral.py with the same public functions and
layouts ([..., F, T] magnitudes, [..., T, F] time-major (re, im)). The
transforms run through torch.fft in float64: the JAX package emulated that
precision with double-float matmuls (stft_mag_cr) because the TPU has no
float64, and the oracle (baseline/dsp_np) defines |S| as f32(|STFT_f64|).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_breath.baseline import dsp_np as _oracle


def disable_tf32() -> None:
    """The feature path runs its f32 products in full f32, like the JAX
    package's Precision.HIGHEST; TF32 keeps ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=None)
def _on_device(build, args: tuple, device: torch.device, dtype: torch.dtype
               ) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(build(*args))).to(
        device=device, dtype=dtype)


def device_const(build, *args, device, dtype=torch.float32) -> torch.Tensor:
    """build(*args) (a cached numpy constant builder) as a tensor on device,
    built and copied once per (args, device, dtype)."""
    return _on_device(build, args, torch.device(device), dtype)


@functools.lru_cache(maxsize=None)
def mel_matrix(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
               fmax: float | None = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] Slaney-normalized mel filterbank (f32)."""
    return _oracle.mel_filterbank(sr, n_fft, n_mels, fmin, fmax).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _hann64(n: int) -> np.ndarray:
    return _oracle.hann(n, True)


def frame_signal(y: torch.Tensor, frame_length: int, hop_length: int,
                 n_frames: int) -> torch.Tensor:
    """y[..., n] -> [..., n_frames, frame_length] (time-major), zero-padding
    the tail if the last frame runs past the signal."""
    need = (n_frames - 1) * hop_length + frame_length
    if need > y.shape[-1]:
        y = torch.nn.functional.pad(y, (0, need - y.shape[-1]))
    return y.unfold(-1, frame_length, hop_length)[..., :n_frames, :]


def stft_ri(y: torch.Tensor, n_fft: int, hop_length: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """librosa.stft semantics (center=True, zero pad, periodic hann) in
    float64: y[..., n] -> (re, im) each [..., 1 + n//hop, n_fft//2 + 1]."""
    n_frames = 1 + y.shape[-1] // hop_length
    ypad = torch.nn.functional.pad(y.double(), (n_fft // 2, n_fft // 2))
    frames = frame_signal(ypad, n_fft, hop_length, n_frames)
    frames = frames * device_const(_hann64, n_fft, device=y.device,
                                   dtype=torch.float64)
    d = torch.fft.rfft(frames, dim=-1)
    return d.real, d.imag


def stft_power64(y: torch.Tensor, n_fft: int, hop_length: int
                 ) -> torch.Tensor:
    """|STFT|^2 in float64, time-major [..., T, F]."""
    re, im = stft_ri(y, n_fft, hop_length)
    return re * re + im * im


def stft_mag_cr(y: torch.Tensor, n_fft: int, hop_length: int
                ) -> torch.Tensor:
    """|STFT| rounded once from float64 -> f32 [..., F, T]: the oracle's
    f32(|STFT_float64|), which the chroma tuning's near-tied histogram
    argmax needs (tpu_breath/ops/spectral.py:187-199)."""
    return torch.sqrt(stft_power64(y, n_fft, hop_length)).float(
        ).transpose(-1, -2)


def stft_mag(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """|STFT| [..., F, T]; the same round-once magnitude as stft_mag_cr."""
    return stft_mag_cr(y, n_fft, hop_length)


def mel_from_power64(p64: torch.Tensor, sr: int, n_fft: int, n_mels: int,
                     fmax: float | None = None) -> torch.Tensor:
    """Time-major float64 power [..., T, F] -> f32 mel power [..., n_mels, T]."""
    fb = device_const(mel_matrix, sr, n_fft, n_mels, 0.0, fmax,
                      device=p64.device, dtype=torch.float64)
    return torch.matmul(p64, fb.T).float().transpose(-1, -2)


def melspectrogram(y: torch.Tensor, sr: int, n_fft: int, hop_length: int,
                   n_mels: int, fmax: float | None = None) -> torch.Tensor:
    """[..., n_mels, T] power mel spectrogram."""
    return mel_from_power64(stft_power64(y, n_fft, hop_length), sr, n_fft,
                            n_mels, fmax)


AMIN = 1e-10
TOP_DB = 80.0


def power_to_db(S: torch.Tensor, ref_max: bool = False) -> torch.Tensor:
    """librosa.power_to_db (amin 1e-10, top_db 80 over the last two axes);
    ref_max=True takes the per-clip max as the reference (ref=np.max)."""
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=AMIN))
    if ref_max:
        ref = torch.amax(S, dim=(-2, -1), keepdim=True)
        log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=AMIN))
    floor = torch.amax(log_spec, dim=(-2, -1), keepdim=True) - TOP_DB
    return torch.maximum(log_spec, floor)


def znorm(x: torch.Tensor, axes: tuple[int, ...] = (-2, -1)) -> torch.Tensor:
    """(x - mean) / (std + 1e-8) over axes (the reference's eps placement)."""
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    return (x - mean) / (torch.sqrt(var) + 1e-8)


def pad_time_min(x: torch.Tensor, t_fixed: int) -> torch.Tensor:
    """Pad/truncate the last (time) axis, filling with the per-clip min."""
    t = x.shape[-1]
    if t >= t_fixed:
        return x[..., :t_fixed]
    minv = torch.amin(x, dim=(-2, -1), keepdim=True)
    return torch.cat([x, minv.expand(*x.shape[:-1], t_fixed - t)], dim=-1)


def pad_freq_min(x: torch.Tensor, to_bins: int) -> torch.Tensor:
    """Pad/truncate the second-to-last (freq) axis with the per-clip min."""
    f = x.shape[-2]
    if f >= to_bins:
        return x[..., :to_bins, :]
    minv = torch.amin(x, dim=(-2, -1), keepdim=True)
    pad = minv.expand(*x.shape[:-2], to_bins - f, x.shape[-1])
    return torch.cat([x, pad], dim=-2)
