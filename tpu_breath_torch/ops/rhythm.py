"""Onset strength + autocorrelation tempogram (counterpart of
tpu_breath/ops/rhythm.py)."""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_breath_torch.baseline import dsp_np as _oracle
from tpu_breath_torch.ops import spectral

_TINY = float(np.finfo(np.float32).tiny)


def onset_strength(y: torch.Tensor, sr: int, hop_length: int,
                   mel_power: torch.Tensor | None = None) -> torch.Tensor:
    """y[..., n] -> onset envelope [..., T]: dB-mel spectral flux at lag 1,
    rectified, mean over bands, center compensation (librosa defaults,
    n_fft 2048). mel_power: an already computed [..., 128, T] power mel
    (n_fft 2048, fmax sr/2) to reuse."""
    n_fft = 2048
    S = mel_power
    if S is None:
        S = spectral.melspectrogram(y, sr, n_fft=n_fft, hop_length=hop_length,
                                    n_mels=128, fmax=0.5 * sr)
    S = spectral.power_to_db(S)
    env = torch.clamp(S[..., 1:] - S[..., :-1], min=0.0).mean(dim=-2)
    env = torch.nn.functional.pad(env, (1 + n_fft // (2 * hop_length), 0))
    return env[..., : S.shape[-1]]


@functools.lru_cache(maxsize=None)
def _hann(n: int) -> np.ndarray:
    return _oracle.hann(n, periodic=True)


def _linear_ramp_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """np.pad(x, pad, mode='linear_ramp', end_values=0) on the last axis."""
    k = torch.arange(pad, dtype=torch.float64, device=x.device) / pad
    left = (k * x[..., :1].double()).to(x.dtype)
    right = (k.flip(0) * x[..., -1:].double()).to(x.dtype)
    return torch.cat([left, x, right], dim=-1)


def tempogram(onset_env: torch.Tensor, win_length: int = 384) -> torch.Tensor:
    """onset_env[..., T] -> [..., win_length, T]: linear-ramp pad, hop-1
    framing, Hann window, per-frame autocorrelation (float64 FFT),
    per-frame inf-norm."""
    t = onset_env.shape[-1]
    oe = _linear_ramp_pad(onset_env, win_length // 2)
    frames = oe.double().unfold(-1, win_length, 1)[..., :t, :]
    frames = frames * spectral.device_const(_hann, win_length,
                                            device=onset_env.device,
                                            dtype=torch.float64)
    n_pad = 1024  # >= 2*win-1: circular == linear autocorrelation
    f = torch.fft.rfft(frames, n=n_pad, dim=-1)
    ac = torch.fft.irfft(f.real.square() + f.imag.square(), n=n_pad, dim=-1)
    ac = ac[..., :win_length].float().transpose(-1, -2)
    length = torch.amax(ac.abs(), dim=-2, keepdim=True)
    return ac / torch.where(length < _TINY, 1.0, length)
