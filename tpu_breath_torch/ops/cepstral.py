"""MFCC, Savitzky-Golay deltas and the 2-D DCT modulation spectrum as
constant-matrix products (counterpart of tpu_breath/ops/cepstral.py)."""
from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import torch
from scipy.fftpack import dct as scipy_dct

from tpu_breath_torch.ops import spectral


@functools.lru_cache(maxsize=None)
def savgol_matrix(t: int, width: int = 9, order: int = 1) -> np.ndarray:
    """[t, t] matrix A with (A @ x) == savgol_filter(x, width, polyorder=order,
    deriv=order, mode='interp') — librosa.feature.delta's operator."""
    eye = np.eye(t, dtype=np.float64)
    A = scipy.signal.savgol_filter(eye, width, polyorder=order, deriv=order,
                                   axis=0, mode="interp")
    return A.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """[n, n] DCT-II ortho matrix D with (D @ x) == dct(x, type=2, norm='ortho')."""
    return scipy_dct(np.eye(n), type=2, norm="ortho", axis=0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct_rows(n: int, n_keep: int) -> np.ndarray:
    return dct_matrix(n)[:n_keep]


def delta(x: torch.Tensor, order: int = 1, width: int = 9) -> torch.Tensor:
    """librosa.feature.delta along the last (time) axis of [..., F, T]."""
    A = spectral.device_const(savgol_matrix, x.shape[-1], width, order,
                              device=x.device)
    return torch.matmul(x, A.T)


def mfcc(y: torch.Tensor, sr: int, n_mfcc: int, hop_length: int,
         n_fft: int) -> torch.Tensor:
    """librosa.feature.mfcc: dB mel (ref=1, top_db=80 per clip), DCT-II ortho
    over 128 mel bins, first n_mfcc rows. y[..., n] -> [..., n_mfcc, T]."""
    S = spectral.melspectrogram(y, sr, n_fft=n_fft, hop_length=hop_length,
                                n_mels=128)
    D = spectral.device_const(_dct_rows, 128, n_mfcc, device=y.device)
    return torch.matmul(D, spectral.power_to_db(S))


def mod_spec(mel_db: torch.Tensor, n_keep: int = 40) -> torch.Tensor:
    """2-D DCT modulation spectrum: DCT over freq, keep n_keep rows, DCT over
    time."""
    f, t = mel_db.shape[-2], mel_db.shape[-1]
    Df = spectral.device_const(_dct_rows, f, n_keep, device=mel_db.device)
    Dt = spectral.device_const(dct_matrix, t, device=mel_db.device)
    return torch.matmul(torch.matmul(Df, mel_db), Dt.T)
