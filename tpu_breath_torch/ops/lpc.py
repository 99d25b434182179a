"""LPC features of batched clips (counterpart of tpu_breath/ops/lpc.py).

The 12-step Burg order recursion of each frame runs in float64 (the
oracle's precision: f32 frames times a float64 Hamming window) and the
coefficients are rounded to f32: kernel E on the card, its plain version
(ops/cuda/lpc_kernel.py::burg_lpc, the loop over [..., n_frames, len]
tensors whose windows shrink by one sample a step, as in librosa) on the
CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_breath_torch.ops import spectral
from tpu_breath_torch.ops.cuda import lpc_kernel


@functools.lru_cache(maxsize=None)
def _hamming(n: int) -> np.ndarray:
    return np.hamming(n)


def lpc_args(y: torch.Tensor, sr: int = 16_000) -> tuple:
    """Kernel E's arguments but the order, from clips y [B, n]: the clips
    pre-emphasised (0.97), the 25 ms Hamming window in float64, the 10 ms
    hop and the number of frames."""
    y_emph = torch.cat([y[..., :1], y[..., 1:] - 0.97 * y[..., :-1]], dim=-1)
    frame_length = int(0.025 * sr)
    frame_shift = int(0.010 * sr)
    n_frames = len(range(0, y.shape[-1] - frame_length, frame_shift))
    window = spectral.device_const(_hamming, frame_length, device=y.device,
                                   dtype=torch.float64)
    return y_emph, window, frame_shift, n_frames


def lpc_features(y: torch.Tensor, order: int, sr: int = 16_000
                 ) -> torch.Tensor:
    """y[..., n] -> [..., order, n_frames] f32: pre-emphasis 0.97, 25 ms /
    10 ms Hamming frames, Burg LPC per frame, coefficients a[1:]."""
    y_emph, window, hop, n_frames = lpc_args(y.reshape(-1, y.shape[-1]), sr)
    coeffs = lpc_kernel.lpc_frames(y_emph, window, hop, n_frames, order)
    return coeffs.reshape(*y.shape[:-1], order, n_frames)
