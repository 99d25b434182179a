"""Burg-method LPC over batched frames (counterpart of tpu_breath/ops/lpc.py).

The 12-step Burg order recursion is a Python loop over [..., n_frames, len]
tensors whose working windows shrink by one sample a step, as in librosa.
It runs in float64 (the oracle's precision: f32 frames times a float64
Hamming window) and rounds the coefficients to f32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_breath_torch.ops import spectral


def burg_lpc(frames: torch.Tensor, order: int) -> torch.Tensor:
    """AR coefficients [..., order+1] (a[0] = 1) of each frame [..., n];
    frames whose result is not finite get zeros (the reference's
    failure -> zeros semantics)."""
    fwd = frames[..., 1:]
    bwd = frames[..., :-1]
    den = (fwd * fwd).sum(-1) + (bwd * bwd).sum(-1)
    ar = torch.zeros(*frames.shape[:-1], order + 1, dtype=frames.dtype,
                     device=frames.device)
    ar[..., 0] = 1.0
    for i in range(order):
        reflect = -2.0 * (bwd * fwd).sum(-1) / den
        # ar[j] += reflect * ar[i + 1 - j] for 1 <= j <= i + 1
        rev = torch.flip(ar[..., :i + 1], dims=(-1,))
        upd = ar[..., 1:i + 2] + reflect[..., None] * rev
        ar = torch.cat([ar[..., :1], upd, ar[..., i + 2:]], dim=-1)
        fwd_new = fwd + reflect[..., None] * bwd
        bwd_new = bwd + reflect[..., None] * fwd
        fwd, bwd = fwd_new[..., 1:], bwd_new[..., :-1]
        # the sum over the shrunk windows, not librosa's incremental
        # q * den - edges update (same value, no cancellation)
        den = (fwd * fwd).sum(-1) + (bwd * bwd).sum(-1)
    ok = torch.isfinite(ar).all(dim=-1, keepdim=True)
    return torch.where(ok, ar, 0.0)


@functools.lru_cache(maxsize=None)
def _hamming(n: int) -> np.ndarray:
    return np.hamming(n)


def lpc_features(y: torch.Tensor, order: int, sr: int = 16_000
                 ) -> torch.Tensor:
    """y[..., n] -> [..., order, n_frames] f32: pre-emphasis 0.97, 25 ms /
    10 ms Hamming frames, Burg LPC per frame, coefficients a[1:]."""
    y_emph = torch.cat([y[..., :1], y[..., 1:] - 0.97 * y[..., :-1]], dim=-1)
    frame_length = int(0.025 * sr)
    frame_shift = int(0.010 * sr)
    n_frames = len(range(0, y.shape[-1] - frame_length, frame_shift))
    frames = spectral.frame_signal(y_emph.double(), frame_length,
                                   frame_shift, n_frames)
    frames = frames * spectral.device_const(_hamming, frame_length,
                                            device=y.device,
                                            dtype=torch.float64)
    coeffs = burg_lpc(frames, order)  # [..., n_frames, order+1]
    return coeffs[..., 1:].transpose(-1, -2).float()
