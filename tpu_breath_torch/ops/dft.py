"""Whole-clip Fourier transforms through torch.fft.

The JAX package builds these from matmul DFTs only because the TPU backend
had no FFT (tpu_breath/ops/dft.py:3-5). Both are computed in float64 and
rounded once to f32, i.e. scipy's own definition.
"""
from __future__ import annotations

import torch


def hilbert_envelope(y: torch.Tensor) -> torch.Tensor:
    """|analytic signal| of y[..., n] along the last axis, matching
    np.abs(scipy.signal.hilbert(y))."""
    n = y.shape[-1]
    if n % 2:
        raise ValueError(f"hilbert_envelope takes an even length, got {n}")
    spec = torch.fft.fft(y.double(), dim=-1)
    h = torch.zeros(n, dtype=torch.float64, device=y.device)
    h[0] = h[n // 2] = 1.0
    h[1:n // 2] = 2.0
    return torch.fft.ifft(spec * h, dim=-1).abs().float()


def autocorr_full(y: torch.Tensor) -> torch.Tensor:
    """Linear autocorrelation at lags 0..n-1 of y[..., n]: matches
    np.correlate(y, y, 'full')[n-1:]."""
    n = y.shape[-1]
    nfft = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(y.double(), n=nfft, dim=-1)
    ac = torch.fft.irfft(f.real.square() + f.imag.square(), n=nfft, dim=-1)
    return ac[..., :n].float()
