"""Kernel A: the tuning-estimate tail (csrc/tuning_kernel.cu).

Counterpart of tpu_breath/ops/pallas/tuning_kernel.py. After piptrack,
librosa's estimate_tuning takes the masked median of the magnitudes, keeps
the pitches whose magnitude reaches it, bins mod(bpo * log2(pitch / 27.5), 1)
into 100 bins and returns the argmax bin. The CUDA kernel does the whole tail
for one clip per block; the plain version below is the same math in PyTorch
and is what CPU tensors run.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_breath_torch.ops import select
from tpu_breath_torch.ops.cuda import _build

A440_OVER16 = 27.5
N_BINS = 100
MAX_PAIRS = 28_000  # 8 bytes a pair in shared memory, under the 227 KB cap

LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def hist_edges_f32(n_bins: int) -> np.ndarray:
    """np.histogram's float64 edges over [-0.5, 0.5], each rounded UP to the
    next f32 where rounding went down: for an f32 residual r, r >= edge64 iff
    r >= this edge, so the bin of every residual equals np.histogram's."""
    edges = np.linspace(-0.5, 0.5, n_bins + 1)
    e32 = edges.astype(np.float32)
    low = e32.astype(np.float64) < edges
    e32[low] = np.nextafter(e32[low], np.float32(np.inf))
    return e32


@functools.lru_cache(maxsize=None)
def _edges(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(hist_edges_f32(N_BINS)).to(device)


def residuals(pitches: torch.Tensor, bins_per_octave: int) -> torch.Tensor:
    """mod(bpo * log2(pitch / 27.5), 1) shifted to [-0.5, 0.5), f32. The
    divide and log2 run in float64 and round once (correctly rounded f32)."""
    q = (pitches.double() / A440_OVER16).float()
    octs = torch.log2(q.double()).float()
    r = torch.fmod(bins_per_octave * octs, 1.0)
    r = torch.where(r < 0, r + 1.0, r)  # jnp.mod: result takes the sign of 1
    return torch.where(r >= 0.5, r - 1.0, r)


def estimate_tuning_index_plain(pitches: torch.Tensor, mags: torch.Tensor,
                                bins_per_octave: int) -> torch.Tensor:
    """Plain PyTorch version: pitches/mags [B, ...] -> int32 [B]."""
    b = pitches.shape[0]
    p = pitches.reshape(b, -1)
    m = mags.reshape(b, -1)
    pitch_mask = p > 0
    thresh = select.masked_median(m, pitch_mask)
    sel = (m >= thresh[:, None]) & pitch_mask
    r = residuals(torch.where(sel, p, 1.0), bins_per_octave)
    edges = _edges(p.device)
    idx = torch.searchsorted(edges, r, right=True) - 1
    counted = sel & (idx >= 0) & (idx < N_BINS)
    counts = torch.zeros(b, N_BINS, dtype=torch.int64, device=p.device)
    counts.scatter_add_(1, torch.where(counted, idx, 0), counted.long())
    best = torch.argmax(counts, dim=1)  # first maximum
    return torch.where(sel.any(dim=1), best, N_BINS // 2).to(torch.int32)


def estimate_tuning_index(pitches: torch.Tensor, mags: torch.Tensor,
                          bins_per_octave: int) -> torch.Tensor:
    """Batched piptrack outputs pitches/mags [B, F, T] f32 -> int32 [B].
    CPU tensors run the plain version; CUDA tensors run the kernel."""
    global LAUNCHES
    if pitches.shape != mags.shape or pitches.dim() < 2:
        raise ValueError(f"pitches {tuple(pitches.shape)} / mags "
                         f"{tuple(mags.shape)} must be equal [B, ...] shapes")
    if pitches.device.type == "cpu":
        return estimate_tuning_index_plain(pitches, mags, bins_per_octave)
    if pitches.device.type != "cuda" or mags.device != pitches.device:
        raise ValueError(f"unsupported devices {pitches.device}/{mags.device}")
    if pitches.dtype != torch.float32 or mags.dtype != torch.float32:
        raise TypeError("tuning kernel takes float32 pitches and mags")
    if not (pitches.is_contiguous() and mags.is_contiguous()):
        raise ValueError("tuning kernel takes contiguous tensors")
    b = pitches.shape[0]
    n = pitches.numel() // max(b, 1)
    if n > MAX_PAIRS:
        raise ValueError(f"{n} pairs per clip exceed the kernel's "
                         f"shared-memory capacity ({MAX_PAIRS})")
    out = torch.empty(b, dtype=torch.int32, device=pitches.device)
    stream = torch.cuda.current_stream(pitches.device).cuda_stream
    rc = _build.lib().tuning_index_launch(
        pitches.data_ptr(), mags.data_ptr(), _edges(pitches.device).data_ptr(),
        out.data_ptr(), b, n, int(bins_per_octave), stream)
    _build.check(rc, "tuning_index_launch")
    LAUNCHES += 1
    return out
