"""scipy.signal.find_peaks (height + distance) statistics, batched
(counterpart of tpu_breath/ops/peaks.py).

Plateau-aware local maxima and the height filter are plain torch; the greedy
distance suppression is kernel C (ops/cuda/peaks_kernel.py).
"""
from __future__ import annotations

import torch

from tpu_breath_torch.ops.cuda import peaks_kernel


def local_maxima(x: torch.Tensor) -> torch.Tensor:
    """Mask of plateau-aware local maxima of x[..., n] (scipy
    _local_maxima_1d): a run of equal samples is one peak at its
    floor-midpoint iff the samples just outside both ends are strictly
    lower; runs touching either end of the signal never qualify."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device).expand_as(x)
    change = x[..., 1:] != x[..., :-1]
    true = torch.ones_like(change[..., :1])
    starts = torch.cat([true, change], dim=-1)
    ends = torch.cat([change, true], dim=-1)
    left_edge = torch.cummax(torch.where(starts, idx, -1), dim=-1).values
    right_edge = n - 1 - torch.cummax(
        torch.where(ends, n - 1 - idx, -1).flip(-1), dim=-1).values.flip(-1)
    left_val = x.gather(-1, (left_edge - 1).clamp(min=0))
    right_val = x.gather(-1, (right_edge + 1).clamp(max=n - 1))
    left_ok = (left_edge > 0) & (left_val < x)
    right_ok = (right_edge < n - 1) & (right_val < x)
    return left_ok & right_ok & (idx == (left_edge + right_edge) // 2)


def find_peaks_stats_batched(x: torch.Tensor, height: torch.Tensor,
                             distance: int):
    """x[B, n], height[B] -> (n_peaks, mean_height, std_height), each [B],
    of the peaks surviving find_peaks(height=height, distance=distance)."""
    n = x.shape[-1]
    rounds = n // max(distance, 1) + 2  # at most n // distance + 1 survive
    scores = torch.where(local_maxima(x) & (x >= height[:, None]), x,
                         -torch.inf).contiguous()
    vals, kept = peaks_kernel.suppress_peaks(scores, distance, rounds)
    n_pk = kept.sum(dim=-1)
    kh = torch.where(kept, vals, 0.0)
    denom = torch.clamp(n_pk, min=1).to(x.dtype)
    mean_h = torch.where(n_pk > 0, kh.sum(dim=-1) / denom, 0.0)
    sq = torch.where(kept, (vals - mean_h[:, None]) ** 2, 0.0)
    var_h = torch.where(n_pk > 0, sq.sum(dim=-1) / denom, 0.0)
    std_h = torch.where(n_pk > 1, torch.sqrt(var_h), 0.0)
    return n_pk.to(x.dtype), mean_h, std_h
