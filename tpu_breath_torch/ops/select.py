"""Exact order statistics: masked median and percentiles.

The JAX package selects ranks by radix descent because sorting was slow on
the TPU (tpu_breath/ops/select.py:3-9); here a sort gives the same exact
order statistics.
"""
from __future__ import annotations

import numpy as np
import torch


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """np.median over values[mask] per row of [B, N] (0.0 for an empty
    row): the two middle order statistics, averaged in f32."""
    v, _ = torch.sort(torch.where(mask, values, torch.inf), dim=-1)
    k = mask.sum(dim=-1)
    lo = torch.clamp((k - 1) // 2, min=0)
    hi = torch.clamp(k // 2, max=v.shape[-1] - 1)
    med = 0.5 * (v.gather(-1, lo[..., None]) + v.gather(-1, hi[..., None]))
    return torch.where(k > 0, med[..., 0], 0.0)


def percentiles(x: torch.Tensor, qs) -> torch.Tensor:
    """np.percentile(x, qs) (linear interpolation) along the last axis of
    x [..., n] for static quantiles -> [..., len(qs)]."""
    n = x.shape[-1]
    srt, _ = torch.sort(x.float(), dim=-1)
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = int(np.floor(pos))
        frac = np.float32(pos - lo)
        w_lo = float(np.float32(1) - frac)  # the weights as f32 values
        out.append(srt[..., lo] * w_lo + srt[..., min(lo + 1, n - 1)]
                   * float(frac))
    return torch.stack(out, dim=-1)
