"""LR schedule: linear warmup (start factor 0.1 over 5% of the steps) into
cosine annealing to eta_min, as a plain function of the step (counterpart
of tpu_breath/train/schedule.py). The arithmetic is float32 in the JAX
package's order, with its Python constants folded in float64 first as JAX's
weak typing does, so the rates equal JAX's to an f32 ulp (the cosine's own
rounding). The step counts updates from 0, as optax's count does: update k
runs at lr(k)."""
from __future__ import annotations

import math

import numpy as np

_F = np.float32


def warmup_cosine(base_lr: float, total_steps: int, warmup_frac: float = 0.05,
                  start_factor: float = 0.1, eta_min: float = 1e-6):
    """-> lr(step) -> float (an f32 value)."""
    warmup_steps = int(warmup_frac * total_steps)
    t_max = max(total_steps - warmup_steps, 1)
    rise, half_span = _F(1.0 - start_factor), _F((base_lr - eta_min) * 0.5)

    def schedule(step: int) -> float:
        s = _F(step)
        if s < warmup_steps:
            frac = min(s / _F(warmup_steps), _F(1.0))
            return float(_F(base_lr) * (_F(start_factor) + rise * frac))
        t = np.clip(s - _F(warmup_steps), _F(0), _F(t_max))
        cos = _F(math.cos(float(_F(math.pi) * t / _F(t_max))))
        return float(_F(eta_min) + half_span * (_F(1.0) + cos))

    return schedule
