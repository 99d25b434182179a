"""Adversarial inputs of kernel C (find_peaks greedy suppression), numpy and
scipy only, so that the CPU tests (against the JAX package) and the card
tests (which run without jax) share them.

Each case is one clip of N scores at the main path's distance (sr // 10):
heights at candidates, -inf elsewhere, as ops/peaks.py builds them. A case
made from a signal keeps it and its height, so its survivors can be held
against scipy.signal.find_peaks.
"""
from __future__ import annotations

import numpy as np
import scipy.signal

N = 16_000
DISTANCE = 1_600
ROUNDS = N // DISTANCE + 2  # ops/peaks.py's count: 12


def scores_from_signal(x: np.ndarray, height: float) -> np.ndarray:
    """find_peaks' candidates of x (local maxima >= height) at their
    heights, -inf elsewhere: [N] f32."""
    pk, _ = scipy.signal.find_peaks(x, height=height)
    s = np.full(x.shape, -np.inf, np.float32)
    s[pk] = x[pk]
    return s


def _spikes(pos, heights) -> np.ndarray:
    x = np.zeros(N, np.float32)
    x[np.asarray(pos)] = heights
    return x


def cases() -> dict[str, tuple[np.ndarray, tuple | None, int]]:
    """name -> (scores [N] f32, (signal, height) or None, rounds)."""
    rng = np.random.default_rng(31)
    signals = {
        "no_candidate": (np.zeros(N, np.float32), 0.5),
        # every odd sample a peak (the last sample cannot be one): 7,999
        "dense_signal": (_spikes(np.arange(1, N - 1, 2), rng.uniform(
            0.1, 1.0, (N - 1) // 2).astype(np.float32)), 0.05),
        "grid_at_distance": (_spikes(np.arange(100, N, DISTANCE), 1.0), 0.5),
        "grid_at_distance_minus_1": (
            _spikes(np.arange(100, N, DISTANCE - 1), 1.0), 0.5),
        # steps of 4 equal heights, falling left to right, every 50 samples
        "descending_staircase": (_spikes(
            np.arange(25, N, 50),
            (1.0 - 0.01 * (np.arange(len(range(25, N, 50))) // 4)
             ).astype(np.float32)), 0.0),
        # equal heights one sample inside and exactly at a window's edge,
        # on both sides of a winner
        "ties_at_window_edge": (_spikes(
            [1000, 1000 + DISTANCE - 1, 4000, 4000 + DISTANCE,
             9000 - DISTANCE + 1, 9000, 9000 + DISTANCE,
             14000 - DISTANCE, 14000, 14000 + DISTANCE - 1],
            [1.0, 1.0, 1.0, 1.0, 1.5, 2.0, 1.5, 1.5, 2.0, 1.5]), 0.5),
    }
    out = {name: (scores_from_signal(x, h), (x, h), ROUNDS)
           for name, (x, h) in signals.items()}
    # scores alone: no signal has a peak at its first or last sample
    ends = np.full(N, -np.inf, np.float32)
    ends[[0, N - 1]] = [0.5, 0.75]
    out["candidates_at_0_and_n_minus_1"] = (ends, None, ROUNDS)
    dense = np.full(N, -np.inf, np.float32)
    dense[::2] = rng.uniform(0.1, 1.0, N // 2)
    out["dense_every_other_sample"] = (dense, None, ROUNDS)  # 8,000
    few = _spikes([3000, 9000, 15000], [0.3, 0.9, 0.6])
    out["more_rounds_than_survivors"] = (scores_from_signal(few, 0.1),
                                         (few, 0.1), 40)
    nan = dense.copy()
    nan[5001] = np.nan  # every round empty, as torch.max and jnp.max give
    out["a_nan_score"] = (nan, None, ROUNDS)
    return out
