"""Kernel C: find_peaks greedy distance suppression (csrc/peaks_kernel.cu).

Counterpart of tpu_breath/ops/pallas/peaks_kernel.py::suppress_peaks_pallas:
`rounds` rounds of per-clip argmax over candidate scores (ties to the lowest
index), each masking a +/-(distance-1) window around the peak it keeps.
"""
from __future__ import annotations

import torch

from tpu_breath_torch.ops.cuda import _build

MAX_SAMPLES = 56_000  # one f32 row in shared memory, under the 227 KB cap

LAUNCHES = 0


def suppress_peaks_plain(scores: torch.Tensor, distance: int, rounds: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: scores [B, n] -> (vals [B, rounds] f32,
    kept [B, rounds] bool)."""
    alive = scores.clone()
    pos = torch.arange(scores.shape[-1], device=scores.device)
    vals, kept = [], []
    for _ in range(rounds):
        m, idx = torch.max(alive, dim=-1)  # first maximum on ties
        take = m > -torch.inf
        vals.append(torch.where(take, m, 0.0))
        kept.append(take)
        near = (pos[None, :] - idx[:, None]).abs() < distance
        alive = torch.where(near & take[:, None], -torch.inf, alive)
    return torch.stack(vals, dim=-1), torch.stack(kept, dim=-1)


def suppress_peaks(scores: torch.Tensor, distance: int, rounds: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """scores [B, n] f32 (heights at candidates, -inf elsewhere) ->
    (vals [B, rounds], kept [B, rounds]) of the greedy survivors.
    CPU tensors run the plain version; CUDA tensors run the kernel."""
    global LAUNCHES
    if scores.dim() != 2:
        raise ValueError(f"scores {tuple(scores.shape)}: want [B, n]")
    if scores.device.type == "cpu":
        return suppress_peaks_plain(scores, distance, rounds)
    if scores.device.type != "cuda":
        raise ValueError(f"unsupported device {scores.device}")
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        raise TypeError("peaks kernel takes a contiguous float32 tensor")
    b, n = scores.shape
    if n > MAX_SAMPLES:
        raise ValueError(f"{n} samples exceed the kernel's shared memory")
    vals = torch.empty(b, rounds, dtype=torch.float32, device=scores.device)
    kept = torch.empty(b, rounds, dtype=torch.uint8, device=scores.device)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    rc = _build.lib().suppress_peaks_launch(
        scores.data_ptr(), vals.data_ptr(), kept.data_ptr(), b, n,
        int(distance), int(rounds), stream)
    _build.check(rc, "suppress_peaks_launch")
    LAUNCHES += 1
    return vals, kept.bool()
