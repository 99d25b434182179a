"""Kernel C: find_peaks greedy distance suppression (csrc/peaks_kernel.cu).

Counterpart of tpu_breath/ops/pallas/peaks_kernel.py::suppress_peaks_pallas:
`rounds` rounds of per-clip argmax over candidate scores (ties to the lowest
index), each masking a +/-(distance-1) window around the peak it keeps.
The kernel reads a clip's row once into a list of its candidates and
re-scans only the parts of the list a window changed; one launch a call.
The list takes 8 bytes a score at most: up to SMEM_SAMPLES scores a row it
is kept in shared memory, as on the main path (16,000 samples); a longer
row has it in a scratch buffer in device memory that the wrapper allocates
(8 bytes a score of the batch). The wrapper picks from n before the launch;
the kernel's code and results are the same either way.

Call the wrapper through the module, as `peaks_kernel.suppress_peaks(...)`,
never as a name imported from it: utils/feature_roofline.count_kernels swaps
the module's attribute to count the kernel's bytes, and an imported name
would escape the count.
"""
from __future__ import annotations

import torch

from tpu_breath_torch.ops.cuda import _build

SMEM_SAMPLES = 28_000  # rows up to this long keep the (key, index) list in
                       # shared memory, under the 227 KB cap (csrc:
                       # kSmemSamples)

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
    if distance < 1 or rounds < 0:
        raise ValueError(f"distance {distance}, rounds {rounds}: want "
                         "distance >= 1 and rounds >= 0")
    if scores.device.type == "cpu":
        return suppress_peaks_plain(scores, distance, rounds)
    if scores.device.type != "cuda":
        raise ValueError(f"unsupported device {scores.device}")
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        raise TypeError("peaks kernel takes a contiguous float32 tensor")
    b, n = scores.shape
    vals = torch.empty(b, rounds, dtype=torch.float32, device=scores.device)
    kept = torch.empty(b, rounds, dtype=torch.bool, device=scores.device)
    scratch = (torch.empty(b, 2 * n, dtype=torch.int32, device=scores.device)
               if n > SMEM_SAMPLES else None)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    rc = _build.lib().suppress_peaks_launch(
        scores.data_ptr(), vals.data_ptr(), kept.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, n,
        int(distance), int(rounds), stream)
    _build.check(rc, "suppress_peaks_launch")
    LAUNCHES += 1
    return vals, kept
