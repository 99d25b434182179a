"""The least work of each CUDA kernel as a function of its shapes: the bytes
it must move (each input read once, each output written once, all f32 but
A's int32 index) and the operations it must do, beside the H100's peak rate
for each. chip_smoke.py's bound (the kernel table's `bound_ms`) and the
feature roofline (utils/feature_roofline.py, which counts a kernel's call by
this model, not by its plain version's steps) both read it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 CUDA-core FLOP/s,
# f64 tensor-core FLOP/s (the card's fastest float64 rate), f64 CUDA-core
# FLOP/s (132 SMs x 64 FMAs x 2 x 1.98 GHz; the sheet rounds it to 34) for
# work no tensor core takes
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 67e12
F64_CUDA_FLOPS = 33.5e12
HBM_SOURCE = "NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3"


@dataclasses.dataclass(frozen=True)
class Work:
    """bytes moved, operations done and the peak rate of their type."""
    bytes: int
    ops: int
    peak: float

    def __add__(self, other: "Work") -> "Work":
        if self.peak != other.peak:
            raise ValueError("adding work done at different peak rates")
        return Work(self.bytes + other.bytes, self.ops + other.ops, self.peak)

    def bound_ms(self) -> tuple[float, str]:
        """The larger of the bytes over HBM_BPS and the operations over
        their peak, in ms, and which it was."""
        t_bytes, t_ops = self.bytes / HBM_BPS * 1e3, self.ops / self.peak * 1e3
        return ((t_bytes, "bytes") if t_bytes >= t_ops
                else (t_ops, "operations"))


def tuning(b: int, pairs: int) -> Work:
    """Kernel A, one call: pitches and mags [b, pairs] -> int32 [b]; one
    compare per pair (the histogram and median work is smaller still)."""
    return Work(2 * b * pairs * 4 + b * 4, b * pairs, F32_FLOPS)


def epilogue(b: int, f: int, t: int, g: int, plain: bool = False) -> Work:
    """Kernel B (float64 product), or B' (plain=True, f32): |S| [b, f, t]
    and fb [g, f] -> [b, g, t]; 2 g f t operations a clip."""
    return Work((b * f * t + g * f + b * g * t) * 4, 2 * b * g * f * t,
                F32_FLOPS if plain else F64_FLOPS)


def gammatone(b: int, t: int, k: int, f: int, g: int) -> Work:
    """Kernel B'': frames [b, t, k], basis [k, 2f], fb [g, f] -> [b, g, t];
    the real DFT's (re, im) products, then B's."""
    return Work((b * t * k + k * 2 * f + g * f + b * g * t) * 4,
                2 * b * t * k * 2 * f + 2 * b * g * f * t, F64_FLOPS)


def peaks(b: int, n: int, rounds: int) -> Work:
    """Kernel C: scores [b, n] -> vals f32 and kept uint8 [b, rounds];
    `rounds` passes of one compare per score."""
    return Work(b * n * 4 + b * rounds * 5, rounds * b * n, F32_FLOPS)


def lpc(b: int, n: int, frame: int, n_frames: int, order: int) -> Work:
    """Kernel E: y_emph [b, n] f32 and the float64 window [frame] ->
    [b, order, n_frames] f32. A frame: one product a sample to window it;
    at step i (windows of m = frame - 1 - i samples) the three sums of
    products (6 m), the reflection (2), the coefficients' update
    (2 (i + 1)) and, except at the last step, the two windows' updates
    (4 m)."""
    ops = frame
    for i in range(order):
        m = frame - 1 - i
        ops += 6 * m + 2 + 2 * (i + 1) + (4 * m if i + 1 < order else 0)
    return Work(b * n * 4 + frame * 8 + b * order * n_frames * 4,
                b * n_frames * ops, F64_CUDA_FLOPS)


def cqt(b: int, n: int, sr: int, hop: int, fmin: float, n_bins: int,
        bins_per_octave: int) -> Work:
    """Kernel D: y [b, n] -> [b, n_bins, 1 + n // hop]. The work is what
    the function needs: 2 (re, im) FMAs of 2 operations for each frame and
    bank entry inside the bin's nonzero window whose sample of ypad lies in
    the clip (the rest multiply zeros of ypad's padding), the nonzero
    entries read once (re and im f32)."""
    from tpu_breath_torch.ops.cuda import cqt_kernel as ck

    win = ck.bank_windows(sr, fmin, n_bins, bins_per_octave).astype(np.int64)
    nnz = int((win[:, 1] - win[:, 0]).sum())
    half = ck._kernel_bank(sr, fmin, n_bins, bins_per_octave)[2]
    t = 1 + n // hop
    starts = half - hop * np.arange(t)[:, None]  # [t, 1]
    terms = int(np.clip(np.minimum(win[:, 1], starts + n)
                        - np.maximum(win[:, 0], starts), 0, None).sum())
    return Work(b * n * 4 + nnz * 8 + b * n_bins * t * 4, 2 * 2 * terms * b,
                F32_FLOPS)
