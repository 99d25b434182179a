"""The yardstick's operation counts, functions of the configuration's
shapes alone, so a change to the program cannot move them.

FLOPs are what torch.utils.flop_counter.FlopCounterMode counts:
convolutions, mm and bmm, forward and backward (and, in the frozen
feature count, FFTs at 5 n log2 n a complex transform and 2.5 n log2 n a
real one). No elementwise work is counted, so a share of the peak reads
the same work whatever implements it. A training step's model work is
counted on the plain reference (reference/<arch>.py): its forward in
training mode and the backward to every trainable leaf at the batch, on
meta tensors. The feature graph's
work is the configuration's frozen `feature_flops_per_clip`: counted once,
when the configuration was added, on the port's plain CPU path with kernel
B's route (fused_gt=False) at 8 clips and divided by 8, whatever route
runs on the card (the CUDA kernels are launched through ctypes, out of a
counter's sight), and kept in the configuration's file.

Kernel work (the least bytes and operations of kernels A, B, B'' and C a
call, from their shapes: each input read once, each output written once)
is the port's ops/cuda/work.py as of the benchmark's first version; the
main path's per-clip shapes are constants below, checked against the
port's CPU path by the benchmark's tests."""
from __future__ import annotations

import torch

from breathbench import harness, program


def counted(fn) -> float:
    """The FLOPs FlopCounterMode counts in one call of fn."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def model_step(config: dict, b: int) -> float:
    """The counted FLOPs of one training step's forward and backward of
    every member's plain reference at batch b (meta tensors)."""
    from breathbench.reference import layers, spec as spec_lib

    meta = torch.device("meta")
    spec = spec_lib.from_config(config["features"])
    f = torch.empty(b, len(spec.channel_order), spec.n_mels, spec.t_fixed,
                    device=meta)
    s = torch.empty(b, spec.n_scalars, device=meta)
    total = 0.0
    for m, _ in program.members(config):
        mod = program.reference(m["arch"])
        P = {name: torch.empty(shape, device=meta,
                               requires_grad=kind in program.TRAINABLE)
             for name, shape, kind in mod.leaves(m)}

        def step():
            z = mod.forward(P, f, s, m, True, lambda x, p, channels: x,
                            layers.rounder("f32"))
            torch.autograd.grad(z.sum(), [p for p in P.values()
                                          if p.requires_grad])
        total += counted(step)
    return total


def step(config: dict, b: int, fused: bool) -> float:
    """The counted FLOPs of one training step at batch b; fused: with its
    feature graph."""
    flops = model_step(config, b)
    if fused:
        flops += config["feature_flops_per_clip"] * b
    return flops


# ---- kernel work (ops/cuda/work.py, frozen) ----------------------------

# the main path's shapes a clip at 16 kHz, one second, hop 256:
# A: piptrack pairs in the tuning band of |STFT_512| (bpo 12) and of the
#    2048-point STFT at every other bin (bpo 36); B: |STFT_512| F x T and
#    the 64-band filterbank; B'': frames T x K; C: the Hilbert envelope's
#    samples and the suppression's rounds
SHAPES = {"A_pairs": (125 * 63, 494 * 32), "B": (257, 63, 64), "B2_k": 512,
          "C": (16_000, 12)}


def tuning(b: int, pairs: int) -> tuple[int, int, float]:
    """Kernel A: pitches and mags [b, pairs] -> int32 [b]; one compare a
    pair."""
    return 2 * b * pairs * 4 + b * 4, b * pairs, harness.PEAK_F32_FLOPS


def epilogue(b: int, f: int, t: int, g: int) -> tuple[int, int, float]:
    """Kernel B (float64 product): |S| [b, f, t], fb [g, f] -> [b, g, t]."""
    return ((b * f * t + g * f + b * g * t) * 4, 2 * b * g * f * t,
            harness.PEAK_F64_FLOPS)


def gammatone(b: int, t: int, k: int, f: int, g: int
              ) -> tuple[int, int, float]:
    """Kernel B'': frames [b, t, k], basis [k, 2f], fb [g, f] -> [b, g,
    t]; the real DFT's products, then B's."""
    return ((b * t * k + k * 2 * f + g * f + b * g * t) * 4,
            2 * b * t * k * 2 * f + 2 * b * g * f * t, harness.PEAK_F64_FLOPS)


def peaks(b: int, n: int, rounds: int) -> tuple[int, int, float]:
    """Kernel C: scores [b, n] -> vals f32 and kept uint8 [b, rounds]."""
    return b * n * 4 + b * rounds * 5, rounds * b * n, harness.PEAK_F32_FLOPS


def bound_s(work: tuple[int, int, float]) -> float:
    """The least time: bytes over HBM's rate or operations over their
    peak, whichever is larger."""
    nbytes, ops, peak = work
    return max(nbytes / harness.PEAK_HBM_BPS, ops / peak)
