"""The benchmark's inputs, made from --seed on the run's device in a few
large calls: the same seed gives the same inputs on the same device.

Clips stand in for the dataset's one-second stethoscope wavs (absent
here): band-limited noise (a random band of 300-1,800 Hz starting at
100-500 Hz) under an envelope that rises for label 1 ("E") and falls for
label 0 ("I"), at a random level, quantised to PCM16 as the dataset's wavs
are. Labels are balanced: exactly half are 1. Weights: every parameter and
buffer of a model, drawn in one normal draw and scaled by its kind; the
BatchNorm running statistics then calibrated (program.weights)."""
from __future__ import annotations

import math
import os
import wave

import numpy as np
import torch

SR = 16_000
STREAMS = ("labels", "clips", "weights", "order", "calibration")


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of a run's random draws."""
    word = np.random.SeedSequence([seed, STREAMS.index(stream)]
                                  ).generate_state(2, np.uint64)[0]
    return int(word) & (2 ** 63 - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def labels(seed: int, n: int, device) -> torch.Tensor:
    """[n] float32: a seeded order of n // 2 ones and the rest zeros."""
    g = generator(seed, "labels", device)
    return (torch.randperm(n, generator=g, device=device) < n // 2).float()


@torch.no_grad()
def clips(seed: int, y: torch.Tensor, n_samples: int = SR) -> torch.Tensor:
    """[n, n_samples] float32 clips for labels y [n] on y's device,
    quantised to PCM16 (a multiple of 1 / 32768)."""
    n, dev = y.shape[0], y.device
    g = generator(seed, "clips", dev)
    spec = torch.fft.rfft(torch.randn(n, n_samples, generator=g, device=dev))
    u = torch.rand(n, 3, generator=g, device=dev)
    lo = 100.0 + 400.0 * u[:, :1]
    hi = lo + 300.0 + 1500.0 * u[:, 1:2]
    f = torch.fft.rfftfreq(n_samples, 1.0 / SR, device=dev)
    x = torch.fft.irfft(spec * ((f >= lo) & (f <= hi)), n=n_samples)
    x = x / x.std(dim=1, keepdim=True)
    t = torch.linspace(0.0, 1.0, n_samples, device=dev)
    env = torch.where(y[:, None] > 0.5, t, 1.0 - t)
    level = 0.05 + 0.25 * u[:, 2:]
    q = torch.round(x * env * level * 32768.0).clamp_(-32768.0, 32767.0)
    return q / 32768.0


def order(seed: int, n: int) -> np.ndarray:
    """A seeded permutation of range(n) (host)."""
    return np.random.default_rng(stream_seed(seed, "order")).permutation(n)


@torch.no_grad()
def weights(seed: int, leaves: list, device) -> dict:
    """name -> float32 tensor (int64 for a count) for (name, shape, kind)
    leaves: conv kernels He-normal by fan-in, linear kernels Glorot-normal,
    biases N(0, 0.05), BatchNorm scale 1 + N(0, 0.1), shift N(0, 0.1),
    running mean N(0, 0.1), running variance exp(N(0, 0.2)); all from one
    normal draw on the device."""
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    z = torch.randn(sum(sizes), generator=generator(seed, "weights", device),
                    device=device)
    out, lo = {}, 0
    for (name, shape, kind), size in zip(leaves, sizes):
        x = z[lo:lo + size].view(shape)
        lo += size
        if kind == "conv":
            x = x * math.sqrt(2.0 / math.prod(shape[1:]))
        elif kind == "linear":
            x = x * math.sqrt(2.0 / (shape[0] + shape[1]))
        elif kind in ("bias", "bn_bias"):
            x = x * (0.05 if kind == "bias" else 0.1)
        elif kind == "bn_weight":
            x = 1.0 + 0.1 * x
        elif kind == "bn_mean":
            x = 0.1 * x
        elif kind == "bn_var":
            x = torch.exp(0.2 * x)
        elif kind == "count":
            x = torch.zeros((), dtype=torch.int64, device=device)
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        out[name] = x.clone()
    return out


def write_wavs(pcm: np.ndarray, directory: str) -> list[str]:
    """Each row of pcm (float32, multiples of 1 / 32768) as a mono PCM16
    wav at 16 kHz under directory; returns the paths."""
    os.makedirs(directory, exist_ok=True)
    ints = np.round(pcm * 32768.0).clip(-32768, 32767).astype("<i2")
    paths = []
    for i, row in enumerate(ints):
        path = os.path.join(directory, f"clip_{i:05d}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(row.tobytes())
        paths.append(path)
    return paths
