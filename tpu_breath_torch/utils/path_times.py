"""Wall times of the port's serving and precompute paths, the end-to-end
metrics that PERF.md §2 names before a benchmark defines them:

- serve: one micro-batch of 8 clips, a wav array on the host -> features
  -> CNN8 (random weights from a seed, built once) -> sigmoid
  probabilities on the host, as serve_from_wav runs each micro-batch;
  median and p90 over 40 calls, and the median of its model part alone
  (CNN8 on features already on the device);
- extract_features at B = 8 and B = 128, one call and a synchronize:
  median over 20 calls;
- precompute: extract_features_batched over 1,536 clips in chunks of 128:
  clips/s, the median of 3 runs.

All on the host clock, after warm-up calls. TPU_BREATH_PALLAS_GT selects
the gammatone kernel as it does for every feature call. Prints one JSON
line.

    python -m tpu_breath_torch.utils.path_times [--device cpu]

It calls nothing newer than the serving and training slices
(extract_features, extract_features_batched, models.registry), so an
earlier checkout of the package is timed by the same code when this file
is copied into it: two versions compared on one card in one call.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from tpu_breath_torch.config import DEFAULT_FEATURES
from tpu_breath_torch.device import resolve_device
from tpu_breath_torch.features import (extract_features,
                                       extract_features_batched)
from tpu_breath_torch.models import registry


def clips(n: int, seed: int = 0) -> np.ndarray:
    """[n, 16000] f32: seeded Gaussian noise of loudness 1e-3 to 0.3."""
    rng = np.random.default_rng(seed)
    amp = 10.0 ** rng.uniform(-3, -0.5, size=(n, 1))
    return (rng.standard_normal((n, DEFAULT_FEATURES.expected_len)) * amp
            ).astype(np.float32)


def host_ms(fn, n: int, warmup: int, device) -> list[float]:
    """Host-clock ms of fn() and a device synchronize, n times."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
    sync()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def serve_models(archs, device) -> list[torch.nn.Module]:
    """The models of archs in eval mode on device, random weights from seed
    0 (serving time depends on the shapes, not the weights)."""
    return [registry.build(a, DEFAULT_FEATURES.n_scalars, seed=0)
            .to(device).eval() for a in archs]


@torch.no_grad()
def serve_call(models, weights, wavs: np.ndarray, device) -> np.ndarray:
    """One serving request: a wav array [B, 16000] on the host -> features
    on device -> every model -> sum_m weights[m] * sigmoid(logits_m) ->
    probabilities [B] (f32) on the host."""
    f, s = extract_features(torch.from_numpy(wavs).to(device),
                            DEFAULT_FEATURES)
    p = torch.zeros(wavs.shape[0], device=device)
    for model, w in zip(models, weights):
        p = p + float(w) * torch.sigmoid(model(f, s))
    return p.float().cpu().numpy()


def serve_ms(device, reps: int, micro: int = 8, warmup: int = 5
             ) -> list[float]:
    """ms of one serving micro-batch, wav array -> CNN8 -> probabilities."""
    models = serve_models(("cnn8",), device)
    wavs = clips(micro, seed=1)
    return host_ms(lambda: serve_call(models, (1.0,), wavs, device), reps,
                   warmup, device)


@torch.no_grad()
def serve_model_ms(device, reps: int, micro: int = 8, warmup: int = 5
                   ) -> list[float]:
    """ms of the serving micro-batch's model part alone: CNN8 on features
    already on the device -> probabilities on the host."""
    spec = DEFAULT_FEATURES
    model = registry.build("cnn8", spec.n_scalars, seed=0).to(device).eval()
    f, s = extract_features(torch.from_numpy(clips(micro, seed=1)).to(device),
                            spec)
    return host_ms(lambda: torch.sigmoid(model(f, s)).float().cpu().numpy(),
                   reps, warmup, device)


def features_ms(device, b: int, iters: int, warmup: int = 3) -> list[float]:
    y = torch.from_numpy(clips(b, seed=b)).to(device)
    return host_ms(lambda: extract_features(y, DEFAULT_FEATURES), iters,
                   warmup, device)


def precompute_clips_per_s(device, n: int, runs: int, chunk: int = 128
                           ) -> list[float]:
    wavs = clips(n, seed=2)
    extract_features_batched(wavs[:chunk], chunk=chunk, device=device)
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        extract_features_batched(wavs, chunk=chunk, device=device)
        out.append(n / (time.perf_counter() - t0))
    return out


def measure(device="cuda", reps: int = 40, iters: int = 20,
            batches=(8, 128), n_clips: int = 1536, runs: int = 3,
            micro: int = 8, warmup: int = 5) -> dict:
    device = resolve_device(device)
    serve = serve_ms(device, reps, micro, warmup)
    model = serve_model_ms(device, reps, micro, warmup)
    feats = {b: features_ms(device, b, iters, min(warmup, 3))
             for b in batches}
    pre = precompute_clips_per_s(device, n_clips, runs)
    return {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "gt_switch": os.environ.get("TPU_BREATH_PALLAS_GT", "0"),
        "serve_ms": {"micro_batch": micro, "n": reps,
                     "median": float(np.median(serve)),
                     "p90": float(np.percentile(serve, 90)),
                     "model_median": float(np.median(model))},
        "extract_features_ms": {str(b): {"n": iters,
                                         "median": float(np.median(v))}
                                for b, v in feats.items()},
        "precompute": {"clips": n_clips, "runs": pre,
                       "clips_per_s": float(np.median(pre))},
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    res = measure(p.parse_args(argv).device)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
