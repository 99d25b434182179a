"""Wall times of the port's serving and precompute paths, the end-to-end
metrics that PERF.md §2 names before a benchmark defines them:

- serve: one micro-batch of 8 clips, a wav array on the host -> features
  -> CNN8 (random weights from a seed, built once) -> sigmoid
  probabilities on the host, through an ensemble.Server as serve_from_wav
  runs each micro-batch (on the card: one replay of its CUDA graph);
  median and p90 over 40 calls, and the median of its model part alone
  (CNN8 on features already on the device, eager);
- extract_features at B = 8 and B = 128, one call and a synchronize:
  median over 20 calls, eager, and as extract_features_compiled's replay
  (`extract_features_graph_ms`);
- precompute: extract_features_batched over 1,536 clips in chunks of 128:
  clips/s, the median of 3 runs.

All on the host clock, after warm-up calls (the graphs are captured in
them). TPU_BREATH_PALLAS_GT selects the gammatone kernel as it does for
every feature call. Prints one JSON line.

    python -m tpu_breath_torch.utils.path_times [--device cpu]
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
from tpu_breath_torch.ensemble import Server
from tpu_breath_torch.features import (extract_features,
                                       extract_features_batched,
                                       extract_features_compiled)
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


def serve_call(server: Server, wavs: np.ndarray) -> np.ndarray:
    """One serving request: a wav array [B, 16000] on the host -> the
    server's program as one micro-batch of B -> probabilities [B] on the
    host (serve_from_wav's path)."""
    return server(wavs, micro_batch=wavs.shape[0])


def serve_ms(device, reps: int, micro: int = 8, warmup: int = 5
             ) -> list[float]:
    """ms of one serving micro-batch, wav array -> CNN8 -> probabilities."""
    server = Server(serve_models(("cnn8",), device), (1.0,), device=device)
    wavs = clips(micro, seed=1)
    return host_ms(lambda: serve_call(server, wavs), reps, warmup, device)


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


def features_ms(device, b: int, iters: int, warmup: int = 3,
                compiled: bool = False) -> list[float]:
    y = torch.from_numpy(clips(b, seed=b)).to(device)
    fn = extract_features_compiled if compiled else extract_features
    return host_ms(lambda: fn(y, DEFAULT_FEATURES), iters, warmup, device)


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
    feats = {(b, compiled): features_ms(device, b, iters, min(warmup, 3),
                                        compiled)
             for b in batches for compiled in (False, True)}
    pre = precompute_clips_per_s(device, n_clips, runs)
    return {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "gt_switch": os.environ.get("TPU_BREATH_PALLAS_GT", "0"),
        "serve_ms": {"micro_batch": micro, "n": reps,
                     "median": float(np.median(serve)),
                     "p90": float(np.percentile(serve, 90)),
                     "model_median": float(np.median(model))},
        **{key: {str(b): {"n": iters, "median": float(np.median(v))}
                 for (b, compiled), v in feats.items() if compiled == c}
           for key, c in (("extract_features_ms", False),
                          ("extract_features_graph_ms", True))},
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
