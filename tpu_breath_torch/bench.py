"""The port's benchmark (counterpart of bench.py, tools/latency_probe.py and
tools/mfu_split.py): one JSON line of what a user of the port pays for on
the card, with every key of bench.py's line.

    python -m tpu_breath_torch.bench [--device cuda|cpu] [--root input]
        [--n-clips 2048] [--chunk 128] [--batch 512] [--steps 8]
        [--baseline-clips 24] [--repeats 5] [--serve-calls 40]

Inputs: the dataset's train and test wavs under --root, decoded as
precompute decodes them and repeated to --n-clips, when --root holds one;
else bench.py's seeded noise, default_rng(0).standard_normal((n, 16000)) *
0.05 in f32. The line's `inputs` says which.

Parts, in order:
1. CPU baseline (bench.py:55-61): the port's NumPy oracle
   (baseline/feature_np.process_clip) over --baseline-clips clips in one
   process started by spawn with one BLAS thread, before any device work:
   cpu_oracle_clips_per_s, the denominator of vs_baseline.
2. Feature only (bench.py:70-96): extract_features over --n-clips clips
   already on the device, in chunks of --chunk, then one synchronize. The
   gammatone route follows TPU_BREATH_PALLAS_GT, as in every feature call.
3. Fused CNN8 step (bench.py:98-137), the headline `value`: --steps steps
   at batch --batch, augmentation on, each fit's own step on the gathered
   wavs (train/loop.fit_step: fused_features in chunks of 128, augment.draw,
   train_step at the warmup-cosine rate), then one synchronize; the loss is
   read once at the end and must be finite.
4. Fused VGG step (bench.py:139-171): the same with VGG_TRAIN.
5. Serve latency (tools/latency_probe.py): CNN8 and VGG built once, blended
   by softmax([0.79, 0.80]); a request is a wav array on the host ->
   features -> both models -> probabilities on the host
   (utils/path_times.serve_call), on the host clock after 5 warm-ups, at
   B = 1 and 8: median and p90 over --serve-calls calls. The JAX probe
   chained iterations inside one jit to hide its relay's sync; here a
   request is timed as its user sees it.
6. Step split (tools/mfu_split.py), each model at batch --batch:
   `features` (fused_features), `fwd` (forward in train mode), `grad`
   (forward + BCE + backward), `cached` (fit_step on precomputed features),
   `fused` (fit_step on the wavs); each the mean of --steps launches after
   a warm-up, by CUDA events, the median of 3 rounds (of --repeats when
   fewer); the attribution
   (fused - cached, grad - fwd, cached - grad) and the cached step at half,
   one and two times the batch; the model's peak device memory.

Parts 3, 4 and 6 run inside loop.reproducible(), cuDNN's deterministic
algorithms, as every step of fit does.

Parts 2-4 run once to warm up, then --repeats times in this process: the
line gives each rate's median and its runs.

FLOPs count the work, not the implementation:
- a model piece: torch.utils.flop_counter.FlopCounterMode around one call
  at its batch, on the device (convolutions, mm, bmm; forward and
  backward);
- the feature graph: FlopCounterMode once on the CPU plain path at B = 8
  with fused_gt=False, scaled linearly to the batch, with FFTs at
  5 n log2 n a complex transform and 2.5 n log2 n a real one. The CUDA
  kernels are called through ctypes, out of a counter's sight (kernel B's
  filterbank product would go uncounted), and this way the count is the
  same whichever route runs on the card;
- elementwise work is not counted. bench.py's XLA cost_analysis counted it,
  and the TPU's matmul DFTs, so the two packages' shares count different
  work.
MFU = counted FLOPs x launches / seconds / 989 TFLOP/s, the H100 SXM data
sheet's dense bf16 peak at 700 W (the models run under bf16 autocast).

--device cpu is a rehearsal, not a measurement: the same code at the sizes
given, with every time, rate, spread and MFU null, since a CPU number is
never written under a device metric's name; counts, shapes and losses are
kept. --device cuda without a card raises. Progress goes to stderr; the
line alone to stdout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from tpu_breath_torch.baseline import feature_np
from tpu_breath_torch.config import (CNN8_TRAIN, DEFAULT_FEATURES, VGG_TRAIN,
                                     Paths)
from tpu_breath_torch.device import resolve_device
from tpu_breath_torch.ensemble import softmax_weights
from tpu_breath_torch.features import extract_features
from tpu_breath_torch.models import registry
from tpu_breath_torch.train import loop
from tpu_breath_torch.train.schedule import warmup_cosine
from tpu_breath_torch.utils import parity_sweep, path_times

# bench.py:25-31
N_CLIPS = 2048
CHUNK = 128
TRAIN_BATCH = 512
TRAIN_STEPS = 8
BASELINE_CLIPS = 24
REPEATS = 5
SERVE_CALLS = 40
SERVE_WARMUP = 5
SERVE_BATCHES = (1, 8)  # latency_probe.py:63
SERVE_VAL_SCORES = (0.79, 0.80)  # latency_probe.py:50
SPLIT_ROUNDS = 3  # mfu_split.py:52-60
FLOP_COUNT_BATCH = 8
PEAK_FLOPS = 989e12
PEAK_SOURCE = ("NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, no "
               "sparsity, at 700 W")
COUNTED = ("convolutions, mm and bmm (forward and backward) by "
           "torch.utils.flop_counter; FFTs at 5 n log2 n (c2c) and 2.5 n "
           "log2 n (r2c, c2r) a transform; elementwise work not counted")
METRIC = ("fused wav->feature->train-step throughput (9-ch spectrogram stack"
          " + 36 scalars + CNN8 fwd/bwd/AdamW per 1s wav clip)")
# the line's times, rates, spreads and MFUs: null in a CPU rehearsal
TIMED = {"value", "vs_baseline", "feature_only_clips_per_s",
         "feature_vs_cpu_baseline", "cpu_oracle_clips_per_s", "feature_mfu",
         "fused_train_mfu", "vgg_fused_clips_per_s", "vgg_fused_train_mfu",
         "runs", "spread", "ms", "ms_runs", "clips_per_s", "mfu", "median",
         "p90", "attribution_ms"}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def noise(n: int) -> np.ndarray:
    """bench.py's seeded clips [n, 16000] f32."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, DEFAULT_FEATURES.expected_len)) * 0.05
            ).astype(np.float32)


def load_clips(n: int, root: str) -> tuple[np.ndarray, str]:
    """n clips [n, 16000] f32 and what they are (see the module
    docstring)."""
    if os.path.exists(Paths(root=root).train_csv):
        wavs, ids = parity_sweep.dataset_clips(root)
        return (wavs[np.arange(n) % len(wavs)],
                f"dataset {root}: {len(ids)} wavs, repeated to {n}")
    return noise(n), ("seeded noise: default_rng(0).standard_normal((n, "
                      "16000)) * 0.05, f32")


def _oracle_seconds(wavs: np.ndarray) -> float:
    """Seconds process_clip takes over wavs, one clip after another."""
    t0 = time.perf_counter()
    for w in wavs:
        feature_np.process_clip(w, DEFAULT_FEATURES)
    return time.perf_counter() - t0


def oracle_clips_per_s(wavs: np.ndarray) -> float:
    """The oracle's clips/s in one process started by spawn (a forked child
    of a CUDA process breaks) with one BLAS thread (more only contend with
    the host's other work: 8 threads ran a process 4.5x slower)."""
    with parity_sweep.environ(parity_sweep.ONE_THREAD), ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        return len(wavs) / pool.submit(_oracle_seconds, wavs).result()


def _fft_c2c(x, dim, *_, out_shape=None, **__) -> float:
    n = math.prod(x[d] for d in dim)
    return 5 * math.prod(x) * math.log2(n)


def _fft_r2c(x, dim, *_, out_shape=None, **__) -> float:
    n = math.prod(x[d] for d in dim)
    return 2.5 * math.prod(x) * math.log2(n)


def _fft_c2r(x, dim, *_, out_shape=None, **__) -> float:
    n = math.prod(out_shape[d] for d in dim)
    return 2.5 * math.prod(out_shape) * math.log2(n)


# FlopCounterMode wraps each formula itself: it gets the inputs' shapes, the
# op's other arguments and out_shape; (numel / n) transforms of n points
FFT_FLOPS = {torch.ops.aten._fft_c2c: _fft_c2c,
             torch.ops.aten._fft_r2c: _fft_r2c,
             torch.ops.aten._fft_c2r: _fft_c2r}


def counted_flops(fn) -> float:
    """The FLOPs FlopCounterMode counts in one call of fn (COUNTED)."""
    with FlopCounterMode(display=False, custom_mapping=FFT_FLOPS) as fc:
        fn()
    return fc.get_total_flops()


def feature_flops(b: int) -> float:
    """extract_features' counted FLOPs at batch b on the CPU plain path,
    kernel B's route (fused_gt=False) whatever TPU_BREATH_PALLAS_GT says: a
    function of the shapes alone."""
    y = torch.from_numpy(noise(b))
    return counted_flops(lambda: extract_features(y, DEFAULT_FEATURES,
                                                  fused_gt=False))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def event_ms(fn, launches: int, rounds: int, device: torch.device
             ) -> list[float]:
    """ms per launch of fn: one warm-up call, then `rounds` rounds of
    `launches` back-to-back calls, each round timed by CUDA events (on the
    host clock in a CPU rehearsal)."""
    fn()
    sync(device)
    out = []
    for _ in range(rounds):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / launches)
        else:
            t0 = time.perf_counter()
            for _ in range(launches):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / launches)
    return out


def piece(ms_runs: list[float], b: int, flops: float) -> dict:
    ms = float(np.median(ms_runs))
    return {"ms": ms, "ms_runs": ms_runs, "clips_per_s": b / ms * 1e3,
            "gflop": flops / 1e9, "mfu": flops / (ms / 1e3) / PEAK_FLOPS}


def split_pieces(model, opt, cfg, spec, w: torch.Tensor, y: torch.Tensor,
                 lr: float, gen: torch.Generator) -> dict:
    """The step split's pieces on one batch of wavs w and labels y, each a
    call: `features` (fused_features), `fwd` (forward, no grad), `grad`
    (forward + BCE + backward), `cached` (fit_step on w's precomputed
    features; its arguments may name another batch and config) and `fused`
    (fit_step on w)."""
    f, sc = loop.fused_features(w, spec)
    params = list(model.parameters())

    def features():
        loop.fused_features(w, spec)

    @torch.no_grad()
    def fwd():
        model(f, sc)

    def grad():
        torch.autograd.grad(loop.bce_with_logits(model(f, sc), y), params)

    def cached(c=cfg, ff=f, ss=sc, yy=y):
        loop.fit_step(model, opt, lr, (ff, ss, yy), None, c, gen, True)

    def fused():
        loop.fit_step(model, opt, lr, (w, y), None, cfg, gen, True, spec)

    return {"features": features, "fwd": fwd, "grad": grad,
            "cached": cached, "fused": fused}


def fused_and_split(arch: str, cfg, x: torch.Tensor, labels: torch.Tensor,
                    a: argparse.Namespace, feat_flops_clip: float,
                    device: torch.device) -> dict:
    """Parts 3/4 and 6 for one model: the fused step's clips/s runs and its
    MFU, the loss after them, the step split and the peak memory."""
    n, b = x.shape[0], a.batch
    cfg = dataclasses.replace(cfg, batch_size=b)
    spec = DEFAULT_FEATURES
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = registry.build(arch, spec.n_scalars, seed=0).to(device)
    opt = loop.make_optimizer(model, cfg)
    schedule = warmup_cosine(cfg.base_lr, (n // b) * cfg.num_epochs,
                             cfg.warmup_frac, cfg.lr_start_factor,
                             cfg.lr_eta_min)
    gen = torch.Generator(device=device).manual_seed(1)
    # bench.py:118-121's batches, on the device before any timing
    idx = torch.from_numpy(np.stack(
        [np.arange(b) + (s * b) % (n - b) for s in range(a.steps)])).to(device)
    step, loss = 0, None

    def steps():
        nonlocal step, loss
        for s in range(a.steps):
            loss, _ = loop.fit_step(model, opt, schedule(step),
                                    (x, labels), idx[s], cfg, gen, True,
                                    spec)
            step += 1
    ms = path_times.host_ms(steps, a.repeats, 1, device)
    loss = float(loss)  # the runs ended in a synchronize
    if not math.isfinite(loss):
        raise RuntimeError(f"{arch} fused step: loss {loss}")
    rates = [a.steps * b / (t / 1e3) for t in ms]
    log(f"{arch}: fused step, batch {b}, {a.repeats} runs of {a.steps} "
        f"steps; loss {loss:.4f}")

    # the step split on the first batch
    pieces = split_pieces(model, opt, cfg, spec, x[:b], labels[:b],
                          schedule(step), gen)
    rounds = min(a.repeats, SPLIT_ROUNDS)
    model.train()
    flops = {"features": feat_flops_clip * b,
             **{k: counted_flops(pieces[k])
                for k in ("fwd", "grad", "cached")}}
    flops["fused"] = flops["features"] + flops["cached"]
    split = {name: piece(event_ms(fn, a.steps, rounds, device), b,
                         flops[name]) for name, fn in pieces.items()}
    log(f"{arch}: step split")
    ms_of = {k: v["ms"] for k, v in split.items()}
    split["attribution_ms"] = {
        "features(fused-cached)": ms_of["fused"] - ms_of["cached"],
        "bwd(grad-fwd)": ms_of["grad"] - ms_of["fwd"],
        "aug+clip+adamw(cached-grad)": ms_of["cached"] - ms_of["grad"]}
    batch = (*loop.fused_features(x[:b], spec), labels[:b])
    sweep = {str(b): {"ms": ms_of["cached"],
                      "clips_per_s": split["cached"]["clips_per_s"]}}
    for bb in (b // 2, 2 * b):
        reps = -(-bb // b)
        fb, sb, yb = (t.repeat(reps, *[1] * (t.dim() - 1))[:bb]
                      for t in batch)
        cfg_b = dataclasses.replace(cfg, batch_size=bb)
        runs = event_ms(lambda: pieces["cached"](cfg_b, fb, sb, yb),
                        a.steps, rounds, device)
        ms_b = float(np.median(runs))
        sweep[str(bb)] = {"ms": ms_b, "clips_per_s": bb / ms_b * 1e3}
    split["cached_batch_sweep"] = dict(sorted(sweep.items(),
                                              key=lambda kv: int(kv[0])))
    split["max_memory_allocated_bytes"] = (
        torch.cuda.max_memory_allocated(device) if device.type == "cuda"
        else None)
    rate = float(np.median(rates))
    return {"rate": rate, "runs": rates, "loss": loss, "split": split,
            "flops": flops,
            "mfu": rate / b * flops["fused"] / PEAK_FLOPS}


def blank_timed(x):
    """x with every value under a TIMED key set to None, at any depth."""
    if isinstance(x, dict):
        return {k: None if k in TIMED else blank_timed(v)
                for k, v in x.items()}
    return x


def measure(a: argparse.Namespace) -> dict:
    device = resolve_device(a.device)
    if not (max(SERVE_BATCHES) <= a.n_clips and a.batch < a.n_clips
            and 1 <= a.baseline_clips <= a.n_clips
            and min(a.chunk, a.steps, a.repeats, a.serve_calls) >= 1):
        raise ValueError(f"want max({SERVE_BATCHES}) <= n_clips, batch < "
                         f"n_clips, 1 <= baseline_clips <= n_clips and a "
                         f"chunk, steps, repeats and serve calls of at least "
                         f"1: {a}")
    spec = DEFAULT_FEATURES
    wavs, inputs = load_clips(a.n_clips, a.root)
    log(f"inputs: {inputs}")

    cpu_rate = oracle_clips_per_s(wavs[:a.baseline_clips])
    log(f"oracle: {a.baseline_clips} clips, one process, one BLAS thread")
    feat_flops_clip = feature_flops(FLOP_COUNT_BATCH) / FLOP_COUNT_BATCH

    x = torch.from_numpy(wavs).to(device)

    def feature_pass():
        for lo in range(0, a.n_clips, a.chunk):
            extract_features(x[lo:lo + a.chunk], spec)
    feat_rates = [a.n_clips / (t / 1e3)
                  for t in path_times.host_ms(feature_pass, a.repeats, 1,
                                              device)]
    feat_rate = float(np.median(feat_rates))
    log(f"feature only: {a.n_clips} clips in chunks of {a.chunk}")

    labels = torch.from_numpy(np.tile(np.float32([0.0, 1.0]),
                                      -(-a.n_clips // 2))[:a.n_clips]
                              ).to(device)
    cuda_devices = [device.index or 0] if device.type == "cuda" else []
    # the steps fit runs: inside its reproducible scope
    with torch.random.fork_rng(devices=cuda_devices), loop.reproducible():
        torch.manual_seed(0)  # dropout masks
        runs = {arch: fused_and_split(arch, cfg, x, labels, a,
                                      feat_flops_clip, device)
                for arch, cfg in (("cnn8", CNN8_TRAIN), ("vgg", VGG_TRAIN))}

    models = path_times.serve_models(("cnn8", "vgg"), device)
    weights = softmax_weights(SERVE_VAL_SCORES)
    serve = {}
    for b in SERVE_BATCHES:
        ms = path_times.host_ms(
            lambda: path_times.serve_call(models, weights, wavs[:b], device),
            a.serve_calls, SERVE_WARMUP, device)
        serve[str(b)] = {"calls": a.serve_calls,
                         "median": float(np.median(ms)),
                         "p90": float(np.percentile(ms, 90))}
        log(f"serve: B = {b}, {a.serve_calls} calls")

    cnn, vgg = runs["cnn8"], runs["vgg"]
    rate_runs = {"feature_only_clips_per_s": feat_rates,
                 "fused_clips_per_s": cnn["runs"],
                 "vgg_fused_clips_per_s": vgg["runs"]}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": torch.cuda.device_count(),
               "name_power_limit": parity_sweep.device_label(device)}
    else:
        dev = {"platform": "cpu"}
    line = {
        "metric": METRIC,
        "value": cnn["rate"],
        "unit": "clips/s",
        "vs_baseline": cnn["rate"] / cpu_rate,
        "feature_only_clips_per_s": feat_rate,
        "feature_vs_cpu_baseline": feat_rate / cpu_rate,
        "cpu_oracle_clips_per_s": cpu_rate,
        "cpu_baseline_clips": a.baseline_clips,
        "feature_mfu": feat_rate * feat_flops_clip / PEAK_FLOPS,
        "fused_train_mfu": cnn["mfu"],
        "vgg_fused_clips_per_s": vgg["rate"],
        "vgg_fused_train_mfu": vgg["mfu"],
        "device": dev,
        "gammatone_route": ("B''" if os.environ.get("TPU_BREATH_PALLAS_GT")
                            == "1" else "B"),
        "inputs": inputs,
        "repeats": a.repeats,
        "sizes": {"n_clips": a.n_clips, "chunk": a.chunk, "batch": a.batch,
                  "steps": a.steps, "serve_calls": a.serve_calls,
                  "split_rounds": min(a.repeats, SPLIT_ROUNDS)},
        "runs": rate_runs,
        "spread": {k: [min(v), max(v)] for k, v in rate_runs.items()},
        "loss": {"cnn8": cnn["loss"], "vgg": vgg["loss"]},
        "serve_ms": serve,
        "split": {"cnn8": cnn["split"], "vgg": vgg["split"]},
        "flops": {"feature_gflop_per_clip": feat_flops_clip / 1e9,
                  "feature_counted_at_batch": FLOP_COUNT_BATCH,
                  "pieces_gflop": {arch: {k: v / 1e9
                                          for k, v in r["flops"].items()}
                                   for arch, r in runs.items()},
                  "counted": COUNTED},
        "peak_flops": PEAK_FLOPS,
        "peak_source": PEAK_SOURCE,
    }
    return line if device.type == "cuda" else blank_timed(line)


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default="input",
                   help="dataset root (train.csv, test.csv, train/, test/);"
                        " without one, seeded noise")
    p.add_argument("--n-clips", type=int, default=N_CLIPS)
    p.add_argument("--chunk", type=int, default=CHUNK,
                   help="clips a feature call in the feature-only part")
    p.add_argument("--batch", type=int, default=TRAIN_BATCH)
    p.add_argument("--steps", type=int, default=TRAIN_STEPS,
                   help="steps a fused run; launches a split round")
    p.add_argument("--baseline-clips", type=int, default=BASELINE_CLIPS)
    p.add_argument("--repeats", type=int, default=REPEATS)
    p.add_argument("--serve-calls", type=int, default=SERVE_CALLS)
    line = measure(p.parse_args(argv))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
