"""Roofline of the feature graph (counterpart of tools/feature_roofline.py):
for the whole graph and each named stage (utils/profiling.feature_stages),
how far its achieved FLOP/s and bytes/s sit from the card's peaks, and
what bounds it.

For each stage:
- wall_ms: all chunks of --chunk clips, one stage call a chunk, by CUDA
  events (profiling.device_ms; the host clock on the CPU), the median of
  3 runs after one warm-up run, under spectral.full_f32() as the feature
  graph runs; eagerly, op by op, not as precompute's captured graph
  (features.extract_features_compiled), since a graph replays the whole
  stack and hides its stages;
- gflops: counted_flops (COUNTED: convolutions, mm and bmm by
  torch.utils.flop_counter, FFTs at 5 n log2 n a complex transform and
  2.5 n log2 n a real one; no elementwise work) of one chunk on the CPU
  plain path, kernel B's route whatever TPU_BREATH_PALLAS_GT says, times
  the chunks: `full` at B = 8 is feature_flops(8). The CUDA kernels are
  called through ctypes, out of a counter's sight, so counting the plain
  path makes the count the same whichever route runs on the card;
- gbytes_accessed: of the same chunk in the same pass, the bytes each
  dispatched aten op reads and writes (each tensor argument read once, each
  tensor result written once; the destination of copy_, fill_ and zero_
  and the template of zeros_like and its kin are not read; views and
  allocation-only factory ops move nothing), with
  each CUDA kernel's call counted by ops/cuda/work.py's model (its inputs
  read once, its outputs written once) instead of its plain version's
  steps; the count is the same on the CPU and on the card. It is the ops'
  own traffic, not measured DRAM bytes: an operand that L2 serves counts
  all the same;
- flop_frac: achieved FLOP/s over PEAK_FLOPS (989 TFLOP/s bf16, the
  JAX tool's peak kind); the graph runs in f32 and f64, whose peak
  (work.F32_FLOPS) is 15x lower, so "compute-bound" cannot fire on it;
  hbm_frac: the op-traffic share, achieved op bytes/s over work.HBM_BPS
  (3.35 TB/s HBM3);
- bound: classify(flop_frac, hbm_frac).

On the CPU (--device cpu, a rehearsal) the times come from the host clock
and the shares and bound are null: a host time over the card's peaks is no
device metric.

    python -m tpu_breath_torch.utils.feature_roofline [--n 2048]
        [--chunk 128] [--root input] [--device cuda] [--out PATH]

Inputs: the dataset's clips under --root, decoded as precompute decodes
them and repeated to --n, when it holds one, else noise (seeded,
default_rng(0) x 0.05); the report's `inputs` says which. Prints the
report as JSON and writes it to --out when given.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import sys

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from tpu_breath_torch.config import DEFAULT_FEATURES, Paths
from tpu_breath_torch.device import resolve_device
from tpu_breath_torch.features import extract_features
from tpu_breath_torch.ops import spectral
from tpu_breath_torch.ops.cuda import (epilogue_kernel, gammatone_kernel,
                                       lpc_kernel, peaks_kernel, tuning_kernel,
                                       work)
from tpu_breath_torch.utils import parity_sweep, profiling

N_CLIPS = 2048
CHUNK = 128
RUNS = 3
PEAK_FLOPS = 989e12
PEAK_SOURCE = ("NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, no "
               "sparsity, at 700 W")
COUNTED = ("convolutions, mm and bmm (forward and backward) by "
           "torch.utils.flop_counter; FFTs at 5 n log2 n (c2c) and 2.5 n "
           "log2 n (r2c, c2r) a transform; elementwise work not counted")
# a stage is compute-bound above this share of the peak FLOP/s,
# bandwidth-bound above it of the peak bytes/s, latency/serial-bound else
BOUND_SHARE = 0.30
BOUNDS = ("compute-bound", "bandwidth-bound", "latency/serial-bound")
BYTES_COUNTED = ("op traffic, not measured DRAM bytes: on kernel B's "
                 "route, each dispatched aten op's tensor arguments read "
                 "once and tensor results written once, the destination of "
                 "copy_, fill_ and zero_ and the template of zeros_like "
                 "and its kin not read, views and "
                 "allocation-only factory ops moving nothing; each CUDA "
                 "kernel's call by ops/cuda/work.py's model (inputs read "
                 "once, outputs written once)")
aten = torch.ops.aten
ALLOCATION_ONLY = frozenset({aten.empty, aten.empty_strided, aten.empty_like,
                             aten.new_empty, aten.new_empty_strided,
                             aten.resize_, aten._unsafe_view,
                             aten.lift_fresh})
# ops that never read their first argument's data (they overwrite it or
# take only its shape): only the rest of the arguments count as read
FIRST_UNREAD = frozenset({aten.copy_, aten.fill_, aten.zero_,
                          aten.zeros_like, aten.ones_like, aten.full_like,
                          aten.new_zeros, aten.new_ones, aten.new_full})
# (module, wrapper) -> the kernel's name and its work, from the wrapper's
# arguments: the kernels the feature graph calls (D is on no path)
KERNELS = {
    (tuning_kernel, "estimate_tuning_index"):
        lambda pitches, mags, bins_per_octave: (
            "A", work.tuning(pitches.shape[0], pitches[0].numel())),
    (epilogue_kernel, "fused_epilogue"):
        lambda mag, fb, plain=False: (
            "B'" if plain else "B",
            work.epilogue(*mag.shape, fb.shape[0], plain)),
    (gammatone_kernel, "fused_gammatone"):
        lambda frames, basis, fb: (
            "B''", work.gammatone(*frames.shape, basis.shape[1] // 2,
                                  fb.shape[0])),
    (peaks_kernel, "suppress_peaks"):
        lambda scores, distance, rounds: (
            "C", work.peaks(*scores.shape, rounds)),
    (lpc_kernel, "lpc_frames"):
        lambda y_emph, window, hop, n_frames, order: (
            "E", work.lpc(*y_emph.shape, window.shape[0], n_frames, order)),
}


def noise(n: int) -> np.ndarray:
    """Seeded clips [n, 16000] f32: default_rng(0).standard_normal * 0.05."""
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


def classify(flop_frac: float | None, hbm_frac: float | None) -> str:
    """The JAX tool's rule: compute-bound above BOUND_SHARE of the peak
    FLOP/s, else bandwidth-bound above it of the peak bytes/s, else
    latency/serial-bound (dominated by dependent steps or launches)."""
    if flop_frac is not None and flop_frac > BOUND_SHARE:
        return BOUNDS[0]
    if hbm_frac is not None and hbm_frac > BOUND_SHARE:
        return BOUNDS[1]
    return BOUNDS[2]


def _moves_nothing(func) -> bool:
    """A view (its result aliases an argument without writing it) or an
    allocation-only op."""
    return func.overloadpacket in ALLOCATION_ONLY or any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in func._schema.returns)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size()
               for x in _pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Counts the bytes of every aten op dispatched inside it (see the
    module docstring); paused inside a kernel's wrapper (count_kernels),
    which adds the kernel's modelled bytes instead."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.paused = 0
        self.kernel_calls: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused and not _moves_nothing(func):
            read = args[1:] if func.overloadpacket in FIRST_UNREAD else args
            reads = (read, {k: v for k, v in kwargs.items() if k != "out"})
            self.bytes += _nbytes(reads) + _nbytes(out)
        return out


@contextlib.contextmanager
def count_kernels(counter: ByteCounter):
    """Inside the block each kernel wrapper of KERNELS pauses the counter
    while it runs (its plain version on the CPU, its launch on the card) and
    adds its work.py bytes."""
    saved = {key: getattr(*key) for key in KERNELS}

    def counted(key, wrapper):
        def call(*args, **kwargs):
            counter.paused += 1
            try:
                out = wrapper(*args, **kwargs)
            finally:
                counter.paused -= 1
            name, w = KERNELS[key](*args, **kwargs)
            counter.bytes += w.bytes
            counter.kernel_calls[name] += 1
            return out
        return call

    for key, wrapper in saved.items():
        setattr(*key, counted(key, wrapper))
    try:
        yield
    finally:
        for (mod, name), wrapper in saved.items():
            setattr(mod, name, wrapper)


@torch.no_grad()
def count(fn, y: torch.Tensor) -> dict:
    """One call of fn(y) on y's device after a warm call (the constants'
    first uploads are no part of the graph), on kernel B's route: its
    counted FLOPs, its bytes and the kernels it calls."""
    with parity_sweep.environ({"TPU_BREATH_PALLAS_GT": "0"}), \
            spectral.full_f32():
        fn(y)
        counter = ByteCounter()
        with count_kernels(counter), counter:
            flops = counted_flops(lambda: fn(y))
    return {"flops": flops, "bytes": counter.bytes,
            "kernel_calls": dict(counter.kernel_calls)}


@torch.no_grad()
def wall_ms(fn, chunks: torch.Tensor, device: torch.device) -> float:
    """ms of fn over every chunk of chunks [n, chunk, 16000]: the median of
    RUNS runs after one warm-up run."""
    def run():
        for c in chunks:
            fn(c)
    with spectral.full_f32():
        return float(np.median(profiling.device_ms(run, device, rounds=RUNS,
                                                   warmup=1)))


def roofline(wavs: np.ndarray, chunk: int = CHUNK, device="cuda") -> dict:
    """The report over wavs [N, 16000] in chunks of `chunk` clips (N // chunk
    chunks): per stage the module docstring's keys, with the counts of one
    chunk (flops_per_chunk, bytes_per_chunk, kernel_calls_per_chunk)."""
    device = resolve_device(device)
    n_chunks = len(wavs) // chunk
    if n_chunks < 1:
        raise ValueError(f"{len(wavs)} clips: want at least one chunk of "
                         f"{chunk}")
    n = n_chunks * chunk
    x = torch.from_numpy(np.ascontiguousarray(wavs[:n], np.float32))
    chunks = x.to(device).reshape(n_chunks, chunk, -1)
    on_card = device.type == "cuda"
    rows = {}
    for name, fn in profiling.feature_stages().items():
        c = count(fn, x[:chunk])
        ms = wall_ms(fn, chunks, device)
        flops, nbytes = c["flops"] * n_chunks, c["bytes"] * n_chunks
        flop_frac = flops / (ms / 1e3) / PEAK_FLOPS if on_card else None
        hbm_frac = nbytes / (ms / 1e3) / work.HBM_BPS if on_card else None
        rows[name] = {
            "wall_ms": ms, "clips_per_s": n / (ms / 1e3),
            "gflops": flops / 1e9, "gbytes_accessed": nbytes / 1e9,
            "flop_frac": flop_frac, "hbm_frac": hbm_frac,
            "bound": classify(flop_frac, hbm_frac) if on_card else None,
            "flops_per_chunk": c["flops"], "bytes_per_chunk": c["bytes"],
            "kernel_calls_per_chunk": c["kernel_calls"]}
        print(f"[{name:12s}] {ms:10.3f} ms  flop_frac={flop_frac}  "
              f"hbm_frac={hbm_frac}  {rows[name]['bound']}",
              file=sys.stderr, flush=True)
    return {"n_clips": n, "chunk": chunk,
            "device": parity_sweep.device_label(device),
            "timer": "cuda events" if on_card else "host clock",
            "gammatone_route_timed": ("B''" if os.environ.get(
                "TPU_BREATH_PALLAS_GT") == "1" else "B"),
            "peak_flops": PEAK_FLOPS, "peak_flops_source": PEAK_SOURCE,
            "peak_hbm_bytes_s": work.HBM_BPS,
            "peak_hbm_source": work.HBM_SOURCE,
            "flops_counted": COUNTED, "bytes_counted": BYTES_COUNTED,
            "stages": rows}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N_CLIPS)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--root", default="input",
                    help="dataset root (train.csv, test.csv, train/, test/)"
                         "; without one, seeded noise")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the report here")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    wavs, inputs = load_clips(args.n, args.root)
    report = {"inputs": inputs, **roofline(wavs, args.chunk, device)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1), flush=True)
    return report


if __name__ == "__main__":
    main()
