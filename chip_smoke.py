"""Chip smoke test of the PyTorch/CUDA port (tpu_breath_torch) on the GPU.

    python3 chip_smoke.py              # one card, every phase below
    python3 chip_smoke.py --cards 4    # data parallelism across 4 cards

Phases (each raises on failure; the script then exits non-zero and prints
no result line):
  1. environment: torch/CUDA versions, the card's name and power limit;
     fails without a CUDA device;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel,
     sm_90a) and the host's wav decoder (csrc/wavio.cpp, g++), and print
     the times;
  3. each kernel (A, B, B', B'', C, D, E) against its plain PyTorch
     version on the card, at the main path's shapes with B = 8 and B = 128
     (golden wavs + seeded noise, silence, an impulse, quantized
     plateaus), with times on both timers (the table's and a primed
     stream's) and the least time the card could take (bound); B's, B''s,
     B'''s, D's and E's rows of the clips both sizes share must be
     bit-equal, E's zeroed frames those of its plain version; C also on
     the dense worst case (a candidate every other sample) and on rows of
     40,000 samples (its list then in device memory), exactly; D, on no
     path (as in the JAX package), at the shapes of its function, beside
     conv1d; then the kernels past their main-path tiles
     (check_past_tiles): B, B', B'' at larger T, F, G and K, B'' at
     B = 65,537, A past 28,000 pairs a clip and D at 100,000 samples;
  4. extract_features on the card for the golden wavs, against the golden
     npz and the port's CPU result; with fused_gt (kernel B'') against the
     default path;
  graphs. the captured CUDA graphs (graphs.py) against the eager path:
     extract_features_compiled's replays bit-equal to extract_features at
     B = 1, 8 and 128 with fused_gt off and on, two inputs in turn, each
     replay adding its graph's launches; a Server of CNN8 + VGG bit-equal
     to the eager composition at micro-batches of 1 and 8; then eager and
     graphed in turns: serve at B = 1 and 8, extract_features_batched over
     2,048 clips, the fused step's features at batch 512 (4 chunks of
     128), the profiler's busy share of a serve call, each graph's capture
     time and pool;
     printed as {"graphs": ...}. Every later phase runs the graphed path
     (features, serve, train and eval steps);
  steps. fit's step and evaluation programs (loop.TrainStep,
     loop.Predictor) as CUDA graphs against the same programs eager
     (graphs.eager()), batch 512 on seeded clips: (i) CNN8 and VGG,
     cached and fused (kernel B), 8 steps from one seeded state each way,
     augmentation on: losses, accuracies, every parameter and buffer,
     both moments and the step count bit-equal, the fused graph
     holding A 8 / B 4 / C 4 / E 4; (ii) in turns: ms a step (CUDA
     events), the
     host's ms to queue one, one traced step (kernels, host launches,
     busy share; a replay's kernels inside its train_step range), an
     evaluation of 256 rows in a padded batch of 1,024 (logits
     bit-equal), each graph's capture time and pool; printed as
     {"steps": ...};
  parity. the parity sweep (utils/parity_sweep.py) on 512 seeded clips
     (the golden wavs and shifts of them at seeded gains, silence, an
     impulse, quantized plateaus, noise), 128 of them through the port's
     NumPy oracle in spawned processes: run with kernel B and with B''
     (fused_gt) against one oracle run; each holds the NaN masks equal, the
     real clips with no tuning flip inside PARITY.md's envelope (every
     channel <= 2.3e-4 abs, scalars <= 6.9e-4 rel, floor 1e-2) and no flip
     wider than one count (tie width <= 1); A, B, B'', C, E must launch;
     the lpc channel's worst error with kernel E and with the float64 loop
     it replaced (the B sweep again, eager, against its own oracle run);
  5. serve: seeded CNN8 checkpoint, `predict --from-wav --archs cnn8` through
     cli.main on cuda; kernels A, B, C, E must launch;
  decode. the threaded C++ decoder (data/wav.load_wav_batch) against its
     plain numpy version on seeded wavs of every format it reads (PCM
     8/16/24/32, IEEE f32/f64, EXTENSIBLE, 1-3 channels, 8,000-48,000 Hz,
     short and long, a LIST chunk): bit-equal at 16 kHz, within 2e-6 where
     resampled; the JAX package's error rule on a batch with a file that
     is not RIFF and a missing path (zeros and both listed, a raise
     without `errors`); then phase 6's 1,536 clips decoded natively on all
     cores, on one thread and by the plain loop, 5 runs each in turns,
     host clock, printed on one [decode] line;
  6. e2e on a seeded synthetic dataset (1,280 labelled clips -> 1,024 train /
     256 val, 256 test; written by the decode phase) through cli.main on
     cuda: precompute (its decode and feature lines logged) with
     TPU_BREATH_PALLAS_GT=1, train --archs cnn8,vgg --epochs 6 --predict
     (full width, batch 512), train --archs cnn8 --epochs 7 --resume,
     predict from the cache and predict --from-wav; kernels A, B, B'', C
     must launch; then the AST (ast_cli): train --archs ast_base --epochs
     2 from the cache and predict --from-wav --archs ast_base, its served
     probabilities and its logits against the CPU's;
  repro. same seed, same history, with every cuDNN flag at its default
     (fit's own reproducible scope), on phase 6's dataset and cache: train
     cnn8,vgg 6 epochs again equals phase 6 bit for bit; train --fused
     cnn8,vgg twice, equal; a 7-epoch cnn8 run stopped at its 4th epoch
     line and resumed equals an uninterrupted one; --seed 1 differs from
     seed 0; A/B''/C/E launched 384/192/192/192 times;
  7. fused: the features inside one fused step against the cache's rows
     (equal), then train --archs cnn8,vgg --epochs 6 from the cache and
     train --fused ... --predict with TPU_BREATH_PALLAS_GT=1, cuDNN flags
     at their defaults: equal histories, A/B''/C/E launched 192/96/96/96
     times, a submission;
  mesh. data parallelism (parallel/mesh.py): (i) one NCCL rank in this
     process, where the mesh's programs replay CUDA graphs: the streamed
     step programs graphed against eager, 8 steps of CNN8 and VGG,
     cached and fused, bit-equal (the fused graph A 8 / B 4 / C 4 / E 4),
     then for CNN8 in turns ms a step (CUDA events, the loader included), host
     ms to issue one and a traced step (host launches, kernels, busy
     share); fit's streaming path (graphed) against the resident path
     (cached CNN8, batch 512, 2 epochs, f32: train accuracy equal, losses
     within 1e-3); a graphed fit's epochs waiting on the host once under
     sync debug mode "error"; the sharded precompute of phase 6's clips
     (kernel B''), eager and graphed in turns, bit-equal to phase 6's
     cache, clips/s, one host wait a call; printed as {"mesh": ...};
     (ii) two ranks sharing the card over gloo (eager), started as
     torchrun starts them: precompute --mesh 2
     (TPU_BREATH_PALLAS_GT=1) gives phase 6's cache bit for bit, train
     --mesh 2 cnn8,vgg (6 epochs, augmentation from the 5th) and train
     --fused --mesh 2 cnn8 (2 epochs, kernel B) end with
     bit-equal weights on both ranks; A, B'', C and A, B, C, E launch in each
     rank; ms per step on the host clock;
  8. profile: precompute --profile (stages, slowest first) and train
     --fused --archs cnn8 --epochs 2 --profile: 4 train_step spans on the
     device (the first step eager, with its fused_features span; the
     other three replays, every kernel of a replay inside its step's
     span), the top device operations of the replayed steps, kernels A,
     B'', C among them;
  tools. the port's tools (tpu_breath_torch/utils): the feature roofline
     at its defaults (2,048 seeded clips, chunks of 128), its report printed
     as {"roofline": ...}: shares in (0, 1.05], known bounds, bytes
     counted alike on the card and the CPU, A, C, E and B launched;
     seed_sweep (cnn8, seeds 0 and 1, cached and fused, 2 epochs) on
     phase 6's dataset and summarize, agreeing;
     ensemble_val on phase 6's checkpoints; deviation_sweep folded into a
     parity sweep by --deviations; find_flips on the parity phase's clips;
  9. the kernels JSON line (launches by path: steps, serve, e2e, repro,
     fused, mesh, parity, tools; a graph's replay counts the kernels it
     holds), then the last line: {"ok": true, "device": {...}}.

With --cards N (N cards): phases 1 and 2, then the seeded dataset's
precompute in one process, cached CNN8 and VGG fits on one NCCL rank with
their step times, and mesh_runs over N ranks, one a card over NCCL (the
mesh's graphs): precompute --mesh N bit-equal to it, train --mesh N
cnn8,vgg and train --fused --mesh N cnn8 with bit-equal weights on every
rank, each train run again inside graphs.eager() with the same weights
bit for bit; the step times at 1 and N ranks as {"cards": ...}; then the
last line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

from tpu_breath_torch.graphs import add_launches, read_launches
from tpu_breath_torch.ops.cuda import work as work_lib
from tpu_breath_torch.utils.kernel_times import calls as kernel_calls
from tpu_breath_torch.utils.kernel_times import (LAUNCHES, WARMUP, clip_set,
                                                 cqt_args, dense_scores,
                                                 golden, kernel_inputs,
                                                 table_times)
from tpu_breath_torch.utils.profiling import device_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 16000
MICRO = 8
CHUNK = 128
STEP_BATCH = 512  # the configs' batch size
STEPS = 8
# kernel -> max abs err against its plain version: the JAX package's test
# tolerances (tests/test_pallas_epilogue.py), 1e-5 for the float64
# variants, 5e-5 for the f32 one
TOLS = {"B": 1e-5, "B'": 5e-5, "B''": 1e-5}
# kernel D: max|a - b| / max|b| against its plain version (float64), the
# JAX package's tests/test_pallas_cqt.py bound
TOL_D = 1e-5
# kernel E: max |a - b| / max(1, |b|) against its plain version (both
# float64, rounded to f32 once)
TOL_E = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def clips(n: int, seed: int = 0) -> np.ndarray:
    """[n, 16000] f32: seeded Gaussian noise of loudness 1e-3 to 0.3."""
    rng = np.random.default_rng(seed)
    amp = 10.0 ** rng.uniform(-3, -0.5, size=(n, 1))
    return (rng.standard_normal((n, SR)) * amp).astype(np.float32)


def host_ms(fn, n: int, warmup: int) -> list[float]:
    """Host-clock ms of fn() and a synchronize of the card, n times, after
    `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_env() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi name, power.limit: {smi}")
    try:
        import triton
        log(f"[env] triton {triton.__version__}")
    except ImportError:
        log("[env] triton not installed")
    return {"smi": smi}


def phase_build() -> None:
    from tpu_breath_torch.data import wav as wav_io
    from tpu_breath_torch.ops.cuda import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"[build] {nvcc[-1]}")
    info = _build.build()
    _build.lib()
    log(f"[build] {os.path.relpath(info['path'], ROOT)} in "
        f"{info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    info = wav_io.build()
    wav_io._native_lib()
    cxx = subprocess.run([wav_io.compiler(), "--version"],
                         capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    log(f"[build] wav decoder: {cxx}; {os.path.relpath(info['path'], ROOT)} "
        f"in {info['seconds']:.2f} s")


def bounds(x: dict, rounds: int) -> dict:
    """kernel -> (bound_ms, bound_by) at these inputs, by the package's
    model of each kernel's least work (ops/cuda/work.py): the larger of the
    bytes each input read once and each output written once over the
    card's HBM rate, and the operations over the peak rate of their type.
    A is its two calls (bpo 12 and 36); C makes `rounds` passes."""
    b, f, t = x["mag"].shape
    g = x["fb"].shape[0]
    k = x["frames"].shape[-1]
    pairs = [x[p][0].numel() for p in ("p12", "p36")]
    work = {
        "A": work_lib.tuning(b, pairs[0]) + work_lib.tuning(b, pairs[1]),
        "B": work_lib.epilogue(b, f, t, g),
        "B'": work_lib.epilogue(b, f, t, g, plain=True),
        "B''": work_lib.gammatone(b, t, k, f, g),
        "C": work_lib.peaks(b, x["scores"].shape[-1], rounds),
        "D": work_lib.cqt(b, x["y"].shape[-1], *cqt_args()),
        "E": work_lib.lpc(b, x["y"].shape[-1], x["lpc"][1].shape[0],
                          *x["lpc"][3:]),
    }
    return {name: w.bound_ms() for name, w in work.items()}


def phase_kernels() -> dict:
    """Kernel vs plain on the card; returns errors and times per kernel."""
    import scipy.signal
    from tpu_breath_torch.ops import dft
    from tpu_breath_torch.ops.cuda import epilogue_kernel as ek

    rounds = SR // (SR // 10) + 2
    res = {k: {"err": 0.0}
           for k in ("A", "B", "B'", "B''", "C", "C dense", "D", "E")}
    n_shared = len(golden()) + 2  # clip_set's first clips at every size
    gt_rows, cqt_rows, lpc_rows, mags = {}, {}, {}, {}
    for b in (MICRO, CHUNK):
        y = torch.from_numpy(clip_set(b, seed=b)).cuda()
        x = kernel_inputs(y)
        res["bound", b] = bounds(x, rounds)
        # kernel C's worst case: a candidate every other sample
        dense = dense_scores(b, seed=b)
        # kernel -> (kernel call, plain call) at this batch's main-path
        # shapes (A, B, B', B'', C, C's worst case and D as
        # utils/kernel_times.py times them)
        calls = kernel_calls(x, dense)
        out = {k: (run(), plain()) for k, (run, plain) in calls.items()}
        torch.cuda.synchronize()
        for (got, ref), bpo in zip(zip(*out["A"]), (12, 36)):
            if not torch.equal(got, ref):
                raise AssertionError(f"kernel A bpo {bpo} B {b}: "
                                     f"{got.tolist()} != {ref.tolist()}")
        errs = {}
        for k, tol in TOLS.items():
            got, ref = out[k]
            errs[k] = float((got - ref).abs().max())
            if not errs[k] <= tol:
                raise AssertionError(f"kernel {k} B {b}: max abs err "
                                     f"{errs[k]} > {tol}")
            res[k]["err"] = max(res[k]["err"], errs[k])
        gt_rows[b] = out["B''"][0][:n_shared]
        cqt_rows[b] = out["D"][0][:n_shared]
        mags[b] = x["mag"]
        (vals, kept), (rvals, rkept) = out["C"]
        err_c = float((vals - rvals).abs().max())
        if not (torch.equal(kept, rkept) and torch.equal(vals, rvals)):
            raise AssertionError(f"kernel C B {b}: kept equal "
                                 f"{torch.equal(kept, rkept)}, err {err_c}")
        env = dft.hilbert_envelope(y).cpu().numpy()
        for i in range(b):
            peaks, _ = scipy.signal.find_peaks(
                env[i], height=float(env[i].mean()), distance=SR // 10)
            if int(kept[i].sum()) != len(peaks):
                raise AssertionError(f"kernel C clip {i}: "
                                     f"{int(kept[i].sum())} != {len(peaks)}")
        res["C"]["err"] = max(res["C"]["err"], err_c)
        got, ref = out["D"]
        rel_d = float((got - ref).abs().max() / ref.abs().max())
        if not (got.shape == (b, 252, 63) and rel_d < TOL_D):
            raise AssertionError(f"kernel D B {b}: {tuple(got.shape)}, max "
                                 f"rel err {rel_d} >= {TOL_D}")
        res["D"]["err"] = max(res["D"]["err"],
                              float((got - ref).abs().max()))
        got, ref = out["E"]
        zero = (ref == 0).all(dim=1, keepdim=True).expand_as(ref)
        rel_e = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
        if not (torch.equal((got == 0).all(dim=1, keepdim=True).expand_as(
                got), zero) and torch.equal(got[zero], ref[zero])
                and rel_e <= TOL_E):
            raise AssertionError(f"kernel E B {b}: max |a-b|/max(1,|b|) "
                                 f"{rel_e} (tol {TOL_E}), or its zeroed "
                                 f"frames differ from the plain version's")
        res["E"]["err"] = max(res["E"]["err"],
                              float((got - ref).abs().max()))
        lpc_rows[b] = got[:n_shared]
        log(f"[kernels] B={b}: A exact at bpo 12/36, "
            + ", ".join(f"{k} err {errs[k]:.3g} (tol {t:g})"
                        for k, t in TOLS.items())
            + f", C kept exact (= scipy counts), vals err {err_c:.3g}, "
            f"D max|a-b|/max|b| {rel_d:.3g} (tol {TOL_D:g}), "
            f"E max|a-b|/max(1,|b|) {rel_e:.3g} (tol {TOL_E:g}; "
            f"{int(zero[:, 0].sum())} frames zeroed, as plain)")
        (vals, kept), (rvals, rkept) = out["C dense"]
        if not (torch.equal(kept, rkept) and torch.equal(vals, rvals)):
            raise AssertionError(f"kernel C dense B {b}: differs from its "
                                 "plain version")
        res["bound", b]["C dense"] = bounds({**x, "scores": dense},
                                            rounds)["C"]
        log(f"[kernels] B={b}: C on the dense worst case (8,000 candidates "
            f"a clip, {int(kept.sum())} kept) equals its plain version")
        for k, (run, plain) in calls.items():
            t = res[k][b] = table_times(run, plain)
            bound, by = res["bound", b][k]
            log(f"[time] kernel {k} B={b}: {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by}); "
                f"stream primed: {t['primed_ms']:.4f} ms, plain "
                f"{t['plain_primed_ms']:.4f} ms")
        res["D", "library", b] = device_ms(cqt_conv1d(y), "cuda", LAUNCHES,
                                           warmup=WARMUP)[0]
        log(f"[time] kernel D B={b}: library conv1d (f32, TF32 off; the "
            f"complex response without |.|) {res['D', 'library', b]:.4f} ms")
    # B'' computes each clip alone: the clips both sizes share give the
    # same bits (the fused step's features equal the cache's rows)
    if not torch.equal(gt_rows[MICRO], gt_rows[CHUNK]):
        raise AssertionError(f"kernel B'': the {n_shared} shared clips' rows "
                             f"differ between B = {MICRO} and B = {CHUNK}")
    log(f"[kernels] B'': the rows of the {n_shared} clips B = {MICRO} and "
        f"B = {CHUNK} share (golden wavs, silence, impulse) are bit-equal")
    # D computes each clip alone too, whatever the blocks a clip is dealt to
    if not torch.equal(cqt_rows[MICRO], cqt_rows[CHUNK]):
        raise AssertionError(f"kernel D: the {n_shared} shared clips' rows "
                             f"differ between B = {MICRO} and B = {CHUNK}")
    log(f"[kernels] D: the rows of the {n_shared} shared clips are "
        f"bit-equal at B = {MICRO} and B = {CHUNK}")
    # E computes each frame in one warp, in an order fixed by its length
    if not torch.equal(lpc_rows[MICRO], lpc_rows[CHUNK]):
        raise AssertionError(f"kernel E: the {n_shared} shared clips' rows "
                             f"differ between B = {MICRO} and B = {CHUNK}")
    log(f"[kernels] E: the rows of the {n_shared} shared clips are "
        f"bit-equal at B = {MICRO} and B = {CHUNK}")
    # B and B' too, on the same magnitudes of those clips in both batches
    shared = mags[MICRO][:n_shared]
    for k, plain in (("B", False), ("B'", True)):
        ep_rows = [ek.fused_epilogue(torch.cat([shared, mags[b][n_shared:]]),
                                     x["fb"], plain=plain)[:n_shared]
                   for b in (MICRO, CHUNK)]
        if not torch.equal(*ep_rows):
            raise AssertionError(f"kernel {k}: the {n_shared} shared clips' "
                                 f"rows differ between B = {MICRO} and "
                                 f"B = {CHUNK}")
        log(f"[kernels] {k}: the rows of the {n_shared} shared clips are "
            f"bit-equal at B = {MICRO} and B = {CHUNK}")
    check_long_rows(40_000)
    check_past_tiles()
    return res


def check_past_tiles() -> None:
    """The kernels at shapes past their main path's tiles or shared memory,
    which the JAX functions take: B and B' at T = 65 and 200, F = 300 and
    G = 80 (in ranges of one block's tiles), B'' at T = 128, K = 1,024
    (F = 513), K = 520 and G = 80 (in ranges; K padded inside the kernel)
    and at B = 65,537 (more clips than a grid column), A on clips of 4 s
    (about 62,000 pairs, past shared memory) and D on rows of 100,000 samples
    (read from device memory), each against its plain version with the
    tolerances above, A exactly."""
    from tpu_breath_torch.ops import chroma, spectral
    from tpu_breath_torch.ops.cuda import (cqt_kernel as ck,
                                           epilogue_kernel as ek,
                                           gammatone_kernel as gk,
                                           tuning_kernel as tk)

    y = torch.from_numpy(clip_set(MICRO, seed=65)).cuda()
    errs = []
    for t, f, g in ((65, 257, 64), (200, 257, 64), (63, 300, 64),
                    (63, 257, 80)):
        n_fft, hop = 2 * (f - 1), (SR - 1) // (t - 1)
        mag = spectral.stft_mag_cr(y, n_fft, hop)[..., :t].contiguous()
        fb = spectral.device_const(spectral.mel_matrix, SR, n_fft, g,
                                   device=y.device)
        for k, plain in (("B", False), ("B'", True)):
            got = ek.fused_epilogue(mag, fb, plain=plain)
            with spectral.full_f32():
                ref = ek.fused_epilogue_plain(mag, fb, plain=plain)
            err = float((got - ref).abs().max())
            if not (got.shape == (MICRO, g, t) and err <= TOLS[k]):
                raise AssertionError(f"kernel {k} at T {t}, F {f}, G {g}: "
                                     f"{tuple(got.shape)}, err {err}")
            errs.append(f"{k} T{t} F{f} G{g} {err:.3g}")
    for t, k, g in ((128, 512, 64), (63, 1024, 64), (63, 520, 64),
                    (63, 512, 80)):
        hop = (SR - 1) // (t - 1)
        frames = spectral.frame_signal(
            torch.nn.functional.pad(y, (k // 2, k // 2)), k, hop,
            t).contiguous()
        basis = spectral.device_const(spectral.framedft_basis, k,
                                      device=y.device)
        fb = spectral.device_const(spectral.mel_matrix, SR, k, g,
                                   device=y.device)
        got = gk.fused_gammatone(frames, basis, fb)
        err = float((got - gk.fused_gammatone_plain(frames, basis, fb)
                     ).abs().max())
        if not (got.shape == (MICRO, g, t) and err <= TOLS["B''"]):
            raise AssertionError(f"kernel B'' at T {t}, K {k}, G {g}: "
                                 f"{tuple(got.shape)}, err {err}")
        errs.append(f"B'' T{t} K{k} G{g} {err:.3g}")
    # B'' at B = 65,537: three clips' rows equal their rows alone
    yp = torch.nn.functional.pad(y[:3], (256, 256))
    frames = spectral.frame_signal(yp, 512, 256, 63).contiguous()
    basis = spectral.device_const(spectral.framedft_basis, 512,
                                  device=y.device)
    fb = spectral.device_const(spectral.mel_matrix, SR, 512, 64,
                               device=y.device)
    rows = [0, 40_000, 65_536]
    big = torch.zeros(65_537, 63, 512, device="cuda")
    big[rows] = frames
    got = gk.fused_gammatone(big, basis, fb)[rows]
    del big
    torch.cuda.empty_cache()
    if not torch.equal(got, gk.fused_gammatone(frames, basis, fb)):
        raise AssertionError("kernel B'' at B = 65,537: rows differ from "
                             "the clips alone")
    # A on 4 s clips: piptrack pairs of |STFT_2048| past shared memory
    y4 = y.reshape(2, 4 * SR)
    s2048 = spectral.stft_mag_cr(y4, 2048, 256)[..., ::2]
    p, m = (v.contiguous() for v in chroma._piptrack_band(s2048, SR, 2048))
    n = p[0].numel()
    got, ref = (fn(p, m, 36) for fn in (tk.estimate_tuning_index,
                                        tk.estimate_tuning_index_plain))
    if not (n > tk.SMEM_PAIRS and torch.equal(got, ref)):
        raise AssertionError(f"kernel A at {n} pairs: {got.tolist()} != "
                             f"{ref.tolist()}")
    # D on rows of 100,000 samples
    y100 = torch.cat([y.reshape(1, -1)[:, :100_000]] * 2) * torch.tensor(
        [[1.0], [0.1]], device="cuda")
    got = ck.cqt_mag(y100.contiguous(), *cqt_args())
    ref = ck.cqt_mag_plain(y100, *cqt_args())
    rel = float((got - ref).abs().max() / ref.abs().max())
    if not (ck.staged_len(100_000, 256) * 4 > ck.SMEM_LIMIT
            and rel < TOL_D):
        raise AssertionError(f"kernel D at 100,000 samples: rel err {rel}")
    log(f"[kernels] past the main path's tiles: {'; '.join(errs)} (max abs "
        f"err; tolerances {TOLS}); B'' at B = 65,537 rows bit-equal to the "
        f"clips alone; A exact at {n} pairs a clip (bpo 36, 4 s clips); D "
        f"at 100,000 samples max|a-b|/max|b| {rel:.3g} (tol {TOL_D:g})")


def check_long_rows(n: int) -> None:
    """Kernel C on rows past its shared-memory list (the wrapper then keeps
    it in device memory): B = 8 envelopes of seeded noise, half of them
    quantized, distance sr // 10; vals and kept equal the plain version,
    the survivor counts scipy's."""
    import scipy.signal
    from tpu_breath_torch.ops import peaks
    from tpu_breath_torch.ops.cuda import peaks_kernel as pk

    rng = np.random.default_rng(n)
    env = np.abs(scipy.signal.hilbert(rng.standard_normal((MICRO, n)))
                 ).astype(np.float32)
    env[1::2] = np.round(env[1::2] * 64) / 64
    h = env.mean(axis=-1, keepdims=True)
    e = torch.from_numpy(env).cuda()
    scores = torch.where(peaks.local_maxima(e)
                         & (e >= torch.from_numpy(h).cuda()), e,
                         -torch.inf).contiguous()
    d = SR // 10
    vals, kept = pk.suppress_peaks(scores, d, n // d + 2)
    rvals, rkept = pk.suppress_peaks_plain(scores, d, n // d + 2)
    if not (n > pk.SMEM_SAMPLES and torch.equal(kept, rkept)
            and torch.equal(vals, rvals)):
        raise AssertionError(f"kernel C at n = {n}: differs from its plain "
                             "version")
    for i in range(MICRO):
        found, _ = scipy.signal.find_peaks(env[i], height=float(h[i, 0]),
                                           distance=d)
        if int(kept[i].sum()) != len(found):
            raise AssertionError(f"kernel C at n = {n}, clip {i}: "
                                 f"{int(kept[i].sum())} != {len(found)}")
    log(f"[kernels] C on {MICRO} rows of {n} samples (list in device "
        f"memory): equal to its plain version, {int(kept.sum())} kept "
        "(= scipy's counts)")


def cqt_conv1d(y: torch.Tensor):
    """The one PyTorch call nearest kernel D: conv1d of the padded clips
    with the bank's 252 (re, im) rows at stride hop, in f32 with TF32 off;
    it leaves out the magnitude, a [B, 252, 63] elementwise step. Returns
    the call, for timing."""
    from tpu_breath_torch.ops import spectral
    from tpu_breath_torch.ops.cuda import cqt_kernel as ck

    sr, hop, fmin, n_bins, bpo = cqt_args()
    k_re, k_im, half, l_pad = ck._kernel_bank(sr, fmin, n_bins, bpo)
    w = torch.from_numpy(np.concatenate([k_re, k_im]))[:, None].cuda()
    n = y.shape[-1]
    ypad = torch.nn.functional.pad(
        y, (half, hop * (n // hop) + l_pad - n - half))[:, None]

    def call():
        with spectral.full_f32():
            return torch.nn.functional.conv1d(ypad, w, stride=hop)
    if call().shape != (y.shape[0], 2 * n_bins, 1 + n // hop):
        raise AssertionError(f"conv1d shape {tuple(call().shape)}")
    return call


def phase_features() -> None:
    from tpu_breath_torch.features import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.features import extract_features

    gold = golden()
    w = torch.from_numpy(np.stack([d["wav"] for d in gold]))
    f, s = (t.cpu().numpy() for t in extract_features(w.cuda()))
    fc, sc = (t.numpy() for t in extract_features(w))
    worst_gold = worst_rel = 0.0
    for i, d in enumerate(gold):
        stack = np.stack([d[k] for k in SPEC.channel_order])
        worst_gold = max(worst_gold, float(np.nanmax(np.abs(f[i] - stack))))
        rel = np.abs(s[i] - d["scalars"]) / np.maximum(np.abs(d["scalars"]),
                                                       1e-2)
        worst_rel = max(worst_rel, float(rel.max()))
    if not (worst_gold < 2e-3 and worst_rel < 2e-2):
        raise AssertionError(f"features vs golden: {worst_gold} abs, "
                             f"{worst_rel} rel scalars")
    d_cpu = float(np.nanmax(np.abs(f - fc)))
    s_cpu = float(np.max(np.abs(s - sc) / np.maximum(np.abs(sc), 1e-2)))
    if not (np.array_equal(np.isnan(f), np.isnan(fc)) and d_cpu < 1e-4
            and s_cpu < 1e-3):
        raise AssertionError(f"features gpu vs cpu: {d_cpu} abs, {s_cpu} rel")
    log(f"[features] golden: max abs {worst_gold:.3g} (bound 2e-3), scalars "
        f"rel {worst_rel:.3g} (bound 2e-2); gpu vs cpu: {d_cpu:.3g} abs "
        f"(bound 1e-4), scalars rel {s_cpu:.3g} (bound 1e-3)")

    # kernel B'' in the graph against the default path (kernel B): the
    # gammatone channel within 2e-4 (test_pallas_epilogue.py:108-111), every
    # other channel and the scalars equal
    y = torch.from_numpy(clip_set(CHUNK, seed=5)).cuda()
    f0, s0 = extract_features(y, fused_gt=False)
    f1, s1 = extract_features(y, fused_gt=True)
    gi = SPEC.channel_order.index("gammatone")
    others = [c for c in range(f0.shape[1]) if c != gi]
    gt_err = float((f0[:, gi] - f1[:, gi]).abs().max())
    same = (_nan_equal(f0[:, others], f1[:, others])
            and _nan_equal(s0, s1))
    if not (gt_err <= 2e-4 and same):
        raise AssertionError(f"fused_gt features: gammatone err {gt_err}, "
                             f"other channels and scalars equal: {same}")
    log(f"[features] fused_gt (B'') vs default (B), B={CHUNK}: gammatone "
        f"max abs {gt_err:.3g} (bound 2e-4); other channels and scalars "
        f"equal")


def _clone(out):
    return tuple(t.clone() for t in out)


def phase_graphs(smi: str) -> dict:
    """The captured graphs (graphs.py) against the eager path:
    (a) extract_features_compiled's replays against extract_features, bit
    for bit (NaN where NaN), at B = 1, 8 and 128 with fused_gt off and on,
    on two inputs replayed in turn (golden wavs, silence, an impulse,
    plateaus and seeded noise); each replay adds the graph's launches to
    the counters; (b) a Server of CNN8 + VGG (seeded weights) against the
    eager composition (extract_features -> ensemble.blend) at micro-batches
    of 1 and 8, with a tail: probabilities bit-equal; (c) eager and graphed
    in turns (eager, graph, graph, eager): serve at B = 1 and 8 (host
    clock, 40 calls each), extract_features_batched over 2,048 seeded
    clips in chunks of 128 (clips/s, 5 runs each), the fused step's
    features at batch 512 (CUDA events, 2 rounds of 8 launches each), and
    the profiler's device-busy share of one serve call (B = 8);
    then each graph's capture time and pool. (The train and eval steps'
    graphs: phase_steps.) Prints {"graphs": ...}."""
    from tpu_breath_torch import ensemble, features

    t0 = time.perf_counter()
    res: dict = {"a": [], "pools": []}
    gold = np.stack([d["wav"] for d in golden()])
    for b in (1, MICRO, CHUNK):
        inputs = ([gold[:1], gold[1:2]] if b == 1 else
                  [clip_set(b, seed=b), clip_set(b, seed=b + 1)])
        ys = [torch.from_numpy(x).cuda() for x in inputs]
        for fused_gt in (False, True):
            eager = [_clone(features.extract_features(y, fused_gt=fused_gt))
                     for y in ys]
            replays = [_clone(features.extract_features_compiled(
                y, fused_gt=fused_gt)) for y in (*ys, ys[0])]
            graph = features._GRAPHS[(ys[0].device, tuple(ys[0].shape),
                                      features.DEFAULT_FEATURES, fused_gt)]
            k0 = read_launches()
            for _ in range(5):
                features.extract_features_compiled(ys[1], fused_gt=fused_gt)
            counted = {k: n - k0[k] for k, n in read_launches().items()}
            same = [all(_nan_equal(g, e) for g, e in zip(got, ref))
                    for got, ref in zip(replays, (*eager, eager[0]))]
            row = {"B": b, "fused_gt": fused_gt, "bit_equal": same,
                   "launches_a_replay": graph.launches,
                   "five_replays": counted}
            res["a"].append(row)
            log(f"[graphs] (a) B={b} fused_gt={fused_gt}: replays of two "
                f"inputs in turn bit-equal to eager {same}; launches a "
                f"replay {graph.launches}, 5 replays {counted}")
            if not all(same):
                raise AssertionError(f"graph differs from eager: {row}")
            if counted != {k: 5 * n for k, n in graph.launches.items()}:
                raise AssertionError(f"replay launches: {row}")

    from tpu_breath_torch.models import registry
    models = [registry.build(a, 36, seed=0).cuda().eval()
              for a in ("cnn8", "vgg")]
    weights = ensemble.softmax_weights([0.79, 0.80])
    server = ensemble.Server(models, weights, device="cuda")

    def eager_serve(w: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            y = torch.from_numpy(w).cuda()
            return ensemble.blend(models, weights,
                                  *features.extract_features(y)).cpu().numpy()

    for b in (1, MICRO):
        w = clips(2 * b + 1, seed=7)
        got = server(w, micro_batch=b)
        wp = np.concatenate([w, np.zeros((b - 1, w.shape[1]), np.float32)])
        ref = np.concatenate([eager_serve(wp[lo:lo + b])
                              for lo in range(0, len(w), b)])[:len(w)]
        same = bool(np.array_equal(got.astype(np.float32), ref))
        log(f"[graphs] (b) serve CNN8 + VGG, micro-batch {b}, {len(w)} clips "
            f"(a tail of 1): graph == eager {same}; probs "
            f"{np.round(got, 4).tolist()}")
        if not (same and np.all(np.isfinite(got))):
            raise AssertionError(f"serve graph differs: {got} vs {ref}")
    res["b"] = True

    # (c) eager and graphed in turns
    order = (False, True, True, False)
    serve = {}
    for b in (1, MICRO):
        w = clips(b, seed=1)
        runs = {False: [], True: []}
        for graphed in order:
            fn = ((lambda: server(w, micro_batch=b)) if graphed
                  else (lambda: eager_serve(w)))
            runs[graphed] += host_ms(fn, 20, 5)
        serve[b] = {mode: {"median": float(np.median(v)),
                           "p90": float(np.percentile(v, 90)),
                           "calls": len(v)}
                    for mode, v in (("eager", runs[False]),
                                    ("graph", runs[True]))}
        log(f"[graphs] (c) serve CNN8 + VGG, B={b}, host clock, "
            f"{len(runs[True])} calls each in turns: eager median "
            f"{serve[b]['eager']['median']:.3f} ms p90 "
            f"{serve[b]['eager']['p90']:.3f}; graph median "
            f"{serve[b]['graph']['median']:.3f} ms p90 "
            f"{serve[b]['graph']['p90']:.3f}; {smi}")
    res["serve_ms"] = serve

    wavs = clips(2048)

    def eager_batched():
        for lo in range(0, len(wavs), CHUNK):
            f, s = features.extract_features(
                torch.from_numpy(wavs[lo:lo + CHUNK]).cuda())
            f.cpu(), s.cpu()

    rates = {False: [], True: []}
    for graphed in (False, True, True, False, False, True, True, False,
                    False, True):
        fn = ((lambda: features.extract_features_batched(wavs, chunk=CHUNK))
              if graphed else eager_batched)
        ms = host_ms(fn, 1, 1 if not rates[graphed] else 0)[0]
        rates[graphed].append(len(wavs) / ms * 1e3)
    res["features_clips_per_s"] = {
        mode: {"median": float(np.median(v)), "runs": v}
        for mode, v in (("eager", rates[False]), ("graph", rates[True]))}
    log(f"[graphs] (c) 2,048 clips in chunks of {CHUNK}, wavs on the host "
        f"-> features on the host, 5 runs each in turns: eager "
        f"{np.median(rates[False]):.1f} clips/s, graph (extract_features_"
        f"batched) {np.median(rates[True]):.1f} clips/s; {smi}")

    res["split"] = _graph_split(wavs)
    res["busy"] = _busy_shares(server, eager_serve)
    for key, g in features._GRAPHS.items():
        res["pools"].append({"graph": f"features B={key[1][0]} "
                                      f"fused_gt={key[3]}",
                             "capture_s": g.capture_s,
                             "pool_bytes": g.pool_bytes})
    for key, g in server.graphs.items():
        res["pools"].append({"graph": f"serve CNN8+VGG B={key[0]} "
                                      f"fused_gt={key[1]}",
                             "capture_s": g.capture_s,
                             "pool_bytes": g.pool_bytes})
    for row in res["pools"]:
        log(f"[graphs] {row['graph']}: capture (warm call included) "
            f"{row['capture_s']:.3f} s, pool {row['pool_bytes'] / 2**20:.1f}"
            f" MiB")
    res["seconds"] = time.perf_counter() - t0
    log(f"[graphs] phase {res['seconds']:.1f} s")
    print(json.dumps({"graphs": res}, default=str), flush=True)
    return res


def _graph_split(wavs: np.ndarray) -> dict:
    """The fused step's features at batch 512 (extract_features_compiled
    over its 4 chunks of 128), eager (graphs.eager()) and graphed in
    turns: ms a launch by CUDA events, 2 rounds of 8 launches each way."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.features import extract_features_compiled

    w = torch.from_numpy(wavs[:STEP_BATCH]).cuda()

    def features():
        for lo in range(0, STEP_BATCH, CHUNK):
            extract_features_compiled(w[lo:lo + CHUNK])

    ms = {False: [], True: []}
    for graphed in (False, True, True, False):
        with contextlib.nullcontext() if graphed else graphs.eager():
            ms[graphed] += device_ms(features, "cuda", STEPS, warmup=1)
    out = {"features": {mode: float(np.median(ms[g]))
                        for mode, g in (("eager", False), ("graph", True))}}
    log(f"[graphs] (c) features of a batch of 512 (4 chunks of 128), ms a "
        f"launch (CUDA events, 2 rounds of 8 each way, in turns): eager "
        f"{out['features']['eager']:.2f} / graph "
        f"{out['features']['graph']:.2f}")
    return out


def _busy(fn, with_host: bool = False) -> dict:
    """One call of fn under torch.profiler after two warm calls: its
    device kernels' time (overlaps merged), their count, the span from the
    first kernel's start to the last one's end, the host clock's wall time
    of the call (synchronized) and the busy shares of the span and of the
    wall time. with_host: also the launches the host made (CUDA API calls
    that launch a kernel or a graph), its copies, and the
    kernels inside a `train_step` range's device span."""
    from torch.profiler import ProfilerActivity, profile

    fn(), fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ks = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == "kernel")
    busy, end = 0.0, -np.inf
    for a, b in ks:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = (ks[-1][1] - ks[0][0]) if ks else 0.0
    out = {"kernels": len(ks), "device_ms": busy / 1e3,
           "span_ms": span / 1e3, "wall_ms": wall_us / 1e3,
           "busy_of_span": busy / span if span else None,
           "busy_of_wall": busy / wall_us}
    if with_host:
        api = [e["name"] for e in events
               if e.get("cat", "").startswith("cuda_")]
        ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "gpu_user_annotation"
                  and e.get("name") == "train_step"]
        out.update({
            "host_api": sorted(set(api)),
            "host_launches": sum("Launch" in n for n in api),
            "host_copies": sum("Memcpy" in n or "Memset" in n for n in api),
            "in_range": sum(any(r0 <= a and b <= r1 for r0, r1 in ranges)
                            for a, b in ks)})
    return out


def _busy_shares(server, eager_serve) -> dict:
    """_busy of one serve call (CNN8 + VGG, B = 8), eager and graphed."""
    w = clips(MICRO, seed=1)
    out = {"serve_eager": _busy(lambda: eager_serve(w)),
           "serve_graph": _busy(lambda: server(w, micro_batch=MICRO))}
    for name, r in out.items():
        log(f"[graphs] (c) busy {name}: {r['device_ms']:.3f} ms of device "
            f"time in {r['kernels']} kernels, span {r['span_ms']:.3f} ms "
            f"(busy {r['busy_of_span'] or 0:.1%}), wall {r['wall_ms']:.3f} "
            f"ms (busy {r['busy_of_wall']:.1%})")
    return out


STEP_KEYS = ("cnn8", "vgg")


def _state(model, opt) -> dict:
    """Every parameter and buffer, both moments and the step count."""
    out = {f"model.{k}": v for k, v in model.state_dict().items()}
    for i, p in enumerate(model.parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"opt.{i}.{k}"] = opt.state[p][k]
    out["opt.count"] = opt.count
    return out


def _programs(arch: str, fused: bool, data: dict):
    """Two step programs (loop.TrainStep) of `arch` at batch 512 from one
    seeded state: each its own model (seed 0), optimizer and augmentation
    generator (seed 1), on the cached features or the wavs of data."""
    from tpu_breath_torch.config import CNN8_TRAIN, DEFAULT_FEATURES, VGG_TRAIN
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    cfg = dataclasses.replace({"cnn8": CNN8_TRAIN, "vgg": VGG_TRAIN}[arch],
                              batch_size=STEP_BATCH)
    out = []
    for _ in range(2):
        model = registry.build(arch, 36, seed=0).cuda()
        opt = loop.make_optimizer(model, cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        train = ((data["wavs"], data["labels"]) if fused
                 else (data["feats"], data["scals"], data["labels"]))
        out.append((model, opt, loop.TrainStep(
            model, opt, train, cfg, gen, DEFAULT_FEATURES if fused else None)))
    return out


def _drive(step, data: dict, steps: int) -> tuple[list, list]:
    """steps calls of step on data's rows and rates, augmentation on, the
    dropout generator seeded first; (losses, accuracies) as floats."""
    torch.manual_seed(2)
    losses, accs = [], []
    for s in range(steps):
        loss, acc = step(data["rows"][s], data["lrs"][s], data["on"])
        losses.append(loss.clone())
        accs.append(acc.clone())
    return torch.stack(losses).tolist(), torch.stack(accs).tolist()


def _queue_ms(fn, n: int = 8) -> list[float]:
    """Host ms to queue one call of fn (no wait inside), n calls, each
    after a synchronize."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return out


def _traced(fn) -> dict:
    """_busy of one call of fn inside record_function("train_step"), plus
    the launches the host made (CUDA API calls that launch,
    graph launches included) and the kernels inside the range's device
    span (all of them must be: a replay's kernels belong to its range)."""
    from torch.profiler import record_function

    def call():
        with record_function("train_step"):
            fn()

    return _busy(call, with_host=True)


def phase_steps(smi: str) -> dict:
    """fit's step and evaluation programs (loop.TrainStep, loop.Predictor)
    graphed against eager, at batch 512 on seeded clips (clips(1024),
    labels alternating, cached features from extract_features_batched),
    TPU_BREATH_PALLAS_GT unset (kernel B):
    (i) for CNN8 and VGG, cached and fused, two programs from one seeded
    state run 8 steps each, augmentation on, one eager (graphs.eager()) and
    one graphed: losses, accuracies, every parameter and buffer, both
    moments and the step count bit-equal; the fused graph holds A 8, B 4,
    C 4 (4 chunks of 128); (ii) eager and graphed in turns (eager, graph,
    graph, eager): ms a step by CUDA events (8 steps a turn), the host's
    ms to queue one step, the profiler's record of one step (kernels on
    the device, launches made by the host, busy share of the span; every
    kernel of a replay inside its train_step range), an evaluation
    (loop.evaluate) of a validation split of phase 6's size (256 rows,
    eval batch 1,024, the tail padded) on the host clock, and each graph's
    capture seconds and pool bytes. Prints {"steps": ...}; returns the
    phase's launches."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.features import extract_features_batched
    from tpu_breath_torch.train import loop
    from tpu_breath_torch.train.schedule import warmup_cosine

    t0 = time.perf_counter()
    reset_launches()
    wavs = clips(2 * STEP_BATCH)
    f, s = extract_features_batched(wavs, chunk=CHUNK)
    rng = np.random.default_rng(0)
    lr = warmup_cosine(1e-3, 100)
    data = {"wavs": torch.from_numpy(wavs).cuda(),
            "feats": torch.from_numpy(f).cuda(),
            "scals": torch.from_numpy(s).cuda(),
            "labels": torch.from_numpy(np.tile(np.float32([0.0, 1.0]),
                                               STEP_BATCH)).cuda(),
            "rows": torch.from_numpy(np.stack(
                [rng.permutation(2 * STEP_BATCH)[:STEP_BATCH]
                 for _ in range(3 * STEPS)])).cuda(),
            "lrs": torch.tensor([lr(k) for k in range(3 * STEPS)],
                                dtype=torch.float32).cuda(),
            "on": torch.ones((), dtype=torch.bool).cuda()}
    res: dict = {"device": smi, "batch": STEP_BATCH, "steps": STEPS,
                 "i": {}, "ms": {}, "queue_ms": {}, "trace": {},
                 "pools": []}
    failed = []
    with loop.reproducible():
        for arch in STEP_KEYS:
            for mode in ("cached", "fused"):
                name = f"{arch} {mode}"
                (me, oe, se), (mg, og, sg) = _programs(arch, mode == "fused",
                                                       data)
                # (i) one program, eager and graphed, from one state
                with graphs.eager():
                    le, ae = _drive(se, data, STEPS)
                lg, ag = _drive(sg, data, STEPS)
                a, b = _state(me, oe), _state(mg, og)
                diff = {k: float((a[k].double() - b[k].double()).abs().max())
                        for k in a if not torch.equal(a[k], b[k])}
                graph = next(iter(sg.graphs.values()))
                row = {"losses_equal": le == lg, "accs_equal": ae == ag,
                       "tensors": len(a), "unequal": diff,
                       "launches_a_replay": graph.launches,
                       "losses": lg}
                res["i"][name] = row
                log(f"[steps] (i) {name}, {STEPS} steps eager vs graphed: "
                    f"losses equal {row['losses_equal']}, accuracies equal "
                    f"{row['accs_equal']}, {len(a) - len(diff)} of {len(a)} "
                    f"tensors (parameters, buffers, moments, count) "
                    f"bit-equal{'' if not diff else f'; max |diff| {diff}'};"
                    f" graph launches a replay {graph.launches}")
                want = ({"A": 8, "B": 4, "C": 4, "E": 4} if mode == "fused"
                        else {})
                if not (row["losses_equal"] and row["accs_equal"]
                        and not diff) or {k: v for k, v in
                                          graph.launches.items() if v} != want:
                    failed.append(name)
                # (ii) eager and graphed in turns, on the programs above
                ms = {False: [], True: []}
                queue = {False: [], True: []}
                for graphed in (False, True, True, False):
                    step = sg if graphed else se
                    k = {"n": 0}

                    def call():
                        step(data["rows"][STEPS + k["n"] % STEPS],
                             data["lrs"][STEPS + k["n"] % STEPS], data["on"])
                        k["n"] += 1
                    with (contextlib.nullcontext() if graphed
                          else graphs.eager()):
                        ms[graphed] += device_ms(call, "cuda", STEPS,
                                                 warmup=1)
                        queue[graphed] += _queue_ms(call, 4)
                with graphs.eager():
                    trace_e = _traced(lambda: se(data["rows"][0],
                                                 data["lrs"][0], data["on"]))
                trace_g = _traced(lambda: sg(data["rows"][0], data["lrs"][0],
                                             data["on"]))
                res["ms"][name] = {m: {"median": float(np.median(ms[g])),
                                       "runs": ms[g]}
                                   for m, g in (("eager", False),
                                                ("graph", True))}
                res["queue_ms"][name] = {
                    m: float(np.median(queue[g]))
                    for m, g in (("eager", False), ("graph", True))}
                res["trace"][name] = {"eager": trace_e, "graph": trace_g}
                res["pools"].append({"graph": f"step {name}",
                                     "capture_s": graph.capture_s,
                                     "pool_bytes": graph.pool_bytes})
                log(f"[steps] (ii) {name}, ms a step (CUDA events, "
                    f"{STEPS} steps a turn, in turns): eager "
                    f"{res['ms'][name]['eager']['median']:.2f} / graph "
                    f"{res['ms'][name]['graph']['median']:.2f}; host ms to "
                    f"queue a step: eager "
                    f"{res['queue_ms'][name]['eager']:.3f} / graph "
                    f"{res['queue_ms'][name]['graph']:.3f}; one step traced: "
                    f"eager {trace_e['host_launches']} host launches, "
                    f"{trace_e['kernels']} kernels, busy "
                    f"{trace_e['busy_of_span'] or 0:.1%} of "
                    f"{trace_e['span_ms']:.2f} ms; graph "
                    f"{trace_g['host_launches']} host launches, "
                    f"{trace_g['kernels']} kernels ({trace_g['in_range']} in "
                    f"its train_step range), busy "
                    f"{trace_g['busy_of_span'] or 0:.1%} of "
                    f"{trace_g['span_ms']:.2f} ms; capture (warm step "
                    f"included) {graph.capture_s:.2f} s, pool "
                    f"{graph.pool_bytes / 2**20:.0f} MiB; {smi}")
                if trace_g["in_range"] != trace_g["kernels"]:
                    failed.append(f"{name}: replay kernels outside the range")
                if mode == "cached":
                    res["eval"] = res.get("eval", {})
                    res["eval"][arch] = _eval_times(mg, data, res["pools"])
                del me, oe, se, mg, og, sg, graph
                torch.cuda.empty_cache()
    res["launches"] = read_launches()
    res["seconds"] = time.perf_counter() - t0
    log(f"[steps] launches {res['launches']}; phase {res['seconds']:.1f} s")
    print(json.dumps({"steps": res}), flush=True)
    if failed:
        raise AssertionError(f"steps: graphed differs from eager: {failed}")
    return res


def _eval_times(model, data: dict, pools: list) -> dict:
    """loop.evaluate of 256 rows (phase 6's validation split's size) at
    eval batch 1,024 (one padded batch), eager and graphed in turns, host
    clock including its one wait, 5 calls a turn; the logits bit-equal."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.train import loop

    n = 256
    y = (np.arange(n) % 2).astype(np.float32)
    predict = loop.Predictor(model, data["feats"][:n], data["scals"][:n],
                             1024)
    def logits():
        out = predict()
        torch.cuda.synchronize()
        return out.clone()

    with graphs.eager():
        eager = logits()
    graphed = logits()
    same = bool(torch.equal(eager, graphed))
    times = {False: [], True: []}
    for g in (False, True, True, False):
        with contextlib.nullcontext() if g else graphs.eager():
            times[g] += host_ms(lambda: loop.evaluate(predict, y), 5, 1)
    graph = next(iter(predict.graphs.values()))
    pools.append({"graph": f"eval {type(model).__name__} B=1024",
                  "capture_s": graph.capture_s,
                  "pool_bytes": graph.pool_bytes})
    out = {"logits_bit_equal": same,
           "eager_ms": float(np.median(times[False])),
           "graph_ms": float(np.median(times[True]))}
    log(f"[steps] (ii) evaluate {type(model).__name__}, {n} rows in one "
        f"padded batch of 1,024 (host clock, one wait, in turns): eager "
        f"{out['eager_ms']:.2f} ms, graph {out['graph_ms']:.2f} ms; logits "
        f"bit-equal {same}; capture {graph.capture_s:.2f} s, pool "
        f"{graph.pool_bytes / 2**20:.0f} MiB")
    if not same:
        raise AssertionError("the eval graph's logits differ from eager")
    return out



@contextlib.contextmanager
def lpc_loop():
    """Inside the block lpc_kernel.lpc_frames is its plain version, the
    float64 loop the feature graph ran before kernel E, on every device."""
    from tpu_breath_torch.ops.cuda import lpc_kernel

    saved = lpc_kernel.lpc_frames
    lpc_kernel.lpc_frames = lpc_kernel.lpc_frames_plain
    try:
        yield
    finally:
        lpc_kernel.lpc_frames = saved


def phase_parity(smi: str) -> dict:
    """The parity sweep on the card against the port's oracle, kernel B
    and kernel B'' (see the module docstring), and the lpc channel's worst
    error before and after kernel E: the kernel B sweep run eagerly with
    the plain float64 loop in kernel E's place, against its own oracle run
    of the same clips. Returns the phase's launches and the two errors."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.utils import parity_sweep

    wavs, ids, synthetic = parity_sweep.seeded_clips(512, seed=0)
    with graphs.eager(), lpc_loop():
        loop_rep = parity_sweep.sweeps(wavs, ids, 128, seed=0,
                                       device="cuda", synthetic=synthetic)[0]
    reset_launches()
    t0 = time.perf_counter()
    reports = parity_sweep.sweeps(wavs, ids, 128, seed=0, device="cuda",
                                  fused_gts=(False, True),
                                  synthetic=synthetic)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    misses = {}
    for rep in reports:
        kernel = "B''" if rep["fused_gt"] else "B"

        def worst(key):
            return {k: None if v is None else v["max"]
                    for k, v in rep[key].items()}
        log(f"[parity] {kernel}: {rep['n_total']} clips, "
            f"{rep['n_oracle_sampled']} through the oracle "
            f"({rep['n_oracle_synthetic']} synthetic); real clips with no "
            f"flip: max abs by channel "
            f"{worst('channel_max_abs_err_unflipped')} (bound 2.3e-4), "
            f"scalars {rep['scalar_max_rel_err_unflipped']} (max rel, "
            f"bound 6.9e-4); synthetic: max abs "
            f"{worst('channel_max_abs_err_synthetic')}, scalars "
            f"{rep['scalar_max_rel_err_synthetic']}; flips "
            f"{rep['tuning_flips']}; NaN-mask mismatches "
            f"{rep['nan_mask_mismatches']}; oracle "
            f"{rep['oracle_clips_per_s']:.3f} clips/s a process "
            f"({rep['oracle_workers']} processes, {rep['oracle_wall_s']:.2f} "
            f"s wall); {smi}")
        log(f"[parity] {kernel} report {json.dumps(rep)}")
        misses[kernel] = parity_sweep.envelope_misses(rep)
    log(f"[parity] sweep {seconds:.2f} s; launches {launches}")
    lpc_err = {when: {group: rep[key]["lpc"]["max"] for group, key in (
        ("real_unflipped", "channel_max_abs_err_unflipped"),
        ("all", "channel_max_abs_err"))}
        for when, rep in (("loop", loop_rep), ("kernel", reports[0]))}
    log(f"[parity] lpc channel, max abs against the oracle: the float64 "
        f"loop {lpc_err['loop']}, kernel E {lpc_err['kernel']} (real clips "
        f"with no flip: bound {parity_sweep.ENVELOPE_ABS}); {smi}")
    if any(misses.values()):
        raise AssertionError(f"parity sweep misses the envelope: {misses}")
    if min(launches[k] for k in ("A", "B", "B''", "C", "E")) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return {"launches": launches, "lpc_err": lpc_err}


def _nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def write_wav(path: str, samples: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())


def read_wav(path: str) -> np.ndarray:
    with wave.open(path) as w:
        data = w.readframes(w.getnframes())
    return np.frombuffer(data, "<i2").astype(np.float32) / 32768.0


def phase_serve(tmp: str) -> dict:
    from tpu_breath_torch import cli, ensemble
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import checkpoint as ckpt_lib

    model = registry.build("cnn8", 36, seed=0)
    ckpt = ckpt_lib.save(cli.ckpt_dir(tmp, "cnn8"), model, 1,
                         {"val_acc": 0.78})
    # golden wavs + seeded noise: silence gives faithful NaN features (a
    # constant CENS row z-scores to 0/0), so it stays out of the served set
    clips = np.concatenate([clip_set(2, seed=3),
                            clip_set(13, seed=3)[5:]])
    paths = []
    for i, c in enumerate(clips):
        paths.append(os.path.join(tmp, f"clip{i}.wav"))
        write_wav(paths[-1], c)
    argv = ["predict", "--from-wav", *paths, "--archs", "cnn8",
            "--out-root", tmp, "--device", "cuda"]
    reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"[serve] predict --from-wav ({len(paths)} clips) in {serve_s:.2f} s "
        f"(first call, includes model load); launches {launches}")
    if min(launches[k] for k in ("A", "B", "C", "E")) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    lines = [l.split("\t") for l in out.getvalue().splitlines() if "\t" in l]
    probs = np.array([float(p) for _, _, p in lines])
    with open(os.path.join(tmp, "submissions", "from_wav_predictions.csv")) as f:
        header = f.readline().strip()
    if header != "ID,Target" or len(probs) != len(paths):
        raise AssertionError(f"bad predictions: {header!r}, {len(probs)}")
    wavs = np.stack([read_wav(p) for p in paths])
    p_gpu = ensemble.serve_from_wav([ckpt], ["cnn8"], [0.78], wavs,
                                    device="cuda")
    p_cpu = ensemble.serve_from_wav([ckpt], ["cnn8"], [0.78], wavs,
                                    device="cpu")
    gap = float(np.max(np.abs(p_gpu - p_cpu)))
    if not (np.all(np.isfinite(p_gpu)) and np.all((p_gpu >= 0) & (p_gpu <= 1))
            and gap <= 2e-2 and np.max(np.abs(probs - p_gpu)) <= 1e-4):
        raise AssertionError(f"serve probabilities: gpu {p_gpu}, cpu {p_cpu}")
    # bound: the card runs CNN8 under bf16 autocast, the CPU in f32
    log(f"[serve] probs {np.round(p_gpu, 4).tolist()}; |gpu (bf16) - cpu "
        f"(f32)| max {gap:.3g} (bound 2e-2)")
    return {"launches": launches}


@dataclasses.dataclass(frozen=True)
class WavCase:
    """A seeded wav of the decode phase: rate, channels, format code (1 PCM,
    3 IEEE float), bits, frames, a WAVE_FORMAT_EXTENSIBLE fmt chunk, a
    LIST chunk of odd size before the data."""
    rate: int
    channels: int
    fmt: int
    bits: int
    frames: int
    extensible: bool = False
    list_chunk: bool = False


DECODE_CASES = {
    "pcm8": WavCase(16000, 1, 1, 8, 16000),
    "pcm16_short": WavCase(16000, 1, 1, 16, 4000),
    "pcm16_long_list": WavCase(16000, 1, 1, 16, 24000, list_chunk=True),
    "pcm24_stereo": WavCase(16000, 2, 1, 24, 16000),
    "pcm32_3ch": WavCase(16000, 3, 1, 32, 16000),
    "f32_stereo": WavCase(16000, 2, 3, 32, 16000),
    "f64": WavCase(16000, 1, 3, 64, 16000),
    "ext_pcm16_stereo": WavCase(16000, 2, 1, 16, 16000, extensible=True),
    "pcm16_8k": WavCase(8000, 1, 1, 16, 8000),
    "f64_8k_long": WavCase(8000, 1, 3, 64, 12000),
    "pcm16_22k_stereo": WavCase(22050, 2, 1, 16, 22050),
    "f32_44k_list": WavCase(44100, 1, 3, 32, 44100, list_chunk=True),
    "ext_f32_44k_stereo": WavCase(44100, 2, 3, 32, 44100, extensible=True),
    "pcm24_48k_3ch": WavCase(48000, 3, 1, 24, 48000),
    "pcm16_48k_short": WavCase(48000, 1, 1, 16, 12000),
}


def write_case(path: str, case: WavCase, seed: int) -> None:
    """Seeded noise in [-0.9, 0.9] as a RIFF/WAVE file of this case."""
    x = np.random.default_rng(seed).uniform(-0.9, 0.9,
                                            (case.frames, case.channels))
    if case.fmt == 3:
        raw = x.astype("<f4" if case.bits == 32 else "<f8").tobytes()
    elif case.bits == 8:  # unsigned
        raw = (np.round(x * 127) + 128).astype(np.uint8).tobytes()
    elif case.bits == 24:
        v = np.round(x * (2 ** 23 - 1)).astype("<i4")
        raw = v.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    else:
        raw = np.round(x * (2.0 ** (case.bits - 1) - 1)).astype(
            f"<i{case.bits // 8}").tobytes()
    block = case.channels * case.bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if case.extensible else case.fmt,
                      case.channels, case.rate, case.rate * block, block,
                      case.bits)
    if case.extensible:  # cbSize, valid bits, channel mask, SubFormat GUID
        fmt += struct.pack("<HHIH", 22, case.bits, 0, case.fmt) + (
            b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71")
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if case.list_chunk:
        info = b"INFOICMT" + struct.pack("<I", 5) + b"hello"
        body += b"LIST" + struct.pack("<I", len(info)) + info + b"\x00"
    body += b"data" + struct.pack("<I", len(raw)) + raw
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def write_decode_set(d: str) -> tuple[dict, list[str]]:
    """DECODE_CASES written under d, seeded by their order: ({name: path},
    [a file that is not RIFF, a missing path])."""
    good = {}
    for i, (name, case) in enumerate(DECODE_CASES.items()):
        good[name] = os.path.join(d, f"{name}.wav")
        write_case(good[name], case, seed=100 + i)
    bad = [os.path.join(d, "not_riff.wav"), os.path.join(d, "missing.wav")]
    with open(bad[0], "wb") as f:
        f.write(b"RIFX\x00\x00\x00\x00not a wave file")
    return good, bad


def phase_decode(tmp: str, smi: str) -> list[str]:
    """The native decoder against its plain version and the JAX package's
    error rule, then the decode of phase 6's dataset (written here) timed
    three ways. Returns the dataset's test wav paths."""
    from tpu_breath_torch.config import Paths
    from tpu_breath_torch.data import dataset as ds
    from tpu_breath_torch.data import wav as wav_io

    d = os.path.join(tmp, "decode")
    os.makedirs(d)
    good, bad = write_decode_set(d)
    native = wav_io.load_wav_batch(list(good.values()))
    worst = 0.0
    for (name, case), got in zip(DECODE_CASES.items(), native):
        want = wav_io.load_wav(good[name])
        if case.rate == SR and not np.array_equal(got, want):
            raise AssertionError(f"{name}: native != plain at 16 kHz")
        err = float(np.max(np.abs(got - want)))
        worst = max(worst, err)
        if err > 2e-6:  # tests/test_wav_edge_cases.py's bound
            raise AssertionError(f"{name}: native vs plain {err:.3g} > 2e-6")
    batch = [good["pcm16_short"], bad[0], good["pcm24_48k_3ch"], bad[1]]
    errors: list = []
    got = wav_io.load_wav_batch(batch, errors=errors)
    want = np.stack([wav_io.load_wav(batch[0]), np.zeros(SR, np.float32),
                     wav_io.load_wav(batch[2]), np.zeros(SR, np.float32)])
    if not np.array_equal(got, want) or [p for p, _ in errors] != bad:
        raise AssertionError(f"error rule: {errors}")
    try:
        wav_io.load_wav_batch(batch)
    except ValueError as e:
        raised = str(e)
    else:
        raise AssertionError("a batch with a bad file decoded without errors")
    log(f"[decode] {len(good)} formats: bit-equal to the plain version at "
        f"16 kHz, resampled max abs {worst:.3g} (bound 2e-6); error rule: "
        f"zeros, {len(errors)} listed, without errors= raised {raised!r}")

    root = os.path.join(tmp, "input")
    test_paths = make_dataset(root)
    clips = ds.dataset_wavs(Paths(root))[1]
    ways = {"native, all cores": lambda: wav_io.load_wav_batch(clips),
            "native, 1 thread": lambda: wav_io.load_wav_batch(clips,
                                                              n_threads=1),
            "plain": lambda: np.stack([wav_io.load_wav(p) for p in clips])}
    secs = {k: [] for k in ways}
    outs = {}
    for _ in range(5):
        for k, fn in ways.items():
            t0 = time.perf_counter()
            outs[k] = fn()
            secs[k].append(time.perf_counter() - t0)
    if not all(np.array_equal(o, outs["plain"]) for o in outs.values()):
        raise AssertionError("the dataset's clips decode otherwise")
    log(f"[decode] {len(clips)} clips (mono PCM16, 16 kHz), host clock, "
        f"median (min-max) of 5 runs in turns, s: " + "; ".join(
            f"{k} {np.median(v):.4f} ({min(v):.4f}-{max(v):.4f})"
            for k, v in secs.items())
        + f"; os.cpu_count() {os.cpu_count()}; {smi}")
    return test_paths


def reset_launches() -> None:
    add_launches({k: -n for k, n in read_launches().items()})


def make_dataset(root: str, n_train: int = 1280, n_test: int = 256,
                 seed: int = 11) -> list[str]:
    """A seeded synthetic dataset in the repo's layout: train.csv (ID,
    Target), test.csv (ID), train/x_NNNN.wav for ID x_[EI]_NNNN, test/
    x_NNNN.wav. Label rule the models can learn: E clips have a rising
    amplitude envelope, I clips a falling one; smoothed noise of varied
    colour and loudness, never silent. Returns the test wav paths."""
    rng = np.random.default_rng(seed)
    t = np.arange(SR) / SR
    for d in ("train", "test"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    train_rows, test_paths = [], []
    for i in range(n_train + n_test):
        rising = bool(rng.integers(2))
        ramp = t if rising else 1.0 - t
        env = 0.1 + 0.9 * ramp ** rng.uniform(0.7, 1.5)
        k = int(rng.integers(1, 9))
        noise = np.convolve(rng.standard_normal(SR + k - 1),
                            np.ones(k) / np.sqrt(k), mode="valid")
        y = 10.0 ** rng.uniform(-1.6, -0.7) * env * noise
        if i < n_train:
            train_rows.append((f"x_{'E' if rising else 'I'}_{i:04d}",
                               "E" if rising else "I"))
            write_wav(os.path.join(root, "train", f"x_{i:04d}.wav"), y)
        else:
            test_paths.append(os.path.join(root, "test", f"x_{i:04d}.wav"))
            write_wav(test_paths[-1], y)
    with open(os.path.join(root, "train.csv"), "w") as f:
        f.write("ID,Target\n" + "".join(f"{a},{b}\n" for a, b in train_rows))
    with open(os.path.join(root, "test.csv"), "w") as f:
        f.write("ID\n" + "".join(os.path.basename(p)[:-4] + "\n"
                                 for p in test_paths))
    return test_paths


def run_cli(argv: list[str]) -> tuple[str, float]:
    """cli.main(argv) with its stdout captured and echoed; (stdout, s)."""
    from tpu_breath_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        if "\t" not in line:
            log(f"[e2e]   {line}")
    return out.getvalue(), dt


def read_history(out_root: str, arch: str) -> list[dict]:
    from tpu_breath_torch import cli

    with open(os.path.join(cli.ckpt_dir(out_root, arch),
                           "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def read_submission(path: str, n: int) -> list[list[str]]:
    with open(path) as f:
        rows = [line.strip().split(",") for line in f]
    if rows[0] != ["ID", "Target"] or len(rows) != n + 1 or any(
            r[1] not in ("E", "I") for r in rows[1:]):
        raise AssertionError(f"bad submission {path}: {rows[:3]}, "
                             f"{len(rows)} lines")
    return rows[1:]


def phase_e2e(tmp: str, test_paths: list[str]) -> dict:
    """precompute (B'') -> train cnn8,vgg -> resume -> predict (cache and
    --from-wav) through cli.main on cuda, at full width and the configs'
    batch 512, on the dataset phase_decode wrote under tmp/input."""
    from tpu_breath_torch import cli, ensemble
    from tpu_breath_torch.config import Paths
    from tpu_breath_torch.data import dataset as ds
    from tpu_breath_torch.train import checkpoint as ckpt_lib

    root, out_root = os.path.join(tmp, "input"), os.path.join(tmp, "e2e")
    common = ["--root", root, "--out-root", out_root, "--device", "cuda"]
    res = {}
    reset_launches()
    with gt_switch():
        out, dt = run_cli(["precompute", *common])
    res["precompute_s"] = dt
    res["decode_line"], res["precompute_line"] = (
        next(l for l in out.splitlines() if l.startswith(w))
        for w in ("decoded in", "features:"))
    log(f"[e2e] precompute: {res['decode_line']}; {res['precompute_line']}; "
        f"whole command {dt:.2f} s")
    after_pre = read_launches()
    if min(after_pre["B''"], after_pre["E"]) <= 0 or after_pre["B"] != 0:
        raise AssertionError(f"precompute with TPU_BREATH_PALLAS_GT=1 did "
                             f"not take kernels B'' and E: {after_pre}")

    _, res["train_s"] = run_cli(["train", "--archs", "cnn8,vgg", "--epochs",
                                 "6", "--predict", *common])
    for arch in ("cnn8", "vgg"):
        hist = read_history(out_root, arch)
        if len(hist) != 6 or not all(
                np.isfinite([r["train_loss"], r["val_loss"]]).all()
                for r in hist):
            raise AssertionError(f"{arch} history: {hist}")
        if ckpt_lib.latest_checkpoint(cli.ckpt_dir(out_root, arch)) is None:
            raise AssertionError(f"{arch}: no checkpoint")
        res[arch] = hist
    sub = os.path.join(out_root, "submissions", "submission.csv")
    read_submission(sub, len(test_paths))

    out, _ = run_cli(["train", "--archs", "cnn8", "--epochs", "7",
                      "--resume", *common])
    resumed = read_history(out_root, "cnn8")
    if ("resumed from epoch" not in out or not resumed
            or resumed[0]["epoch"] <= 1 or resumed[-1]["epoch"] != 7):
        raise AssertionError(f"resume did not continue: {resumed}")
    res["resumed_epochs"] = [r["epoch"] for r in resumed]

    os.remove(sub)
    run_cli(["predict", "--archs", "cnn8,vgg", *common])
    read_submission(sub, len(test_paths))
    served = test_paths[:16]
    out, _ = run_cli(["predict", "--from-wav", *served, "--archs",
                      "cnn8,vgg", *common])
    res["launches"] = read_launches()
    # B' and D are on no path of the system
    if min(v for k, v in res["launches"].items()
           if k not in ("B'", "D")) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: "
                             f"{res['launches']}")
    p_wav = np.array([float(l.split("\t")[2]) for l in out.splitlines()
                      if "\t" in l])
    res["ast"] = ast_cli(common, served)

    # the outputs against the CPU: the ensemble on the cached test features
    # (bf16 autocast on the card, f32 on the CPU), and served clips vs the
    # cache (kernel B vs B'' gammatone, bf16)
    store = ds.FeatureStore.load_cache(Paths(root, out_root).feature_cache)
    ids = [os.path.basename(p)[:-4] for p in served]
    te = store.subset(ids)
    ckpts, scores = cli._load_ensemble_ckpts(out_root, ["cnn8", "vgg"])
    p_gpu, p_cpu = (ensemble.weighted_ensemble(
        ckpts, ["cnn8", "vgg"], scores, te.features, te.scalars, 36,
        device=d) for d in ("cuda", "cpu"))
    gap, gap_wav = (float(np.max(np.abs(p_gpu - p))) for p in (p_cpu, p_wav))
    if not (np.isfinite(p_gpu).all() and len(p_wav) == len(served)
            and gap <= 2e-2 and gap_wav <= 2e-2):
        raise AssertionError(f"ensemble: gpu {p_gpu}, cpu {p_cpu}, "
                             f"from wav {p_wav}")
    log(f"[e2e] launches over the path {res['launches']}; precompute "
        f"alone {after_pre}; resumed epochs {res['resumed_epochs']}; "
        f"ensemble on {len(served)} test clips: |gpu (bf16) - cpu (f32)| "
        f"{gap:.3g}, |from wav - from cache| {gap_wav:.3g} (bounds 2e-2)")
    log(f"[e2e] train cnn8,vgg 6 epochs + predict: {res['train_s']:.2f} s")
    for arch in ("cnn8", "vgg"):
        log(f"[e2e] {arch} val acc by epoch "
            f"{[round(r['val_acc'], 4) for r in res[arch]]}; epoch wall time "
            f"(2 steps + val of 256) median "
            f"{np.median([r['sec'] for r in res[arch][1:]]):.3f} s, epochs "
            f"2-6")
    return res


def ast_cli(common: list[str], served: list[str]) -> dict:
    """The AST through the CLI on phase 6's cache: train --archs ast_base
    --epochs 2 (published widths, batch 512; fit's graphs), then predict
    --from-wav --archs ast_base (the Server's graphs): finite history, a
    checkpoint, one probability a served clip, and those probabilities
    against the same checkpoint served on the CPU from the same wavs (f32,
    the plain features), and its logits on the clips' cached features
    against the CPU's."""
    from tpu_breath_torch import cli, ensemble
    from tpu_breath_torch.config import Paths
    from tpu_breath_torch.data import dataset as ds
    from tpu_breath_torch.train import checkpoint as ckpt_lib

    root, out_root = (common[common.index(k) + 1]
                      for k in ("--root", "--out-root"))
    _, train_s = run_cli(["train", "--archs", "ast_base", "--epochs", "2",
                          *common])
    hist = read_history(out_root, "ast_base")
    if len(hist) != 2 or not all(np.isfinite([r["train_loss"],
                                              r["val_loss"]]).all()
                                 for r in hist):
        raise AssertionError(f"ast_base history: {hist}")
    if ckpt_lib.latest_checkpoint(cli.ckpt_dir(out_root, "ast_base")) is None:
        raise AssertionError("ast_base: no checkpoint")
    out, _ = run_cli(["predict", "--from-wav", *served, "--archs",
                      "ast_base", *common])
    probs = [float(line.split("\t")[2]) for line in out.splitlines()
             if "\t" in line]
    if len(probs) != len(served) or not np.isfinite(probs).all():
        raise AssertionError(f"ast_base predict --from-wav: {out[-2000:]}")
    ckpts, scores = cli._load_ensemble_ckpts(out_root, ["ast_base"])
    p_cpu = ensemble.serve_from_wav(ckpts, ["ast_base"], scores,
                                    np.stack([read_wav(p) for p in served]),
                                    device="cpu")
    # two epochs at AST's rate from a random start saturate the sigmoid
    # (PERF.md §7), so the logits of the same clips' cached features are
    # held too: the card's bf16 against the CPU's f32, at the bound of the
    # card test test_bf16_logits_near_the_f32_reference
    store = ds.FeatureStore.load_cache(Paths(root, out_root).feature_cache)
    te = store.subset([os.path.basename(p)[:-4] for p in served])
    logits = {}
    for d in ("cuda", "cpu"):
        model, = ensemble.load_models(ckpts, ["ast_base"], 36, d)
        with torch.no_grad():
            logits[d] = model(torch.from_numpy(te.features).to(d),
                              torch.from_numpy(te.scalars).to(d)
                              ).double().cpu().numpy()
    gap = float(np.max(np.abs(np.array(probs) - p_cpu)))
    logit_gap = float(np.max(np.abs(logits["cuda"] - logits["cpu"])))
    if gap > 2e-2 or logit_gap > 0.05 or logits["cpu"].std() <= 0.01:
        raise AssertionError(f"ast_base served: card {probs}, cpu {p_cpu}; "
                             f"logits card {logits['cuda']}, cpu "
                             f"{logits['cpu']}")
    log(f"[e2e] ast_base: 2 epochs in {train_s:.2f} s, val acc "
        f"{[round(r['val_acc'], 4) for r in hist]}; {len(probs)} clips "
        f"served from wav, |card (bf16) - cpu (f32)| max {gap:.3g} (bound "
        f"2e-2); logits {np.round(logits['cpu'], 3).tolist()}, |card - "
        f"cpu| max {logit_gap:.3g} (bound 0.05)")
    return {"history": hist, "train_s": train_s, "probs": probs,
            "cpu_gap": gap, "logit_gap": logit_gap}


REPRO_KEYS = ("train_loss", "train_acc", "val_loss", "val_acc", "lr")


def history_diff(a: list[dict], b: list[dict]) -> dict:
    """REPRO_KEYS -> max |a - b| over the epochs of a (b must hold each of
    them), or None for every key when b lacks one."""
    by_epoch = {r["epoch"]: r for r in b}
    if not a or any(r["epoch"] not in by_epoch for r in a):
        return dict.fromkeys(REPRO_KEYS)
    return {k: max(abs(r[k] - by_epoch[r["epoch"]][k]) for r in a)
            for k in REPRO_KEYS}


class Interrupted(Exception):
    """A CLI run stopped at an epoch line (phase_repro)."""


class StopAtEpoch(io.StringIO):
    """stdout that raises Interrupted once `epoch`'s line is written, as a
    run killed right after it would stop: that epoch's checkpoint unsaved."""

    def __init__(self, epoch: int):
        super().__init__()
        self.line = f"[Epoch {epoch:03d}]"

    def write(self, s: str) -> int:
        n = super().write(s)
        if s.startswith(self.line):
            raise Interrupted
        return n


def phase_repro(tmp: str, e2e: dict) -> dict:
    """Same seed, same history, on phase 6's dataset and cache through
    cli.main on cuda, with every cuDNN flag at the caller's default:
    (a) train cnn8,vgg 6 epochs again into another out-root: each epoch's
    REPRO_KEYS equal phase 6's bit for bit; (b) train --fused cnn8,vgg 6
    epochs with TPU_BREATH_PALLAS_GT=1, twice: equal; (c) train cnn8 7
    epochs stopped at its 4th epoch line, then --resume: the resumed
    epochs equal an uninterrupted 7-epoch run's; (d) --seed 1 cnn8,vgg:
    each history differs from seed 0's (phase 6). Logs the largest |diff|
    per key of every comparison, then raises if one failed. A, B'' and C
    launch 384 / 192 / 192 times (the two fused runs)."""
    from tpu_breath_torch import cli

    root = os.path.join(tmp, "input")
    t0 = time.perf_counter()
    reset_launches()

    def train(name: str, *argv: str) -> str:
        out_root = os.path.join(tmp, "repro", name)
        run_cli(["train", *argv, "--root", root, "--out-root", out_root,
                 "--device", "cuda"])
        return out_root

    failed = []

    def compare(label: str, a: list[dict], b: list[dict], equal: bool):
        d = history_diff(a, b)
        same = len(a) == len(b) and all(v == 0 for v in d.values())
        log(f"[repro] {label}: {len(a)} / {len(b)} epochs, max |diff| "
            f"{d} -> {'equal' if same else 'differ'} (want "
            f"{'equal' if equal else 'differ'})")
        if same != equal:
            failed.append(label)

    six = ("--archs", "cnn8,vgg", "--epochs", "6")
    again = train("again", *six)
    with gt_switch():
        fused = [train(f"fused{i}", "--fused", *six) for i in (1, 2)]
    seed1 = train("seed1", *six, "--seed", "1")
    for arch in ("cnn8", "vgg"):
        compare(f"(a) {arch} cached, again vs phase 6",
                read_history(again, arch), e2e[arch], True)
        compare(f"(b) {arch} fused, run 2 vs run 1",
                *(read_history(o, arch) for o in fused[::-1]), True)
        compare(f"(d) {arch} seed 1 vs seed 0",
                read_history(seed1, arch), e2e[arch], False)

    seven = ("--archs", "cnn8", "--epochs", "7")
    full = train("full7", *seven)
    part = os.path.join(tmp, "repro", "part7")
    common = [*seven, "--root", root, "--out-root", part, "--device", "cuda"]
    try:
        with contextlib.redirect_stdout(StopAtEpoch(4)):
            cli.main(["train", *common])
    except Interrupted:
        pass
    else:
        raise AssertionError("(c) the run was not stopped at epoch 4")
    out, _ = run_cli(["train", *common, "--resume"])
    resumed = read_history(part, "cnn8")
    if "resumed from epoch" not in out or resumed[0]["epoch"] <= 1:
        raise AssertionError(f"(c) the run did not resume: {resumed}")
    first = resumed[0]["epoch"]
    compare(f"(c) cnn8 resumed, epochs {first}-7 vs uninterrupted",
            resumed, [r for r in read_history(full, "cnn8")
                      if r["epoch"] >= first], True)

    launches = read_launches()
    want = {"A": 384, "B": 0, "B'": 0, "B''": 192, "C": 192, "D": 0,
            "E": 192}
    seconds = time.perf_counter() - t0
    log(f"[repro] launches {launches} (expected {want}: 2 fused runs); "
        f"phase {seconds:.1f} s")
    if failed:
        raise AssertionError(f"repro: {failed}")
    if launches != want:
        raise AssertionError("repro launches differ from the expected")
    return {"launches": launches}


@contextlib.contextmanager
def gt_switch():
    """TPU_BREATH_PALLAS_GT=1 (kernel B'', the features of the cache)
    inside the block."""
    os.environ["TPU_BREATH_PALLAS_GT"] = "1"
    try:
        yield
    finally:
        del os.environ["TPU_BREATH_PALLAS_GT"]


def phase_fused(tmp: str) -> dict:
    """train --fused against train from the cache, through cli.main on
    cuda, on phase_e2e's dataset and cache (computed with kernel B'')."""
    from tpu_breath_torch import cli
    from tpu_breath_torch.config import CNN8_TRAIN, DEFAULT_FEATURES, Paths
    from tpu_breath_torch.data import dataset as ds
    from tpu_breath_torch.data import wav as wav_io
    from tpu_breath_torch.train import loop

    root = os.path.join(tmp, "input")
    res = {}
    with gt_switch():
        # the features inside one fused step (the first batch of epoch 1,
        # 4 chunks of 128 clips, precompute's geometry) against the cache
        tr = cli._prepare_splits(Paths(root, tmp), DEFAULT_FEATURES,
                                 torch.device("cuda"))[0]
        wavs = wav_io.load_wav_batch(
            [os.path.join(root, "train", ds.train_wav_name(i))
             for i in tr.ids], DEFAULT_FEATURES.expected_len)
        idx = loop.epoch_permutation(CNN8_TRAIN.seed, 0, len(tr.ids))[
            :CNN8_TRAIN.batch_size]
        res["wavs"] = torch.from_numpy(wavs).cuda()
        f, s = (t.cpu().numpy() for t in loop.fused_features(
            res["wavs"][torch.from_numpy(idx).cuda()], DEFAULT_FEATURES))
        feat_err = float(np.nanmax(np.abs(f - tr.features[idx])))
        scal_err = float(np.nanmax(np.abs(s - tr.scalars[idx])))
        same_nan = (np.array_equal(np.isnan(f), np.isnan(tr.features[idx]))
                    and np.array_equal(np.isnan(s),
                                       np.isnan(tr.scalars[idx])))
        log(f"[fused] one step's features vs the cache's rows ({len(idx)} "
            f"clips): max abs {feat_err:.3g}, scalars {scal_err:.3g}, NaN "
            f"masks equal {same_nan} (bound 0: the same kernels at the same "
            f"chunk geometry)")
        if not (feat_err == 0 and scal_err == 0 and same_nan):
            raise AssertionError("fused step features differ from the cache")

        common = ["--root", root, "--device", "cuda", "--archs", "cnn8,vgg",
                  "--epochs", "6"]
        cached_out = os.path.join(tmp, "cached_det")
        run_cli(["train", *common, "--out-root", cached_out])
        fused_out = os.path.join(tmp, "fused")
        reset_launches()
        _, res["train_s"] = run_cli(["train", "--fused", "--predict",
                                     *common, "--out-root", fused_out])
        res["launches"] = read_launches()
    want = {"A": 192, "B": 0, "B'": 0, "B''": 96, "C": 96, "D": 0,
            "E": 96}
    log(f"[fused] launches over train --fused {res['launches']} (expected "
        f"{want}: 6 epochs x 2 steps x 4 chunks x 2 archs)")
    if res["launches"] != want:
        raise AssertionError("fused launches differ from the expected")
    worst = {"train_loss": 0.0, "val_acc": 0.0}
    for arch in ("cnn8", "vgg"):
        hf, hc = read_history(fused_out, arch), read_history(cached_out, arch)
        if len(hf) != 6 or len(hc) != 6:
            raise AssertionError(f"{arch}: {len(hf)} / {len(hc)} epochs")
        for k in worst:
            worst[k] = max([worst[k]] + [abs(a[k] - b[k])
                                         for a, b in zip(hf, hc)])
        res[arch] = hf
        log(f"[fused] {arch} train loss by epoch "
            f"{[round(r['train_loss'], 6) for r in hf]}, val acc "
            f"{[round(r['val_acc'], 4) for r in hf]}; epoch wall time "
            f"median {np.median([r['sec'] for r in hf[1:]]):.3f} s, epochs "
            f"2-6")
    # bound 0: equal features, fit's reproducible scope, and every other
    # draw the cached run's
    log(f"[fused] fused vs cached history, max |diff|: train_loss "
        f"{worst['train_loss']:.3g}, val_acc {worst['val_acc']:.3g} "
        f"(bound 0, cuDNN flags at their defaults)")
    if any(worst.values()):
        raise AssertionError(f"fused history differs from cached: {worst}")
    read_submission(os.path.join(fused_out, "submissions", "submission.csv"),
                    256)
    return res


# One rank of a data-parallel CLI run (phase_mesh): cli.main(ARGV) with
# the launcher's environment, inside graphs.eager() when MODE is "eager";
# writes {"launches", "step_ms"} (the kernels' launches and each train
# step's host time, synchronized: step_timer) and each fit's final
# state_dict to OUT. Arguments: MODE OUT ARGV...
RANK_CODE = """
import contextlib, json, os, sys
import torch
import chip_smoke
from tpu_breath_torch import cli, graphs
from tpu_breath_torch.train import loop
mode, out, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
rank = os.environ["RANK"]
fit, step_ms = loop.fit, []
def fit_and_keep(model, *a, **k):
    r = fit(model, *a, **k)
    torch.save(r.model.state_dict(),
               os.path.join(out, type(model).__name__ + "_rank" + rank + ".pt"))
    return r
loop.fit = fit_and_keep
chip_smoke.reset_launches()
with chip_smoke.step_timer(step_ms), (
        graphs.eager() if mode == "eager" else contextlib.nullcontext()):
    cli.main(argv)
with open(os.path.join(out, "rank" + rank + ".json"), "w") as f:
    json.dump({"launches": chip_smoke.read_launches(), "step_ms": step_ms}, f)
"""


@contextlib.contextmanager
def step_timer(ms: list):
    """Inside the block every call of a train step program
    (loop.TrainStep) is timed on the host clock with the card synchronized
    after it (outside any capture: a first call's warm call and capture
    are one call); [model class, ms] appended to ms."""
    from tpu_breath_torch.train import loop

    call = loop.TrainStep.__call__

    def timed(self, *xs):
        t0 = time.perf_counter()
        out = call(self, *xs)
        torch.cuda.synchronize()
        ms.append([type(self.model).__name__,
                   (time.perf_counter() - t0) * 1e3])
        return out

    loop.TrainStep.__call__ = timed
    try:
        yield
    finally:
        loop.TrainStep.__call__ = call


def free_port() -> int:
    """A free TCP port on this host, for a process group's rendezvous."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def run_ranks(argv: list[str], out: str, env: dict | None = None,
              world: int = 2, mode: str = "graph") -> list[dict]:
    """`world` processes of RANK_CODE, started as torchrun starts them
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT), each running cli.main(argv) on cuda:(rank % cards),
    inside graphs.eager() when mode is "eager"; every process is waited
    for. Returns each rank's {"launches", "step_ms", "log"}; raises if a
    rank fails."""
    os.makedirs(out, exist_ok=True)
    port = free_port()
    procs = []
    for rank in range(world):
        penv = {**os.environ, **(env or {}), "RANK": str(rank),
                "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(port), "PYTHONPATH": ROOT}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CODE, mode, out, *argv], env=penv,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            if rank == 0 or p.returncode:
                log(f"[mesh]   r{rank} {line}")
        if p.returncode:
            raise AssertionError(f"rank {rank} of {argv[0]} --mesh exited "
                                 f"{p.returncode}")
    out_json = []
    for rank, text in enumerate(logs):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            out_json.append({**json.load(f), "log": text})
    return out_json


def same_weights(outs: list[str], names: list[str], world: int = 2) -> None:
    """Every rank's final weights of each model in names are bit-equal, in
    every run directory of outs (rank 0 of outs[0] the reference)."""
    for name in names:
        ref = torch.load(os.path.join(outs[0], f"{name}_rank0.pt"),
                         map_location="cpu")
        for out in outs:
            for r in range(world):
                sd = torch.load(os.path.join(out, f"{name}_rank{r}.pt"),
                                map_location="cpu")
                bad = [k for k, v in ref.items() if not torch.equal(v, sd[k])]
                if bad:
                    raise AssertionError(
                        f"{name}: rank {r}'s weights in {out} differ from "
                        f"rank 0's in {outs[0]}: {bad[:5]}")


@contextlib.contextmanager
def one_rank():
    """This process as the one rank of an NCCL mesh (the launcher's
    variables set for the block, the group destroyed after it)."""
    import torch.distributed as dist

    from tpu_breath_torch.parallel import mesh as mesh_lib

    names = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
             "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(free_port())}
    os.environ.update(names)
    try:
        mesh = mesh_lib.make_mesh("cuda")
        log(f"[mesh] {mesh_lib.describe(mesh)}")
        if mesh.backend != "nccl":
            raise AssertionError(f"one rank a card should be nccl: {mesh}")
        yield mesh
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in names:
            os.environ.pop(k, None)


def _stream(arrays: tuple, steps: int, seed: int):
    """steps batches of STEP_BATCH rows of the host arrays (rows drawn from
    seed), gathered on the host and handed over by loader.Prefetcher from
    pinned memory, as fit streams a rank's shard."""
    from tpu_breath_torch.data import loader

    rng = np.random.default_rng(seed)

    def batches():
        for _ in range(steps):
            idx = rng.permutation(len(arrays[0]))[:STEP_BATCH]
            yield tuple(np.ascontiguousarray(a[idx]) for a in arrays)

    return loader.Prefetcher(batches(), depth=2, device="cuda")


def _mesh_programs(arch: str, fused: bool, mesh):
    """Two streamed step programs (loop.TrainStep, data None) of `arch` at
    batch 512 on mesh from one seeded state: each its own model (seed 0,
    its layers on the mesh), optimizer and augmentation generator (seed
    1)."""
    from tpu_breath_torch.config import CNN8_TRAIN, DEFAULT_FEATURES, VGG_TRAIN
    from tpu_breath_torch.models import layers, registry
    from tpu_breath_torch.train import loop

    cfg = dataclasses.replace({"cnn8": CNN8_TRAIN, "vgg": VGG_TRAIN}[arch],
                              batch_size=STEP_BATCH)
    out = []
    for _ in range(2):
        model = registry.build(arch, 36, seed=0).cuda()
        layers.set_mesh(model, mesh)
        opt = loop.make_optimizer(model, cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        out.append((model, opt, loop.TrainStep(
            model, opt, None, cfg, gen, DEFAULT_FEATURES if fused else None,
            mesh)))
    return out


def _drive_stream(step, arrays: tuple, data: dict, steps: int, seed: int
                  ) -> tuple[list, list]:
    """steps calls of step on streamed batches (seed) at data's rates,
    augmentation on, the dropout generator seeded first; (losses,
    accuracies) as floats."""
    torch.manual_seed(2)
    losses, accs = [], []
    for s, batch in enumerate(_stream(arrays, steps, seed)):
        loss, acc = step(*batch, data["lrs"][s], data["on"])
        losses.append(loss.clone())
        accs.append(acc.clone())
    return torch.stack(losses).tolist(), torch.stack(accs).tolist()


def _stream_ms(step, arrays: tuple, data: dict, seed: int
               ) -> tuple[float, list]:
    """ms a step by CUDA events over STEPS streamed steps (the loader's
    host gather and hand-over included, as fit runs them: the loop is one
    device_ms launch), and the host's ms to issue each step's call."""
    issue = []

    def steps():
        for s, batch in enumerate(_stream(arrays, STEPS, seed)):
            t0 = time.perf_counter()
            step(*batch, data["lrs"][s], data["on"])
            issue.append((time.perf_counter() - t0) * 1e3)
    ms, = device_ms(steps, "cuda")
    return ms / STEPS, issue


def mesh_steps(mesh, smi: str) -> dict:
    """(i) a: the streamed step programs (loop.TrainStep, data None) on one
    NCCL rank, graphed against eager (graphs.eager()), batch 512 on
    seeded clips streamed from the host: for CNN8 and VGG, cached
    and fused (kernel B), two programs from one seeded state run 8 steps
    each on the same batches, augmentation on: losses, accuracies, every
    parameter and buffer, both moments and the step count bit-equal, the
    fused graph holding A 8 / B 4 / C 4 / E 4. Then for CNN8, cached and
    fused, in turns (eager, graph, graph, eager): ms a step (CUDA events
    over 8 streamed steps, the loader included), the host's ms to issue a
    step's call, one traced step (kernels, host launches, busy share)."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.features import extract_features_batched
    from tpu_breath_torch.train import loop
    from tpu_breath_torch.train.schedule import warmup_cosine

    wavs = clips(2 * STEP_BATCH)
    f, s = extract_features_batched(wavs, chunk=CHUNK)
    labels = np.tile(np.float32([0.0, 1.0]), STEP_BATCH)
    lr = warmup_cosine(1e-3, 100)
    data = {"lrs": torch.tensor([lr(k) for k in range(STEPS)],
                                dtype=torch.float32).cuda(),
            "on": torch.ones((), dtype=torch.bool).cuda()}
    res = {"i": {}, "ms": {}, "issue_ms": {}, "trace": {}, "pools": []}
    failed = []
    with loop.reproducible():
        for arch in STEP_KEYS:
            for mode in ("cached", "fused"):
                name = f"{arch} {mode}"
                fused = mode == "fused"
                arrays = (wavs, labels) if fused else (f, s, labels)
                (me, oe, se), (mg, og, sg) = _mesh_programs(arch, fused, mesh)
                with graphs.eager():
                    le, ae = _drive_stream(se, arrays, data, STEPS, 3)
                lg, ag = _drive_stream(sg, arrays, data, STEPS, 3)
                a, b = _state(me, oe), _state(mg, og)
                diff = {k: float((a[k].double() - b[k].double()).abs().max())
                        for k in a if not torch.equal(a[k], b[k])}
                graph = next(iter(sg.graphs.values()))
                res["i"][name] = {"losses_equal": le == lg,
                                  "accs_equal": ae == ag, "tensors": len(a),
                                  "unequal": diff,
                                  "launches_a_replay": graph.launches}
                res["pools"].append({"graph": f"mesh step {name}",
                                     "capture_s": graph.capture_s,
                                     "pool_bytes": graph.pool_bytes})
                log(f"[mesh] (i) {name}, {STEPS} streamed steps on one NCCL "
                    f"rank, eager vs graphed: losses equal {le == lg}, "
                    f"accuracies equal {ae == ag}, {len(a) - len(diff)} of "
                    f"{len(a)} tensors bit-equal"
                    f"{'' if not diff else f'; max |diff| {diff}'}; graph "
                    f"launches a replay {graph.launches}; capture (warm step "
                    f"included) {graph.capture_s:.2f} s, pool "
                    f"{graph.pool_bytes / 2**20:.0f} MiB")
                want = {"A": 8, "B": 4, "C": 4, "E": 4} if fused else {}
                if not (le == lg and ae == ag and not diff) or {
                        k: v for k, v in graph.launches.items() if v} != want:
                    failed.append(name)
                if arch == "cnn8":
                    ms, issue = {False: [], True: []}, {False: [], True: []}
                    for graphed in (False, True, True, False):
                        step = sg if graphed else se
                        with (contextlib.nullcontext() if graphed
                              else graphs.eager()):
                            m, q = _stream_ms(step, arrays, data, 4)
                        ms[graphed].append(m)
                        issue[graphed] += q
                    traces = {}
                    for graphed, step in ((False, se), (True, sg)):
                        it = iter(_stream(arrays, 10**6, 5))
                        with (contextlib.nullcontext() if graphed
                              else graphs.eager()):
                            traces[graphed] = _traced(lambda: step(
                                *next(it), data["lrs"][0], data["on"]))
                    res["ms"][name] = {m: {"median": float(np.median(ms[g])),
                                           "runs": ms[g]}
                                       for m, g in (("eager", False),
                                                    ("graph", True))}
                    res["issue_ms"][name] = {
                        m: float(np.median(issue[g]))
                        for m, g in (("eager", False), ("graph", True))}
                    res["trace"][name] = {"eager": traces[False],
                                          "graph": traces[True]}
                    te, tg = traces[False], traces[True]
                    log(f"[mesh] (i) {name}, one NCCL rank, streamed, in "
                        f"turns: ms a step (CUDA events, {STEPS} steps a "
                        f"turn, the loader included): eager "
                        f"{res['ms'][name]['eager']['median']:.2f} / graph "
                        f"{res['ms'][name]['graph']['median']:.2f}; host ms "
                        f"to issue a step: eager "
                        f"{res['issue_ms'][name]['eager']:.3f} / graph "
                        f"{res['issue_ms'][name]['graph']:.3f}; one step "
                        f"traced (the next batch's hand-over included): "
                        f"eager {te['host_launches']} host launches, "
                        f"{te['kernels']} kernels, busy "
                        f"{te['busy_of_span'] or 0:.1%} of "
                        f"{te['span_ms']:.2f} ms, {te['busy_of_wall']:.1%} of "
                        f"{te['wall_ms']:.2f} ms wall; graph "
                        f"{tg['host_launches']} host launches, "
                        f"{tg['kernels']} kernels, busy "
                        f"{tg['busy_of_span'] or 0:.1%} of "
                        f"{tg['span_ms']:.2f} ms, {tg['busy_of_wall']:.1%} of "
                        f"{tg['wall_ms']:.2f} ms wall; {smi}")
                del me, oe, se, mg, og, sg, graph
                torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"mesh: graphed differs from eager: {failed}")
    return res


def mesh_epoch_waits_once(mesh, tr, va, y_tr, y_va) -> None:
    """(i) c: a graphed fit on one NCCL rank (cached CNN8, batch 512, 3
    epochs, augmentation from the second) queues each epoch after the
    first (streamed uploads, step replays, the means' all-reduce,
    evaluation replays) without a host synchronisation (sync debug mode
    "error" from the end of the first epoch) until the epoch's one wait
    (graphs.wait, where the check ends)."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.config import CNN8_TRAIN
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    waits, lines = [], []
    wait = graphs.wait

    def final_wait(device):
        torch.cuda.set_sync_debug_mode(0)
        waits.append(len(lines))
        wait(device)

    def log_fn(msg):  # an epoch ends: check the next one
        lines.append(msg)
        torch.cuda.set_sync_debug_mode("error")

    cfg = dataclasses.replace(CNN8_TRAIN, num_epochs=3, warmup_epochs=1,
                              patience=9)
    graphs.wait = final_wait
    try:
        loop.fit(registry.build("cnn8", 36, seed=3), (tr.features,
                                                      tr.scalars),
                 (va.features, va.scalars), y_tr, y_va, cfg, log_fn=log_fn,
                 mesh=mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        graphs.wait = wait
    if not (waits == [0, 1, 2] and len(lines) == 3):
        raise AssertionError(f"graphed mesh epochs: waits {waits}")
    log("[mesh] (i) a graphed streamed fit on one NCCL rank (3 epochs): "
        "epochs 2 and 3 raised nothing under sync debug mode 'error' until "
        "their one wait")


def mesh_precompute(mesh, root: str, tmp: str, smi: str) -> dict:
    """(i) d: the sharded extraction (extract_features_batched(...,
    mesh=...), features._extract_sharded) on one NCCL rank with kernel B''
    over phase 6's 1,536 clips, eager (graphs.eager()) and graphed in
    turns after a warm call each: all bit-equal to phase 6's single-process cache, clips/s on
    the host clock, host waits a call (graphs.wait), and a graphed call
    raising nothing under sync debug mode "error" until its one wait."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.config import DEFAULT_FEATURES, Paths
    from tpu_breath_torch.data import dataset as ds
    from tpu_breath_torch.data import wav as wav_io
    from tpu_breath_torch.features import extract_features_batched

    _, paths = ds.dataset_wavs(Paths(root))
    wavs = wav_io.load_wav_batch(paths, DEFAULT_FEATURES.expected_len)
    cache = ds.FeatureStore.load_cache(Paths(root, tmp).feature_cache)
    want = [torch.from_numpy(np.array(a))
            for a in (cache.features, cache.scalars)]
    wait, waits = graphs.wait, []

    def counted(device):
        torch.cuda.set_sync_debug_mode(0)
        waits.append(device)
        wait(device)

    rate = {False: [], True: []}
    count = {False: [], True: []}
    graphs.wait = counted
    try:
        # a warm call each way first (uncounted): the first calls allocate
        # the pinned arrays that later calls reuse
        for k, graphed in enumerate((False, True, False, True, True, False)):
            del waits[:]
            torch.cuda.synchronize()
            if graphed and k >= 2:  # check the queue for syncs
                torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            with contextlib.nullcontext() if graphed else graphs.eager():
                got = extract_features_batched(wavs, chunk=CHUNK, mesh=mesh,
                                               fused_gt=True)
            dt = time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode(0)
            if k >= 2:
                rate[graphed].append(len(wavs) / dt)
                count[graphed].append(len(waits))
            if not all(_nan_equal(torch.from_numpy(g), w)
                       for g, w in zip(got, want)):
                raise AssertionError("the mesh's extraction differs from "
                                     "the single process's cache")
    finally:
        torch.cuda.set_sync_debug_mode(0)
        graphs.wait = wait
    out = {m: {"clips_per_s": rate[g], "waits": count[g]}
           for m, g in (("eager", False), ("graph", True))}
    log(f"[mesh] (i) precompute on one NCCL rank (TPU_BREATH_PALLAS_GT=1), "
        f"{len(wavs)} clips, in turns: bit-equal to phase 6's cache; clips/s "
        f"(host clock) eager {out['eager']['clips_per_s']} / graph "
        f"{out['graph']['clips_per_s']}; host waits a call eager "
        f"{out['eager']['waits']} / graph {out['graph']['waits']}; a warm "
        f"graphed call raised nothing under sync debug mode 'error' until "
        f"its wait; {smi}")
    if out["graph"]["waits"] != [1, 1]:
        raise AssertionError(f"graphed precompute waited {count[True]}")
    return out


def phase_mesh(tmp: str, smi: str) -> dict:
    """Data parallelism (parallel/mesh.py) on this card. (i) One NCCL rank
    in this process: a, the streamed step programs graphed against eager
    (mesh_steps); b, fit(mesh=...)'s streaming path (graphed) against the
    resident path, cached CNN8, batch 512, 2 epochs, f32 (train accuracy
    equal, losses within 1e-3); c, a graphed epoch's one host wait
    (mesh_epoch_waits_once); d, the sharded extraction against phase 6's
    cache (mesh_precompute). Prints {"mesh": ...}. (ii) Two ranks sharing
    the card over gloo, started as torchrun would: precompute --mesh 2
    with TPU_BREATH_PALLAS_GT=1 gives phase 6's cache bit for bit; train
    --mesh 2 cnn8,vgg (cached, 6 epochs: augmentation and its partner
    gather from epoch 5) and train --fused --mesh 2 cnn8 (2 epochs, kernel
    B) end with bit-equal weights on both ranks and finite histories; A,
    B'', C (precompute) and A, B, C, E (fused) launch in each rank
    (mesh_runs). Returns the launches of (i) and the ranks of (ii)."""
    from tpu_breath_torch import cli
    from tpu_breath_torch.config import CNN8_TRAIN, DEFAULT_FEATURES, Paths
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    root = os.path.join(tmp, "input")
    t0 = time.perf_counter()
    reset_launches()
    with one_rank() as mesh:
        res = {"device": smi, "steps": mesh_steps(mesh, smi)}
        tr, va, _, y_tr, y_va = cli._prepare_splits(
            Paths(root, tmp), DEFAULT_FEATURES, torch.device("cuda"))
        cfg = dataclasses.replace(CNN8_TRAIN, num_epochs=2)
        hist = {}
        torch.backends.cudnn.allow_tf32 = False
        try:
            for name, m in (("resident", None), ("streaming", mesh)):
                model = registry.build("cnn8", 36, seed=cfg.seed, bf16=False)
                hist[name] = loop.fit(
                    model, (tr.features, tr.scalars), (va.features,
                                                       va.scalars),
                    y_tr, y_va, cfg, device="cuda", mesh=m,
                    log_fn=lambda msg: None).history
        finally:
            torch.backends.cudnn.allow_tf32 = True
        dl = max(abs(a[k] - b[k]) for a, b in zip(hist["resident"],
                                                   hist["streaming"])
                 for k in ("train_loss", "val_loss"))
        same_acc = all(a["train_acc"] == b["train_acc"]
                       for a, b in zip(hist["resident"], hist["streaming"]))
        log(f"[mesh] (i) streaming (graphed, one NCCL rank) vs resident "
            f"history, CNN8 f32, 2 epochs: max |loss diff| {dl:.3g} (bound "
            f"1e-3), train acc equal {same_acc}")
        if not (len(hist["streaming"]) == 2 and dl < 1e-3 and same_acc):
            raise AssertionError("streaming fit differs from the resident")
        res["stream_vs_resident_loss_diff"] = dl
        mesh_epoch_waits_once(mesh, tr, va, y_tr, y_va)
        res["precompute"] = mesh_precompute(mesh, root, tmp, smi)
    torch.cuda.empty_cache()
    launches = read_launches()
    res["seconds"] = time.perf_counter() - t0
    log(f"[mesh] (i) launches {launches}; {res['seconds']:.1f} s")
    print(json.dumps({"mesh": res}), flush=True)

    # (ii) two ranks sharing the card over gloo
    out = mesh_runs(tmp, root, 2, smi)
    for k in launches:
        out["launches"][k] += launches[k]
    return out


def mesh_runs(tmp: str, root: str, world: int, smi: str,
              against_eager: bool = False) -> dict:
    """`world` ranks started as torchrun starts them, each on
    cuda:(rank % cards): precompute --mesh with TPU_BREATH_PALLAS_GT=1
    against the single process's cache under root (bit for bit), train
    --mesh cnn8,vgg from that cache and train --fused --mesh cnn8 (bit-equal
    weights on every rank, finite histories, A/B''/C and A/B/C launched in
    every rank). against_eager: each train run again inside graphs.eager(),
    its weights bit-equal to the graphed run's. The backend must be the one
    make_mesh names for this many ranks on this many cards. Returns the
    launches summed over the ranks (the graphed runs) and the step
    times."""
    import shutil

    from tpu_breath_torch.config import Paths
    from tpu_breath_torch.data import dataset as ds

    cards = torch.cuda.device_count()
    backend = "nccl" if world <= cards else "gloo"
    where = (f"{world} ranks on {min(world, cards)} card(s) over {backend}")
    # the inputs under a second root, so that its cache is the mesh's own
    root2 = os.path.join(tmp, f"input_mesh{world}")
    os.makedirs(root2)
    for name in ("train", "test"):
        os.symlink(os.path.join(root, name), os.path.join(root2, name))
    for name in ("train.csv", "test.csv"):
        shutil.copy(os.path.join(root, name), root2)
    common = ["--root", root2, "--device", "cuda", "--mesh", str(world)]
    res = {}
    out = os.path.join(tmp, f"mesh{world}_pre")
    ranks = run_ranks(["precompute", *common, "--out-root", out], out,
                      env={"TPU_BREATH_PALLAS_GT": "1"}, world=world)
    line = f"data-parallel mesh: {world} ranks, {backend}"
    if line not in ranks[0]["log"]:
        raise AssertionError(f"rank 0 did not print {line!r}")
    for r, d in enumerate(ranks):
        if min(d["launches"][k] for k in ("A", "B''", "C")) <= 0:
            raise AssertionError(f"precompute rank {r}: {d['launches']}")
    res["pre_launches"] = [d["launches"] for d in ranks]
    one = ds.FeatureStore.load_cache(Paths(root, tmp).feature_cache)
    two = ds.FeatureStore.load_cache(Paths(root2, tmp).feature_cache)
    if not (list(one.ids) == list(two.ids)
            and _nan_equal(torch.from_numpy(np.array(one.features)),
                           torch.from_numpy(np.array(two.features)))
            and _nan_equal(torch.from_numpy(np.array(one.scalars)),
                           torch.from_numpy(np.array(two.scalars)))):
        raise AssertionError(f"precompute --mesh {world}'s cache differs "
                             "from the single process's")
    log(f"[mesh] precompute --mesh {world} (TPU_BREATH_PALLAS_GT=1), "
        f"{where}: cache of {len(two.ids)} clips bit-equal to the single "
        f"process's; launches by rank {res['pre_launches']}")
    # the cached run takes 6 epochs, so that augmentation (from epoch 5 of
    # CNN8 and 6 of VGG) and its partner all-gather run too
    runs = (("train", ["--archs", "cnn8,vgg"], ["CNN8", "VGG"], 6),
            ("fused", ["--fused", "--archs", "cnn8"], ["CNN8"], 2))
    for name, extra, models, epochs in runs:
        outs = []
        for mode in ("graph", "eager") if against_eager else ("graph",):
            out = os.path.join(tmp, f"mesh{world}_{name}_{mode}")
            t0 = time.perf_counter()
            ranks = run_ranks(["train", *extra, "--epochs", str(epochs),
                               *common, "--out-root", out], out, world=world,
                              mode=mode)
            wall = time.perf_counter() - t0
            outs.append(out)
            same_weights(outs, models, world)
            for arch in [m.lower() for m in models]:
                h = read_history(out, arch)
                if len(h) != epochs or not all(np.isfinite(
                        [r["train_loss"], r["val_loss"]]).all() for r in h):
                    raise AssertionError(f"{name} {arch} history: {h}")
            need = ("A", "B", "C", "E") if name == "fused" else ()
            for r, d in enumerate(ranks):
                if need and min(d["launches"][k] for k in need) <= 0:
                    raise AssertionError(f"{name} rank {r}: {d['launches']}")
            ms = [d["step_ms"] for d in ranks]
            key = name if mode == "graph" else f"{name}_eager"
            res[f"{key}_ms"] = ms
            res[f"{key}_launches"] = [d["launches"] for d in ranks]
            log(f"[mesh] train{' --fused' if name == 'fused' else ''} --mesh "
                f"{world} {','.join(m.lower() for m in models)}, {epochs} "
                f"epochs, global batch 512 ({512 // world} a rank), {where}, "
                f"{mode}: {wall:.2f} s with start-up; every rank's final "
                f"weights bit-equal"
                f"{' (and to the graphed run)' if mode == 'eager' else ''}; "
                f"histories finite; step ms (host clock, each synchronized; "
                f"the first includes a capture where the steps replay) by "
                f"rank {[[(m, round(v, 2)) for m, v in r] for r in ms]} "
                f"({smi}); launches by rank {res[f'{key}_launches']}")
    launches = {k: 0 for k in read_launches()}
    for by_rank in (res["pre_launches"], res["fused_launches"],
                    res["train_launches"]):
        for d in by_rank:
            for k, v in d.items():
                launches[k] += v
    res["launches"] = launches
    return res


def phase_cards(tmp: str, smi: str, cards: int) -> None:
    """--cards N: data parallelism with one rank a card over NCCL, on the
    seeded synthetic dataset: the single process's precompute (kernel B'')
    on card 0; one NCCL rank in this process, cached CNN8 and VGG fit
    (4 epochs, batch 512) with each step timed as the ranks time theirs
    (step_timer); then mesh_runs over N ranks, each train run graphed and
    inside graphs.eager(), bit-equal; and the step times at 1 and N
    ranks side by side."""
    from tpu_breath_torch import cli
    from tpu_breath_torch.config import DEFAULT_FEATURES, Paths
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    root = os.path.join(tmp, "input")
    make_dataset(root)
    with gt_switch():
        run_cli(["precompute", "--root", root, "--out-root", tmp,
                 "--device", "cuda"])
    one = []
    with one_rank() as mesh:
        tr, va, _, y_tr, y_va = cli._prepare_splits(
            Paths(root, tmp), DEFAULT_FEATURES, torch.device("cuda"))
        args = cli.build_parser().parse_args(["train", "--epochs", "4"])
        with step_timer(one):
            for arch in STEP_KEYS:
                loop.fit(registry.build(arch, 36, seed=0),
                         (tr.features, tr.scalars), (va.features,
                                                     va.scalars),
                         y_tr, y_va, cli._arch_cfg(arch, args), mesh=mesh,
                         log_fn=lambda msg: None)
    torch.cuda.empty_cache()
    res = mesh_runs(tmp, root, cards, smi, against_eager=True)

    def replays(ms, arch):  # each fit's first call captures
        times = [v for m, v in ms if m == arch]
        return float(np.median(times[1:]))

    by = {arch: {"1": replays(one, arch),
                 str(cards): [replays(r, arch) for r in res["train_ms"]],
                 f"{cards}_eager": [replays(r, arch)
                                    for r in res["train_eager_ms"]]}
          for arch in ("CNN8", "VGG")}
    log(f"[mesh] cached step ms (host clock, synchronized, median of the "
        f"replays; global batch 512) at 1 NCCL rank vs {cards} (by rank, "
        f"graphed and eager): {by}; {smi}")
    print(json.dumps({"cards": {"device": smi, "step_ms": by}}), flush=True)


def phase_profile(tmp: str) -> None:
    """precompute --profile and train --fused --profile through cli.main on
    cuda; the stages and the top device operations of the fused steps."""
    root = os.path.join(tmp, "input")
    prof = os.path.join(tmp, "profile")
    common = ["--root", root, "--out-root", os.path.join(tmp, "prof_out"),
              "--device", "cuda"]
    with gt_switch():  # the cache's features
        run_cli(["precompute", "--profile", os.path.join(prof, "features"),
                 *common])
        _, dt = run_cli(["train", "--fused", "--archs", "cnn8", "--epochs",
                         "2", "--profile", os.path.join(prof, "train"),
                         *common])
    with open(os.path.join(prof, "features", "feature_stages.json")) as f:
        stages = json.load(f)
    log(f"[profile] feature stages over {stages['n_clips']} clips in chunks "
        f"of {stages['chunk']} ({stages['timer']}), slowest first: "
        + "; ".join(f"{r['stage']} {r['ms_per_chunk']:.3f} ms/chunk"
                    for r in stages["stages"]))
    with open(os.path.join(prof, "train", "train_profile.json")) as f:
        log(f"[profile] train_profile.json {json.load(f)}")
    with open(os.path.join(prof, "train", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = {name: [(e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "gpu_user_annotation"
                    and e.get("name") == name]
             for name in ("train_step", "fused_features")}
    log(f"[profile] trace: {len(events)} events, {len(kernels)} kernels, "
        f"{len(spans['train_step'])} train_step spans on the device "
        f"(train --fused cnn8, 2 epochs: {dt:.2f} s)")
    if not kernels:
        raise AssertionError("the trace holds no device kernel")

    # train --fused cnn8, 2 epochs of 2 steps: the first step runs eagerly
    # (its features in a fused_features range) and is captured, the other
    # three are replays of the step's graph, whose kernels belong to the
    # train_step range of their replay
    # (the eager step's range has a span on each stream it used: the
    # capture stream's warm step and the current stream's copies)
    steps = sorted(spans["train_step"])
    if len(steps) < 4 or len(spans["fused_features"]) != 1:
        raise AssertionError(f"the trace holds {len(steps)} train_step and "
                             f"{len(spans['fused_features'])} fused_features "
                             "spans on the device, not 3 replays after the "
                             "first, eager step (one fused_features span)")

    def inside(e, span):
        return span[0] <= e["ts"] < span[1]

    log(f"[profile] kernels a train_step span: "
        f"{[sum(inside(e, t) for e in kernels) for t in steps]}")
    # a kernel falls in the device span of its innermost range only: the
    # eager step's features' in fused_features, the rest in train_step
    feat = [e for e in kernels if inside(e, spans["fused_features"][0])]
    eager = [e for e in kernels if inside(e, spans["fused_features"][0])
             or any(inside(e, t) for t in steps[:-3])]
    replays = [[e for e in kernels if inside(e, t)] for t in steps[-3:]]
    counts = [len(ks) for ks in replays]
    if len(set(counts)) != 1 or counts[0] < len(eager) // 2:
        raise AssertionError(f"kernels in the replayed steps' ranges "
                             f"{counts}, in the eager step {len(eager)}")
    total = sum(e["dur"] for ks in replays for e in ks)
    span_us = sum(max(e["ts"] + e["dur"] for e in ks)
                  - min(e["ts"] for e in ks) for ks in replays)
    n = len(replays)
    log(f"[profile] the {n} replayed fused steps: {total / 1e3 / n:.2f} ms "
        f"of device time and {counts[0]} kernels a step, a step spans "
        f"{span_us / 1e3 / n:.2f} ms on the device, busy "
        f"{total / span_us:.1%}; the eager first step: {len(eager)} "
        f"kernels, {len(feat)} of them its features' "
        f"({sum(e['dur'] for e in feat) / 1e3:.2f} ms)")
    flat = [e for ks in replays for e in ks]
    by_name: dict = {}
    for e in flat:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   step {us / max(total, 1e-9):6.1%} of the step "
            f"{us / 1e3 / n:8.3f} ms/step  {name[:100]}")
    # the path's kernels of this port, by the name of their __global__
    for k, fn in (("A", "tuning_tail_kernel"), ("B''", "gammatone_kernel"),
                  ("C", "suppress_kernel")):
        mine = [e for e in flat if fn in e["name"]]
        us = sum(e["dur"] for e in mine)
        log(f"[profile]   kernel {k}: {us / max(total, 1e-9):.2%} of the "
            f"step, {us / 1e3 / n:.3f} ms/step in "
            f"{len(mine) / n:.0f} launches/step")
        if not mine:
            raise AssertionError(f"kernel {k} is not in the replayed steps")


def quiet(fn, *args):
    """fn(*args) with its stdout captured; (result, captured text)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue()


def phase_tools(tmp: str, smi: str) -> dict:
    """The port's tools (tpu_breath_torch/utils) on the card: (a) the
    feature roofline at its defaults, its report printed as {"roofline":
    ...}: every share in (0, 1.05] (a FLOP share exactly 0 where a stage
    counts no FLOPs), every bound one of the three, each stage's bytes and
    kernel calls at B = 8 the same counted on the card as on the CPU, A,
    C, E and B or B'' launched;
    (b) seed_sweep (cnn8, seeds 0 and 1, cached and fused, 2 epochs) on
    phase 6's dataset, then summarize on its directory: the two summaries
    agree on every key both hold; (c) ensemble_val on phase 6's CNN8 and
    VGG checkpoints: weights summing to 1, every metric in [0, 1]; (d)
    deviation_sweep (8 resampled clips) on phase 6's dataset, folded into a
    parity sweep (64 seeded clips, 16 through the oracle) by --deviations,
    inside the envelope; (e) find_flips on the parity phase's 512 clips:
    the flip count, and each flip's diagnose(). Returns the launches."""
    from tpu_breath_torch import cli
    from tpu_breath_torch.train import checkpoint as ckpt_lib
    from tpu_breath_torch.utils import (deviation_sweep, ensemble_val,
                                        feature_roofline, flip_hunt,
                                        parity_sweep, profiling, seed_sweep)

    root = os.path.join(tmp, "input")
    times = {}
    reset_launches()
    t_phase = t0 = time.perf_counter()
    # (a) the roofline
    report, _ = quiet(feature_roofline.main, [])
    times["roofline"] = time.perf_counter() - t0
    launches = read_launches()
    print(json.dumps({"roofline": report}), flush=True)
    stages = report["stages"]
    bad = [(name, k, row[k]) for name, row in stages.items()
           for k in ("flop_frac", "hbm_frac")
           if not (0 < row[k] <= 1.05 or (k == "flop_frac"
                                          and row["flops_per_chunk"] == 0
                                          and row[k] == 0))]
    bad += [(name, "bound", row["bound"]) for name, row in stages.items()
            if row["bound"] not in feature_roofline.BOUNDS]
    y = torch.from_numpy(clips(MICRO))
    for name, fn in profiling.feature_stages().items():
        on_card, on_cpu = (feature_roofline.count(fn, v)
                           for v in (y.cuda(), y))
        for k in ("bytes", "kernel_calls"):
            if on_card[k] != on_cpu[k]:
                bad.append((name, f"{k} card != cpu", (on_card[k],
                                                       on_cpu[k])))
    log(f"[tools] (a) roofline, {report['n_clips']} clips in chunks of "
        f"{report['chunk']} ({report['timer']}; {report['device']}): "
        + "; ".join(f"{n} {r['wall_ms']:.2f} ms, flop {r['flop_frac']:.3g},"
                    f" op traffic {r['hbm_frac']:.3g}, {r['bound']}"
                    for n, r in stages.items())
        + f"; bytes and kernel calls at B = {MICRO} the same on the card as "
        f"on the CPU; {times['roofline']:.1f} s")
    if bad:
        raise AssertionError(f"roofline out of range: {bad}")
    if min(launches["A"], launches["C"], launches["E"],
           max(launches["B"], launches["B''"])) <= 0:
        raise AssertionError(f"roofline: a kernel was not launched: "
                             f"{launches}")

    # (b) the seed sweep and its summary
    t0 = time.perf_counter()
    sweep_dir = os.path.join(tmp, "sweep")
    sweep, text = quiet(seed_sweep.main, [
        "--archs", "cnn8", "--seeds", "0,1", "--modes", "cached,fused",
        "--epochs", "2", "--root", root, "--out", sweep_dir, "--device",
        "cuda"])
    for line in text.splitlines():
        if line.startswith("[sweep]"):
            log(f"[tools]   {line}")
    summary, _ = quiet(seed_sweep.main, ["summarize", "--dir", sweep_dir])
    times["seed_sweep"] = time.perf_counter() - t0
    diff = seed_sweep.disagreements(sweep, summary)
    log(f"[tools] (b) seed_sweep cnn8 x seeds 0,1 x cached,fused, 2 epochs "
        f"({times['seed_sweep']:.1f} s): "
        + "; ".join(f"{k} val acc mean {v['val_acc_mean']:.4f} over "
                    f"{v['n_seeds']} seeds" for k, v in sweep.items())
        + f"; summarize agrees on every shared key: {not diff}")
    if diff or set(sweep) != {"cached_cnn8", "fused_cnn8"} or any(
            v["n_seeds"] != 2 for v in summary.values()):
        raise AssertionError(f"seed sweep: {sorted(sweep)}, {diff}")

    # (c) ensemble validation on phase 6's checkpoints
    t0 = time.perf_counter()
    e2e_out = os.path.join(tmp, "e2e")
    argv = [x for arch in ("cnn8", "vgg") for x in (
        "--ckpt", f"{arch}="
        f"{ckpt_lib.latest_checkpoint(cli.ckpt_dir(e2e_out, arch))}")]
    ens, _ = quiet(ensemble_val.main, [*argv, "--root", root, "--device",
                                       "cuda"])
    times["ensemble_val"] = time.perf_counter() - t0
    metrics = [v for part in (*ens["members"].values(),
                              ens["weighted_ensemble"],
                              ens["average_ensemble"]) for v in part.values()]
    log(f"[tools] (c) ensemble_val on {ens['val_n']} val clips "
        f"({times['ensemble_val']:.1f} s): members {ens['members']}; "
        f"weights {ens['weights_softmax']}; weighted "
        f"{ens['weighted_ensemble']}; average {ens['average_ensemble']}")
    if not (abs(sum(ens["weights_softmax"]) - 1) <= 1e-5
            and all(0 <= v <= 1 for v in metrics)):
        raise AssertionError(f"ensemble_val out of range: {ens}")

    # (d) the deviation sweep, folded into a parity sweep
    t0 = time.perf_counter()
    dev_path = os.path.join(tmp, "deviations.json")
    dev, _ = quiet(deviation_sweep.main, ["--root", root, "--n-resample",
                                          "8", "--device", "cuda", "--out",
                                          dev_path])
    rep_path = os.path.join(tmp, "parity_dev.json")
    rc, _ = quiet(parity_sweep.main, [
        "--root", os.path.join(tmp, "no_dataset"), "--n-clips", "64",
        "--n-oracle", "16", "--device", "cuda", "--deviations", dev_path,
        "--out", rep_path])
    with open(rep_path) as f:
        folded = json.load(f)["documented_deviations"]
    times["deviation_sweep"] = time.perf_counter() - t0
    log(f"[tools] (d) deviation_sweep on {dev['n_clips_total']} clips "
        f"({times['deviation_sweep']:.1f} s): peak ties "
        f"{dev['peak_tie']}; resampler {dev['resampler_chroma_channel']}; "
        f"folded into the parity sweep's documented_deviations: "
        f"{folded == dev}, the sweep's exit code {rc}")
    if rc != 0 or folded != dev:
        raise AssertionError(f"parity sweep with --deviations: rc {rc}, "
                             f"folded {folded == dev}")

    # (e) the flip hunt on the parity phase's clips
    t0 = time.perf_counter()
    wavs, ids, _ = parity_sweep.seeded_clips(512, seed=0)
    flips, _ = quiet(flip_hunt.find_flips, wavs, ids, "cuda")
    times["flip_hunt"] = time.perf_counter() - t0
    log(f"[tools] (e) find_flips on {len(flip_hunt.sample_indices(512))} of "
        f"the parity phase's clips ({times['flip_hunt']:.1f} s): "
        f"{len(flips)} flips")
    for flip in flips:
        diag = flip_hunt.diagnose(wavs[flip["index"]], "cuda")
        log(f"[tools]   {flip}: {json.dumps(diag)}")

    launches = read_launches()
    seconds = time.perf_counter() - t_phase
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
    log(f"[tools] phase {seconds:.1f} s ({parts}); launches {launches}; "
        f"{smi}")
    return {"launches": launches, "seconds": seconds}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=0, metavar="N",
                    help="only the environment, the build and data "
                         "parallelism across N cards, one rank a card over "
                         "NCCL (mesh_runs); needs N cards")
    args = ap.parse_args(argv)
    env = phase_env()
    phase_build()
    if args.cards:
        if torch.cuda.device_count() < args.cards:
            raise SystemExit(f"chip_smoke: --cards {args.cards} but "
                             f"{torch.cuda.device_count()} card(s)")
        with tempfile.TemporaryDirectory() as tmp:
            phase_cards(tmp, env["smi"], args.cards)
        print(env["smi"])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    ker = phase_kernels()
    phase_features()
    phase_graphs(env["smi"])
    steps = phase_steps(env["smi"])
    parity = phase_parity(env["smi"])
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(tmp)
        e2e = phase_e2e(tmp, phase_decode(tmp, env["smi"]))
        repro = phase_repro(tmp, e2e)
        fused = phase_fused(tmp)
        mesh = phase_mesh(tmp, env["smi"])
        phase_profile(tmp)
        tools = phase_tools(tmp, env["smi"])
    src = "tpu_breath_torch/csrc"
    pallas = "tpu_breath/ops/pallas"
    table = [
        ("A", "tuning_index", "tuning_kernel.cu", "tuning_kernel.py:125"),
        ("B", "fused_epilogue", "epilogue_kernel.cu",
         "epilogue_kernel.py:160"),
        ("B'", "fused_epilogue_f32", "epilogue_kernel.cu",
         "epilogue_kernel.py:160"),
        ("B''", "fused_gammatone", "gammatone_kernel.cu",
         "epilogue_kernel.py:126"),
        ("C", "suppress_peaks", "peaks_kernel.cu", "peaks_kernel.py:78"),
        ("D", "cqt_mag", "cqt_kernel.cu", "cqt_kernel.py:98"),
        ("E", "burg_lpc", "lpc_kernel.cu", None),
    ]
    # launches: each path counted from 0 just before it runs; times at the
    # precompute chunk (B = 128). No single PyTorch call computes A-C or
    # E; D's library time is conv1d's (its complex response, no |.|). E
    # replaces no TPU kernel (the JAX package leaves lpc to XLA)
    paths = {"steps": steps["launches"], "serve": serve["launches"],
             "e2e": e2e["launches"], "repro": repro["launches"],
             "fused": fused["launches"], "mesh": mesh["launches"],
             "parity": parity["launches"], "tools": tools["launches"]}
    kernels = [{"name": name, "route": "cuda", "source": f"{src}/{f}",
                "replaces": rep and f"{pallas}/{rep}",
                "launches": sum(p[k] for p in paths.values()),
                "launches_by_path": {n: p[k] for n, p in paths.items()},
                "max_abs_err": ker[k]["err"], "ms": ker[k][CHUNK]["ms"],
                "plain_ms": ker[k][CHUNK]["plain_ms"],
                "primed_ms": ker[k][CHUNK]["primed_ms"],
                "bound_ms": ker["bound", CHUNK][k][0],
                "bound_by": ker["bound", CHUNK][k][1],
                "library_ms": ker.get(("D", "library", CHUNK)) if k == "D"
                else None,
                "batch": CHUNK}
               for k, name, f, rep in table]
    print(env["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
