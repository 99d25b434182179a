"""Chip smoke test of the PyTorch/CUDA port (tpu_breath_torch) on the GPU.

    python3 chip_smoke.py              # one card, every phase below
    python3 chip_smoke.py --cards 4    # data parallelism across 4 cards

Phases (each raises on failure; the script then exits non-zero and prints
no result line):
  1. environment: torch/CUDA versions, the card's name and power limit;
     fails without a CUDA device;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel,
     sm_90a) and print the time;
  3. each kernel (A, B, B', B'', C, D) against its plain PyTorch version on
     the card, at the main path's shapes with B = 8 and B = 128 (golden wavs
     + seeded noise, silence, an impulse, quantized plateaus), with times
     on both timers (the table's and a primed stream's) and the least time
     the card could take (bound); B's, B''s, B'''s and D's rows of the
     clips both sizes share must be bit-equal; C also on the dense worst
     case (a candidate every other sample) and on rows of 40,000 samples
     (its list then in device memory), exactly; D, on no path (as in the
     JAX package), at the shapes of its function, beside conv1d; then the
     kernels past their main-path tiles (check_past_tiles): B, B', B''
     at larger T, F, G and K, B'' at B = 65,537, A past 28,000 pairs a
     clip and D at 100,000 samples;
  4. extract_features on the card for the golden wavs, against the golden
     npz and the port's CPU result; with fused_gt (kernel B'') against the
     default path;
  parity. the parity sweep (utils/parity_sweep.py) on 512 seeded clips
     (the golden wavs and shifts of them at seeded gains, silence, an
     impulse, quantized plateaus, noise), 128 of them through the port's
     NumPy oracle in spawned processes: run with kernel B and with B''
     (fused_gt) against one oracle run; each holds the NaN masks equal, the
     real clips with no tuning flip inside PARITY.md's envelope (every
     channel <= 2.3e-4 abs, scalars <= 6.9e-4 rel, floor 1e-2) and no flip
     wider than one count (tie width <= 1); A, B, B'', C must launch;
  5. serve: seeded CNN8 checkpoint, `predict --from-wav --archs cnn8` through
     cli.main on cuda; kernels A, B, C must launch;
  6. e2e on a seeded synthetic dataset (1,280 labelled clips -> 1,024 train /
     256 val, 256 test) through cli.main on cuda: precompute with
     TPU_BREATH_PALLAS_GT=1, train --archs cnn8,vgg --epochs 6 --predict
     (full width, batch 512), train --archs cnn8 --epochs 7 --resume,
     predict from the cache and predict --from-wav; kernels A, B, B'', C
     must launch;
  repro. same seed, same history, with every cuDNN flag at its default
     (fit's own reproducible scope), on phase 6's dataset and cache: train
     cnn8,vgg 6 epochs again equals phase 6 bit for bit; train --fused
     cnn8,vgg twice, equal; a 7-epoch cnn8 run stopped at its 4th epoch
     line and resumed equals an uninterrupted one; --seed 1 differs from
     seed 0; A/B''/C launched 384/192/192 times; then scope_cost: the
     bench's split pieces (fwd, grad, cached and fused steps, batch 512)
     timed with and without loop.reproducible() in turns, printed as
     {"scope_cost": ...};
  7. fused: the features inside one fused step against the cache's rows
     (equal), then train --archs cnn8,vgg --epochs 6 from the cache and
     train --fused ... --predict with TPU_BREATH_PALLAS_GT=1, cuDNN flags
     at their defaults: equal histories, A/B''/C launched 192/96/96
     times, a submission;
  mesh. data parallelism (parallel/mesh.py): fit's streaming path on one
     NCCL rank against the resident path (cached CNN8, batch 512, 2
     epochs, f32: train accuracy equal, losses within 1e-3) and a warm
     streamed step under the sync check; then two ranks sharing the card
     over gloo, started as torchrun starts them: precompute --mesh 2
     (TPU_BREATH_PALLAS_GT=1) gives phase 6's cache bit for bit, train
     --mesh 2 cnn8,vgg (6 epochs, augmentation from the 5th) and train
     --fused --mesh 2 cnn8 (2 epochs, kernel B) end with
     bit-equal weights on both ranks; A, B'', C and A, B, C launch in each
     rank; ms per step on the host clock;
  8. profile: precompute --profile (stages, slowest first) and train
     --fused --archs cnn8 --epochs 2 --profile (the top device operations
     of the fused steps, from the trace);
  bench. the port's bench (tpu_breath_torch/bench.py) at its defaults
     (2,048 seeded clips, chunk 128, batch 512, 8 steps, 24 oracle clips,
     5 repeats): its line printed as {"bench": ...}; every rate and latency
     finite and positive, every MFU in (0, 1], the fused CNN8 step's
     clips/s at most the feature graph's alone; A, C and B launched;
  tools. the port's tools (tpu_breath_torch/utils): the feature roofline
     at its defaults (2,048 seeded clips, chunks of 128), its report printed
     as {"roofline": ...}: shares in (0, 1.05], known bounds, `full`'s
     FLOPs the bench's count, bytes counted alike on the card and the CPU,
     A, C and B launched; seed_sweep (cnn8, seeds 0 and 1, cached and
     fused, 2 epochs) on phase 6's dataset and summarize, agreeing;
     ensemble_val on phase 6's checkpoints; deviation_sweep folded into a
     parity sweep by --deviations; find_flips on the parity phase's clips;
  9. timings: extract_features (B = 8 / 128), one serve call and the
     serve micro-batch's median and p90 over 40 calls, one train step of
     CNN8 and of VGG at batch 512 (CUDA events), cached and fused
     (features and model apart), epoch wall times and precompute clips/s;
 10. the kernels JSON line (launches by path: serve, e2e, repro, fused,
     mesh, parity, bench, tools), then the last line: {"ok": true,
     "device": {...}}.

With --cards N (N cards): phases 1 and 2, then the seeded dataset's
precompute in one process and mesh_runs over N ranks, one a card over
NCCL: precompute --mesh N bit-equal to it, train --mesh N cnn8,vgg and
train --fused --mesh N cnn8 with bit-equal weights on every rank; then the
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
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

from tpu_breath_torch.ops.cuda import work as work_lib
from tpu_breath_torch.utils.kernel_times import calls as kernel_calls
from tpu_breath_torch.utils.kernel_times import (clip_set, cqt_args, cuda_ms,
                                                 dense_scores, golden,
                                                 kernel_inputs)

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 16000
MICRO = 8
CHUNK = 128
# kernel -> max abs err against its plain version: the JAX package's test
# tolerances (tests/test_pallas_epilogue.py), 1e-5 for the float64
# variants, 5e-5 for the f32 one
TOLS = {"B": 1e-5, "B'": 5e-5, "B''": 1e-5}
# kernel D: max|a - b| / max|b| against its plain version (float64), the
# JAX package's tests/test_pallas_cqt.py bound
TOL_D = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


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
    }
    return {name: w.bound_ms() for name, w in work.items()}


def phase_kernels() -> dict:
    """Kernel vs plain on the card; returns errors and times per kernel."""
    import scipy.signal
    from tpu_breath_torch.ops import dft
    from tpu_breath_torch.ops.cuda import epilogue_kernel as ek

    rounds = SR // (SR // 10) + 2
    res = {k: {"err": 0.0}
           for k in ("A", "B", "B'", "B''", "C", "C dense", "D")}
    n_shared = len(golden()) + 2  # clip_set's first clips at every size
    gt_rows, cqt_rows, mags = {}, {}, {}
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
        log(f"[kernels] B={b}: A exact at bpo 12/36, "
            + ", ".join(f"{k} err {errs[k]:.3g} (tol {t:g})"
                        for k, t in TOLS.items())
            + f", C kept exact (= scipy counts), vals err {err_c:.3g}, "
            f"D max|a-b|/max|b| {rel_d:.3g} (tol {TOL_D:g})")
        (vals, kept), (rvals, rkept) = out["C dense"]
        if not (torch.equal(kept, rkept) and torch.equal(vals, rvals)):
            raise AssertionError(f"kernel C dense B {b}: differs from its "
                                 "plain version")
        res["bound", b]["C dense"] = bounds({**x, "scores": dense},
                                            rounds)["C"]
        log(f"[kernels] B={b}: C on the dense worst case (8,000 candidates "
            f"a clip, {int(kept.sum())} kept) equals its plain version")
        for k, (run, plain) in calls.items():
            res[k][b] = (cuda_ms(run), cuda_ms(plain),
                         cuda_ms(run, primed=True),
                         cuda_ms(plain, primed=True))
            bound, by = res["bound", b][k]
            log(f"[time] kernel {k} B={b}: {res[k][b][0]:.4f} ms, plain "
                f"{res[k][b][1]:.4f} ms, bound {bound:.4f} ms ({by}); "
                f"stream primed: {res[k][b][2]:.4f} ms, plain "
                f"{res[k][b][3]:.4f} ms")
        res["D", "library", b] = cuda_ms(cqt_conv1d(y))
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


def phase_parity(smi: str) -> dict:
    """The parity sweep on the card against the port's oracle, kernel B
    and kernel B'' (see the module docstring). Returns the phase's
    launches."""
    from tpu_breath_torch.utils import parity_sweep

    wavs, ids, synthetic = parity_sweep.seeded_clips(512, seed=0)
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
    if any(misses.values()):
        raise AssertionError(f"parity sweep misses the envelope: {misses}")
    if min(launches[k] for k in ("A", "B", "B''", "C")) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return {"launches": launches}


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
    if min(launches[k] for k in ("A", "B", "C")) <= 0:
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
    return {"launches": launches, "ckpt": ckpt, "wavs": wavs}


def launch_counters() -> dict:
    """kernel -> (wrapper module, name of its launch counter)."""
    from tpu_breath_torch.ops.cuda import (cqt_kernel, epilogue_kernel,
                                           gammatone_kernel, peaks_kernel,
                                           tuning_kernel)
    return {"A": (tuning_kernel, "LAUNCHES"),
            "B": (epilogue_kernel, "LAUNCHES"),
            "B'": (epilogue_kernel, "LAUNCHES_F32"),
            "B''": (gammatone_kernel, "LAUNCHES"),
            "C": (peaks_kernel, "LAUNCHES"),
            "D": (cqt_kernel, "LAUNCHES")}


def reset_launches() -> None:
    for mod, name in launch_counters().values():
        setattr(mod, name, 0)


def read_launches() -> dict:
    return {k: getattr(mod, name)
            for k, (mod, name) in launch_counters().items()}


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


def phase_e2e(tmp: str) -> dict:
    """precompute (B'') -> train cnn8,vgg -> resume -> predict (cache and
    --from-wav) through cli.main on cuda, at full width and the configs'
    batch 512."""
    from tpu_breath_torch import cli, ensemble
    from tpu_breath_torch.config import Paths
    from tpu_breath_torch.data import dataset as ds
    from tpu_breath_torch.train import checkpoint as ckpt_lib

    root, out_root = os.path.join(tmp, "input"), os.path.join(tmp, "e2e")
    test_paths = make_dataset(root)
    common = ["--root", root, "--out-root", out_root, "--device", "cuda"]
    res = {}
    reset_launches()
    with gt_switch():
        out, dt = run_cli(["precompute", *common])
    res["precompute_s"] = dt
    res["precompute_line"] = next(l for l in out.splitlines()
                                  if l.startswith("features:"))
    after_pre = read_launches()
    if after_pre["B''"] <= 0 or after_pre["B"] != 0:
        raise AssertionError(f"precompute with TPU_BREATH_PALLAS_GT=1 did "
                             f"not take kernel B'': {after_pre}")

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
    for arch in ("cnn8", "vgg"):
        log(f"[e2e] {arch} val acc by epoch "
            f"{[round(r['val_acc'], 4) for r in res[arch]]}")
    return res


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
    want = {"A": 384, "B": 0, "B'": 0, "B''": 192, "C": 192, "D": 0}
    seconds = time.perf_counter() - t0
    log(f"[repro] launches {launches} (expected {want}: 2 fused runs); "
        f"phase {seconds:.1f} s")
    if failed:
        raise AssertionError(f"repro: {failed}")
    if launches != want:
        raise AssertionError("repro launches differ from the expected")
    return {"launches": launches}


def scope_cost(smi: str) -> None:
    """What fit's reproducible scope costs a step, on the bench's split
    (bench.split_pieces) at batch 512 on bench.noise clips, CNN8 and VGG:
    fwd, grad (fwd + bwd), the cached and the fused step, each ms a launch
    by CUDA events (bench.event_ms: mean of 8 launches, 3 rounds), timed
    without the scope and with it in turns (without, with, with, without).
    Printed as {"scope_cost": ...}: per piece the medians, on / off and
    the runs; bwd = grad - fwd. Measures; checks nothing."""
    from tpu_breath_torch import bench
    from tpu_breath_torch.config import CNN8_TRAIN, DEFAULT_FEATURES, VGG_TRAIN
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    b, names = bench.TRAIN_BATCH, ("fwd", "grad", "cached", "fused")
    w = torch.from_numpy(bench.noise(b)).to(dev)
    y = (torch.arange(b, device=dev) % 2).float()
    res = {"device": smi, "batch": b}
    for arch, cfg in (("cnn8", CNN8_TRAIN), ("vgg", VGG_TRAIN)):
        cfg = dataclasses.replace(cfg, batch_size=b)
        model = registry.build(arch, DEFAULT_FEATURES.n_scalars).to(dev)
        pieces = bench.split_pieces(
            model, loop.make_optimizer(model, cfg), cfg, DEFAULT_FEATURES,
            w, y, 1e-4, torch.Generator(device=dev).manual_seed(1))
        model.train()
        runs = {k: {"off": [], "on": []} for k in names}
        for on in (False, True, True, False):
            with loop.reproducible() if on else contextlib.nullcontext():
                for k in names:
                    runs[k]["on" if on else "off"] += bench.event_ms(
                        pieces[k], bench.TRAIN_STEPS, bench.SPLIT_ROUNDS,
                        dev)
        med = {k: {s: float(np.median(r[s])) for s in r}
               for k, r in runs.items()}
        med["bwd"] = {s: med["grad"][s] - med["fwd"][s] for s in ("off", "on")}
        res[arch] = {k: {"off_ms": m["off"], "on_ms": m["on"],
                         "on_over_off": m["on"] / m["off"],
                         **({"runs": runs[k]} if k in runs else {})}
                     for k, m in med.items()}
        log(f"[repro] scope cost, {arch} batch {b} (ms, without -> with): "
            + "; ".join(f"{k} {m['off']:.2f} -> {m['on']:.2f}"
                        for k, m in med.items()) + f" ({smi})")
        del model, pieces
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps({"scope_cost": res}), flush=True)


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
    want = {"A": 192, "B": 0, "B'": 0, "B''": 96, "C": 96, "D": 0}
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
            f"{[round(r['val_acc'], 4) for r in hf]}")
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


# One rank of a data-parallel CLI run (phase_mesh): cli.main(argv) with the
# launcher's environment; writes {"launches", "step_ms"} (the kernels'
# launches and each train step's host time, synchronized) and each fit's
# final state_dict to OUT.
RANK_CODE = """
import json, os, sys, time
import torch
import chip_smoke
from tpu_breath_torch import cli
from tpu_breath_torch.train import loop
out, argv = sys.argv[1], sys.argv[2:]
rank = os.environ["RANK"]
fit, step, step_ms = loop.fit, loop.train_step, []
def timed_step(*a, **k):
    t0 = time.perf_counter()
    r = step(*a, **k)
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - t0) * 1e3)
    return r
def fit_and_keep(model, *a, **k):
    r = fit(model, *a, **k)
    torch.save(r.model.state_dict(),
               os.path.join(out, type(model).__name__ + "_rank" + rank + ".pt"))
    return r
loop.fit, loop.train_step = fit_and_keep, timed_step
chip_smoke.reset_launches()
cli.main(argv)
with open(os.path.join(out, "rank" + rank + ".json"), "w") as f:
    json.dump({"launches": chip_smoke.read_launches(), "step_ms": step_ms}, f)
"""


def free_port() -> int:
    """A free TCP port on this host, for a process group's rendezvous."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def run_ranks(argv: list[str], out: str, env: dict | None = None,
              world: int = 2) -> list[dict]:
    """`world` processes of RANK_CODE on this card, started as torchrun
    starts them (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), each running cli.main(argv); every process
    is waited for. Returns each rank's {"launches", "step_ms", "log"};
    raises if a rank fails."""
    os.makedirs(out, exist_ok=True)
    port = free_port()
    procs = []
    for rank in range(world):
        penv = {**os.environ, **(env or {}), "RANK": str(rank),
                "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(port), "PYTHONPATH": ROOT}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CODE, out, *argv], env=penv,
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


def same_weights(out: str, names: list[str], world: int = 2) -> None:
    """Every rank's final weights of each model in names are bit-equal."""
    for name in names:
        sds = [torch.load(os.path.join(out, f"{name}_rank{r}.pt"),
                          map_location="cpu") for r in range(world)]
        for r, sd in enumerate(sds[1:], 1):
            bad = [k for k, v in sds[0].items() if not torch.equal(v, sd[k])]
            if bad:
                raise AssertionError(f"{name}: rank {r}'s weights differ "
                                     f"from rank 0's: {bad[:5]}")


def phase_mesh(tmp: str, smi: str) -> dict:
    """Data parallelism (parallel/mesh.py) on this card. (i) The streaming
    path of fit(mesh=...) on one NCCL rank, cached CNN8, batch 512, 2
    epochs, f32: its history matches the resident
    path's (train accuracy equal, losses within 1e-3), and a warm streamed
    step raises nothing under torch.cuda.set_sync_debug_mode("error").
    (ii) Two ranks sharing the card over gloo, started as torchrun would:
    precompute --mesh 2 with TPU_BREATH_PALLAS_GT=1 gives phase 6's cache
    bit for bit; train --mesh 2 cnn8,vgg (cached, 6 epochs: augmentation
    and its partner gather from epoch 5) and train --fused --mesh 2 cnn8
    (2 epochs, kernel B) end with bit-equal weights on both ranks and finite
    histories; A, B'', C (precompute) and A, B, C (fused) launch in each
    rank (mesh_runs). Returns the launches summed over the ranks."""
    import torch.distributed as dist

    from tpu_breath_torch import augment, cli
    from tpu_breath_torch.config import CNN8_TRAIN, DEFAULT_FEATURES, Paths
    from tpu_breath_torch.data import loader
    from tpu_breath_torch.models import layers, registry
    from tpu_breath_torch.parallel import mesh as mesh_lib
    from tpu_breath_torch.train import loop

    root = os.path.join(tmp, "input")
    res = {}
    # (i) one NCCL rank, in this process
    os.environ.update({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(free_port())})
    try:
        mesh = mesh_lib.make_mesh("cuda")
        log(f"[mesh] (i) {mesh_lib.describe(mesh)}")
        if mesh.backend != "nccl":
            raise AssertionError(f"one rank a card should be nccl: {mesh}")
        tr, va, _, y_tr, y_va = cli._prepare_splits(
            Paths(root, tmp), DEFAULT_FEATURES, torch.device("cuda"))
        cfg = dataclasses.replace(CNN8_TRAIN, num_epochs=2)
        torch.backends.cudnn.allow_tf32 = False
        hist, step_ms = {}, []
        try:
            for name, m in (("resident", None), ("streaming", mesh)):
                model = registry.build("cnn8", 36, seed=cfg.seed, bf16=False)
                t0 = time.perf_counter()
                hist[name] = loop.fit(
                    model, (tr.features, tr.scalars), (va.features,
                                                       va.scalars),
                    y_tr, y_va, cfg, device="cuda", mesh=m,
                    log_fn=lambda msg: None).history
                torch.cuda.synchronize()
                log(f"[mesh] (i) {name} fit, 2 epochs: "
                    f"{time.perf_counter() - t0:.2f} s; train loss "
                    f"{[r['train_loss'] for r in hist[name]]}, acc "
                    f"{[r['train_acc'] for r in hist[name]]}")
            # a warm streamed step under the sync check
            model = registry.build("cnn8", 36, seed=cfg.seed,
                                   bf16=False).cuda()
            opt = loop.make_optimizer(model, cfg)
            host = [np.ascontiguousarray(tr.features, np.float32),
                    np.ascontiguousarray(tr.scalars, np.float32),
                    np.asarray(y_tr, np.float32)]
            stream = iter(loader.stream_batches(
                host, cfg.batch_size, np.random.default_rng(0),
                device=mesh.device))
            gen = torch.Generator(device="cuda").manual_seed(0)
            layers.set_mesh(model, mesh)

            def streamed_step():
                f, sc, y = next(stream)
                d = augment.draw(gen, cfg.batch_size, 128, 63,
                                 cfg.cutmix_alpha, cfg.mixup_alpha, "cuda")
                return loop.train_step(model, opt, 1e-4,
                                       augment.Batch(f, sc, y), cfg, d, mesh)

            streamed_step()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                streamed_step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            layers.set_mesh(model, None)
            stream = iter(loader.stream_batches(
                host, cfg.batch_size, np.random.default_rng(1),
                device=mesh.device))
            layers.set_mesh(model, mesh)
            for _ in range(2):
                t0 = time.perf_counter()
                streamed_step()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            layers.set_mesh(model, None)
        finally:
            torch.backends.cudnn.allow_tf32 = True
        dl = max(abs(a[k] - b[k]) for a, b in zip(hist["resident"],
                                                   hist["streaming"])
                 for k in ("train_loss", "val_loss"))
        same_acc = all(a["train_acc"] == b["train_acc"]
                       for a, b in zip(hist["resident"], hist["streaming"]))
        log(f"[mesh] (i) streaming vs resident history: max |loss diff| "
            f"{dl:.3g} (bound 1e-3), train acc equal {same_acc}; a warm "
            f"streamed step raised nothing under sync debug mode 'error'; "
            f"streamed step (1 NCCL rank, CNN8 f32, batch 512, host clock) "
            f"{', '.join(f'{m:.2f}' for m in step_ms)} ms ({smi})")
        if not (len(hist["streaming"]) == 2 and dl < 1e-3 and same_acc):
            raise AssertionError("streaming fit differs from the resident")
        res["stream_ms"] = step_ms
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)

    # (ii) two ranks sharing the card over gloo
    res.update(mesh_runs(tmp, root, 2, smi))
    return res


def mesh_runs(tmp: str, root: str, world: int, smi: str) -> dict:
    """`world` ranks started as torchrun starts them, each on
    cuda:(rank % cards): precompute --mesh with TPU_BREATH_PALLAS_GT=1
    against the single process's cache under root (bit for bit), train
    --mesh cnn8,vgg from that cache and train --fused --mesh cnn8 (bit-equal
    weights on every rank, finite histories, A/B''/C and A/B/C launched in
    every rank). The backend must be the one make_mesh names for this many
    ranks on this many cards. Returns the launches summed over the ranks
    and the step times."""
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
        out = os.path.join(tmp, f"mesh{world}_{name}")
        t0 = time.perf_counter()
        ranks = run_ranks(["train", *extra, "--epochs", str(epochs),
                           *common, "--out-root", out], out, world=world)
        wall = time.perf_counter() - t0
        same_weights(out, models, world)
        for arch in [m.lower() for m in models]:
            h = read_history(out, arch)
            if len(h) != epochs or not all(np.isfinite(
                    [r["train_loss"], r["val_loss"]]).all() for r in h):
                raise AssertionError(f"{name} {arch} history: {h}")
        need = ("A", "B", "C") if name == "fused" else ()
        for r, d in enumerate(ranks):
            if need and min(d["launches"][k] for k in need) <= 0:
                raise AssertionError(f"{name} rank {r}: {d['launches']}")
        ms = [d["step_ms"] for d in ranks]
        res[f"{name}_ms"] = ms
        res[f"{name}_launches"] = [d["launches"] for d in ranks]
        log(f"[mesh] train{' --fused' if name == 'fused' else ''} --mesh "
            f"{world} {','.join(m.lower() for m in models)}, {epochs} "
            f"epochs, global batch 512 ({512 // world} a rank), {where}: "
            f"{wall:.2f} s with start-up; every rank's final weights "
            f"bit-equal; histories finite; step ms (host clock, each "
            f"synchronized) by rank "
            f"{[[round(v, 2) for v in m] for m in ms]} ({smi}); launches "
            f"by rank {res[f'{name}_launches']}")
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
    on card 0, then mesh_runs over N ranks."""
    root = os.path.join(tmp, "input")
    make_dataset(root)
    with gt_switch():
        run_cli(["precompute", "--root", root, "--out-root", tmp,
                 "--device", "cuda"])
    mesh_runs(tmp, root, cards, smi)


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

    n_steps = len(spans["train_step"])
    if not n_steps or len(spans["fused_features"]) != n_steps:
        raise AssertionError(f"the trace holds {n_steps} train_step and "
                             f"{len(spans['fused_features'])} fused_features "
                             "spans on the device: the steps cannot be told "
                             "apart")

    def inside(e, name):
        return any(a <= e["ts"] < b for a, b in spans[name])

    # a kernel falls in the device span of its innermost range only: the
    # features' in fused_features, the model's in train_step
    kernels = [e for e in kernels if inside(e, "train_step")
               or inside(e, "fused_features")]
    feat = [e for e in kernels if inside(e, "fused_features")]
    total = sum(e["dur"] for e in kernels)
    # busy share, all from this trace: the device time of the steps' kernels
    # over the steps' lengths on the device, each from its features' first
    # kernel to its model's last
    steps = list(zip(sorted(spans["fused_features"]),
                     sorted(spans["train_step"])))
    if any(not (f[0] <= t[0] and f[1] <= t[1]) for f, t in steps):
        raise AssertionError(f"features and step spans interleave: {steps}")
    span_us = sum(t[1] - f[0] for f, t in steps)
    log(f"[profile] device kernels of the {n_steps} fused steps: "
        f"{total / 1e3:.2f} ms in {len(kernels)} launches "
        f"({total / 1e3 / n_steps:.2f} ms and {len(kernels) / n_steps:.0f} "
        f"launches a step); features "
        f"{sum(e['dur'] for e in feat) / 1e3 / n_steps:.2f} ms in "
        f"{len(feat) / n_steps:.0f} launches a step; a step spans "
        f"{span_us / 1e3 / n_steps:.2f} ms on the device, busy "
        f"{total / span_us:.1%}")
    for part, ks in (("step", kernels), ("features", feat)):
        by_name: dict = {}
        for e in ks:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"[profile]   {part:8s} {us / max(total, 1e-9):6.1%} of the "
                f"step {us / 1e3 / n_steps:8.3f} ms/step  {name[:100]}")
    # the path's kernels of this port, by the name of their __global__
    for k, fn in (("A", "tuning_tail_kernel"), ("B''", "gammatone_kernel"),
                  ("C", "suppress_kernel")):
        mine = [e for e in feat if fn in e["name"]]
        us = sum(e["dur"] for e in mine)
        log(f"[profile]   kernel {k}: {us / max(total, 1e-9):.2%} of the "
            f"step, {us / 1e3 / n_steps:.3f} ms/step in "
            f"{len(mine) / n_steps:.0f} launches/step")


def phase_bench(smi: str) -> dict:
    """The port's bench (tpu_breath_torch/bench.py) at its defaults, in
    this process: its line printed as {"bench": ...}. Fails unless every
    rate and latency is finite and positive, every MFU lies in (0, 1], the
    fused step's clips/s is at most the feature graph's alone (it does
    strictly more a clip), and A, C and B or B'' launched on its path.
    Returns the phase's launches."""
    from tpu_breath_torch import bench

    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # the line, printed below
        line = bench.main([])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    print(json.dumps({"bench": line}), flush=True)
    split = line["split"]
    rates = {k: line[k] for k in ("value", "feature_only_clips_per_s",
                                  "vgg_fused_clips_per_s",
                                  "cpu_oracle_clips_per_s")}
    rates.update({f"serve B={b} {q}": v[q]
                  for b, v in line["serve_ms"].items()
                  for q in ("median", "p90")})
    rates.update({f"{arch} {name} {k}": row[k]
                  for arch, pieces in split.items()
                  for name, row in pieces.items()
                  if isinstance(row, dict) and "mfu" in row
                  for k in ("ms", "clips_per_s")})
    rates.update({f"{arch} cached B={b}": row["ms"]
                  for arch, pieces in split.items()
                  for b, row in pieces["cached_batch_sweep"].items()})
    mfus = {k: line[k] for k in ("feature_mfu", "fused_train_mfu",
                                 "vgg_fused_train_mfu")}
    mfus.update({f"{arch} {name}": row["mfu"]
                 for arch, pieces in split.items()
                 for name, row in pieces.items()
                 if isinstance(row, dict) and "mfu" in row})
    log(f"[bench] bench.main at its defaults: {seconds:.1f} s; value "
        f"{line['value']:.1f} clips/s, feature only "
        f"{line['feature_only_clips_per_s']:.1f}, serve B=8 median "
        f"{line['serve_ms']['8']['median']:.2f} ms; launches {launches}; "
        f"{smi}")
    bad = [k for k, v in rates.items()
           if v is None or not (np.isfinite(v) and v > 0)]
    bad += [k for k, v in mfus.items()
            if v is None or not (np.isfinite(v) and 0 < v <= 1)]
    if bad:
        raise AssertionError(f"bench: out of range: {bad}")
    if not line["value"] <= line["feature_only_clips_per_s"]:
        raise AssertionError(f"bench: fused {line['value']} clips/s above "
                             f"the features alone")
    if min(launches["A"], launches["C"],
           max(launches["B"], launches["B''"])) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return {"launches": launches}


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
    counts no FLOPs), every bound one of the three, `full`'s FLOPs
    bench.feature_flops(128), each stage's bytes and kernel calls at B = 8
    the same counted on the card as on the CPU, A, C and B or B'' launched;
    (b) seed_sweep (cnn8, seeds 0 and 1, cached and fused, 2 epochs) on
    phase 6's dataset, then summarize on its directory: the two summaries
    agree on every key both hold; (c) ensemble_val on phase 6's CNN8 and
    VGG checkpoints: weights summing to 1, every metric in [0, 1]; (d)
    deviation_sweep (8 resampled clips) on phase 6's dataset, folded into a
    parity sweep (64 seeded clips, 16 through the oracle) by --deviations,
    inside the envelope; (e) find_flips on the parity phase's 512 clips:
    the flip count, and each flip's diagnose(). Returns the launches."""
    from tpu_breath_torch import bench, cli
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
    want = bench.feature_flops(report["chunk"])
    if stages["full"]["flops_per_chunk"] != want:
        bad.append(("full", "flops_per_chunk",
                    (stages["full"]["flops_per_chunk"], want)))
    y = torch.from_numpy(bench.noise(MICRO))
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
        + f"; full's FLOPs a chunk = bench.feature_flops({report['chunk']})"
        f" = {want}; bytes and kernel calls at B = {MICRO} the same on the "
        f"card as on the CPU; {times['roofline']:.1f} s")
    if bad:
        raise AssertionError(f"roofline out of range: {bad}")
    if min(launches["A"], launches["C"],
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


def phase_times(serve: dict, e2e: dict, fused: dict) -> None:
    from tpu_breath_torch import augment, ensemble
    from tpu_breath_torch.config import CNN8_TRAIN, DEFAULT_FEATURES, VGG_TRAIN
    from tpu_breath_torch.features import extract_features
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop
    from tpu_breath_torch.utils import path_times

    for b in (MICRO, CHUNK):
        y = torch.from_numpy(clip_set(b, seed=b)).cuda()
        # alternating order: default (B), fused (B''), fused, default
        ms = [cuda_ms(lambda: extract_features(y, fused_gt=fused), iters=5,
                      warmup=2) for fused in (False, True, True, False)]
        log(f"[time] extract_features B={b}: {ms[0]:.3f} ms "
            f"({ms[0] / b:.3f} ms/clip); default, fused_gt, fused_gt, "
            f"default: {', '.join(f'{m:.3f}' for m in ms)} ms")
    wavs = serve["wavs"][:MICRO]
    ensemble.serve_from_wav([serve["ckpt"]], ["cnn8"], [0.78], wavs,
                            device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ensemble.serve_from_wav([serve["ckpt"]], ["cnn8"], [0.78], wavs,
                            device="cuda")
    torch.cuda.synchronize()
    log(f"[time] serve_from_wav one micro-batch of {MICRO} (host clock, "
        f"model load included): {(time.perf_counter() - t0) * 1e3:.2f} ms")
    ms = path_times.serve_ms("cuda", reps=40, micro=MICRO)
    log(f"[time] serve, one micro-batch of {MICRO} wav -> probabilities, "
        f"CNN8 built once (utils/path_times.py, host clock, 40 calls): "
        f"median {np.median(ms):.2f} ms, p90 {np.percentile(ms, 90):.2f} ms")

    gen = torch.Generator(device="cuda").manual_seed(0)
    for arch, cfg in (("cnn8", CNN8_TRAIN), ("vgg", VGG_TRAIN)):
        b = cfg.batch_size
        model = registry.build(arch, 36).cuda()
        opt = loop.make_optimizer(model, cfg)
        batch = augment.Batch(
            torch.randn(b, 9, 128, 63, generator=gen, device="cuda"),
            torch.randn(b, 36, generator=gen, device="cuda"),
            (torch.rand(b, generator=gen, device="cuda") < 0.5).float())
        draws = augment.draw(gen, b, 128, 63, cfg.cutmix_alpha,
                             cfg.mixup_alpha, "cuda")
        plain_ms = cuda_ms(lambda: loop.train_step(model, opt, 1e-4, batch,
                                                   cfg), iters=10)
        aug_ms = cuda_ms(lambda: loop.train_step(model, opt, 1e-4, batch,
                                                 cfg, draws), iters=10)
        secs = [r["sec"] for r in e2e[arch][1:]]
        log(f"[time] {arch} train step, batch {b} (CUDA events, mean of "
            f"10): {plain_ms:.2f} ms without augmentation, {aug_ms:.2f} ms "
            f"with; e2e epoch wall time (2 steps + val of 256) median "
            f"{np.median(secs):.3f} s over epochs 2-6")
        # the fused step on b train clips, as train --fused runs it (B'')
        w = fused["wavs"][:b]
        with gt_switch():
            feat_ms = cuda_ms(lambda: loop.fused_features(w, DEFAULT_FEATURES),
                              iters=3, warmup=1)
            fb = augment.Batch(*loop.fused_features(w, DEFAULT_FEATURES),
                               batch.labels)
            model_ms = cuda_ms(lambda: loop.train_step(model, opt, 1e-4, fb,
                                                       cfg, draws), iters=10)
            step_ms = cuda_ms(lambda: loop.train_step(
                model, opt, 1e-4, augment.Batch(
                    *loop.fused_features(w, DEFAULT_FEATURES), fb.labels),
                cfg, draws), iters=3, warmup=1)
        fsecs = [r["sec"] for r in fused[arch][1:]]
        log(f"[time] {arch} fused train step, batch {b} (CUDA events): "
            f"{step_ms:.2f} ms (mean of 3) = features {feat_ms:.2f} ms "
            f"(4 chunks of 128, mean of 3) + model {model_ms:.2f} ms (with "
            f"augmentation, mean of 10); fused epoch wall time (2 steps + "
            f"val of 256) median {np.median(fsecs):.3f} s over epochs 2-6")
        del model, opt, batch, fb
    log(f"[time] precompute, 1,536 clips (TPU_BREATH_PALLAS_GT=1): "
        f"{e2e['precompute_line']}; whole command {e2e['precompute_s']:.2f} "
        f"s with decode; train cnn8,vgg 6 epochs + predict "
        f"{e2e['train_s']:.2f} s")


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
    parity = phase_parity(env["smi"])
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(tmp)
        e2e = phase_e2e(tmp)
        repro = phase_repro(tmp, e2e)
        scope_cost(env["smi"])
        fused = phase_fused(tmp)
        mesh = phase_mesh(tmp, env["smi"])
        phase_profile(tmp)
        bench = phase_bench(env["smi"])
        tools = phase_tools(tmp, env["smi"])
        phase_times(serve, e2e, fused)
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
    ]
    # launches: each path counted from 0 just before it runs; times at the
    # precompute chunk (B = 128). No single PyTorch call computes A-C;
    # D's library time is conv1d's (its complex response, no |.|)
    paths = {"serve": serve["launches"], "e2e": e2e["launches"],
             "repro": repro["launches"], "fused": fused["launches"], "mesh": mesh["launches"],
             "parity": parity["launches"], "bench": bench["launches"],
             "tools": tools["launches"]}
    kernels = [{"name": name, "route": "cuda", "source": f"{src}/{f}",
                "replaces": f"{pallas}/{rep}",
                "launches": sum(p[k] for p in paths.values()),
                "launches_by_path": {n: p[k] for n, p in paths.items()},
                "max_abs_err": ker[k]["err"], "ms": ker[k][CHUNK][0],
                "plain_ms": ker[k][CHUNK][1], "primed_ms": ker[k][CHUNK][2],
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
