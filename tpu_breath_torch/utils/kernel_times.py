"""Kernels A, B, B', B'', C, D and E of this checkout on the card: their times
on two timers, and their outputs kept for comparing two checkouts bit for
bit.

    python -m tpu_breath_torch.utils.kernel_times --out T.json [--save O.pt]
        [--kernels D "B'"]
    python -m tpu_breath_torch.utils.kernel_times --compare O1.pt O2.pt

The inputs are chip_smoke.py's kernel inputs (this module builds them for
both): the golden wavs, silence, an impulse, a quantized clip, then seeded
noise, at B = 8 and 128; and kernel C's dense worst case, a candidate every
other sample; kernel D (on no path) takes the clips themselves, at the
shapes of its function (cqt_args); kernel E the clips pre-emphasised, as
ops/lpc.py gives them. Each kernel and its plain version is timed by
profiling.device_ms over 20 back-to-back calls after 3 warm-ups, unprimed
(where the host queues a call more slowly than the card runs it, the host
sets the pace) and primed (a spin kernel first holds the stream, so the
card runs the calls back to back: the card's time alone). Copied into the
package of an earlier checkout (with utils/profiling.py where that one has
no device_ms), it times that checkout's kernels by the same code: to
compare two checkouts, run both in one call, alternating. --compare says,
for each kernel and batch, whether two saved outputs are bit-equal.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess

import numpy as np
import torch

from tpu_breath_torch.utils.profiling import device_ms

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SR = 16000
LAUNCHES, WARMUP = 20, 3  # the kernel table's timer


def table_times(run, plain) -> dict:
    """A kernel's call and its plain version's, each timed by
    profiling.device_ms over LAUNCHES back-to-back calls after WARMUP,
    unprimed (the kernel table's `ms`) and primed."""
    def ms(fn, primed):
        return device_ms(fn, "cuda", LAUNCHES, warmup=WARMUP,
                         primed=primed)[0]
    return {"ms": ms(run, False), "plain_ms": ms(plain, False),
            "primed_ms": ms(run, True), "plain_primed_ms": ms(plain, True)}


def golden() -> list[dict]:
    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures",
                                          "golden_*.npz")))
    if len(paths) < 2:
        raise FileNotFoundError("golden fixtures missing")
    return [dict(np.load(p)) for p in paths]


def clip_set(n: int, seed: int) -> np.ndarray:
    """[n, 16000]: the golden wavs, silence, an impulse, a quantized
    (plateau-heavy) clip, then seeded noise of varying loudness."""
    rng = np.random.default_rng(seed)
    clips = [d["wav"] for d in golden()]
    clips.append(np.zeros(SR, np.float32))
    imp = np.zeros(SR, np.float32)
    imp[SR // 2] = 0.5
    clips.append(imp)
    clips.append(np.round(rng.standard_normal(SR) * 4) / 64)
    while len(clips) < n:
        amp = 10.0 ** rng.uniform(-3, -0.5)
        clips.append(rng.standard_normal(SR) * amp)
    return np.stack(clips[:n]).astype(np.float32)


def kernel_inputs(y: torch.Tensor) -> dict:
    """The kernels' inputs as the main path builds them from clips y."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.ops import chroma, dft, lpc, peaks, spectral

    s512 = spectral.stft_mag_cr(y, 512, 256).contiguous()
    s2048 = spectral.stft_mag_cr(y, 2048, 256)[..., ::2]
    p12, m12 = (t.contiguous() for t in chroma._piptrack_band(s512, SR, 512))
    p36, m36 = (t.contiguous() for t in chroma._piptrack_band(s2048, SR,
                                                              2048))
    env = dft.hilbert_envelope(y)
    scores = torch.where(peaks.local_maxima(env)
                         & (env >= env.mean(-1, keepdim=True)), env,
                         -torch.inf).contiguous()
    fb = spectral.device_const(spectral.mel_matrix, SR, 512, 64,
                               device=y.device)
    yp = torch.nn.functional.pad(y, (256, 256))
    frames = spectral.frame_signal(yp, 512, 256, 1 + y.shape[-1] // 256
                                   ).contiguous()
    basis = spectral.device_const(spectral.framedft_basis, 512,
                                  device=y.device)
    y_emph, window, hop, n_frames = lpc.lpc_args(y, SR)
    return {"p12": p12, "m12": m12, "p36": p36, "m36": m36, "mag": s512,
            "fb": fb, "scores": scores, "frames": frames, "basis": basis,
            "y": y, "lpc": (y_emph, window, hop, n_frames, SPEC.n_lpc)}


def dense_scores(b: int, seed: int) -> torch.Tensor:
    """Kernel C's worst case on the card: a candidate every other sample
    (8,000 a clip) at seeded heights, -inf between: [b, 16000]."""
    rng = np.random.default_rng(seed)
    s = np.full((b, SR), -np.inf, np.float32)
    s[:, ::2] = rng.uniform(0.1, 1.0, (b, SR // 2))
    return torch.from_numpy(s).cuda()


def cqt_args() -> tuple:
    """Kernel D's arguments after y: sr, hop, fmin (C1), bins, bins per
    octave: the JAX package's test of its Pallas kernel."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    return (SR, SPEC.hop_length, SPEC.cqt_fmin, 252, 36)


def calls(x: dict, dense: torch.Tensor) -> dict:
    """kernel -> (kernel call, plain call) on inputs x and dense."""
    from tpu_breath_torch.ops.cuda import (cqt_kernel as ck,
                                           epilogue_kernel as ek,
                                           gammatone_kernel as gk,
                                           lpc_kernel as lk,
                                           peaks_kernel as pk,
                                           tuning_kernel as tk)

    d = SR // 10
    rounds = SR // d + 2
    return {
        # a feature call's two calls of kernel A, bpo 12 and 36
        "A": tuple(lambda f=f: (f(x["p12"], x["m12"], 12),
                                f(x["p36"], x["m36"], 36))
                   for f in (tk.estimate_tuning_index,
                             tk.estimate_tuning_index_plain)),
        "B": tuple(lambda f=f: f(x["mag"], x["fb"])
                   for f in (ek.fused_epilogue, ek.fused_epilogue_plain)),
        "B'": tuple(lambda f=f: f(x["mag"], x["fb"], plain=True)
                    for f in (ek.fused_epilogue, ek.fused_epilogue_plain)),
        "B''": tuple(lambda f=f: f(x["frames"], x["basis"], x["fb"])
                     for f in (gk.fused_gammatone,
                               gk.fused_gammatone_plain)),
        "C": tuple(lambda f=f: f(x["scores"], d, rounds)
                   for f in (pk.suppress_peaks, pk.suppress_peaks_plain)),
        "C dense": tuple(lambda f=f: f(dense, d, rounds)
                         for f in (pk.suppress_peaks,
                                   pk.suppress_peaks_plain)),
        "D": tuple(lambda f=f: f(x["y"], *cqt_args())
                   for f in (ck.cqt_mag, ck.cqt_mag_plain)),
        "E": tuple(lambda f=f: f(*x["lpc"])
                   for f in (lk.lpc_frames, lk.lpc_frames_plain)),
    }


def measure(kernels=None) -> tuple[dict, dict]:
    """Times {kernel: {B: {ms, plain_ms, primed_ms, plain_primed_ms}}} and
    outputs {"kernel B=b": tensor or tuple of tensors, on the CPU}, of the
    kernels named (all if None)."""
    times: dict = {}
    outputs = {}
    for b in (8, 128):
        x = kernel_inputs(torch.from_numpy(clip_set(b, seed=b)).cuda())
        for k, (run, plain) in calls(x, dense_scores(b, seed=b)).items():
            if kernels is not None and k not in kernels:
                continue
            got = run()
            torch.cuda.synchronize()
            outputs[f"{k} B={b}"] = (tuple(t.cpu() for t in got)
                                     if isinstance(got, tuple) else got.cpu())
            t = times.setdefault(k, {})[b] = table_times(run, plain)
            print(f"[kernel_times] {k} B={b}: {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms; primed {t['primed_ms']:.4f} ms, "
                  f"plain {t['plain_primed_ms']:.4f} ms", flush=True)
    return times, outputs


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_equal, a, b))
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the times here (JSON)")
    ap.add_argument("--save", help="write the outputs here (torch.save)")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="two saved outputs: which are bit-equal")
    ap.add_argument("--kernels", nargs="+", metavar="K",
                    help="time only these (names as in calls: B, B', B'', "
                         "C, 'C dense', D, E)")
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (torch.load(p) for p in args.compare)
        for key in sorted(set(a) & set(b)):
            print(f"[kernel_times] {key}: "
                  f"{'bit-equal' if _equal(a[key], b[key]) else 'differs'}")
        return
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[kernel_times] {ROOT}: {smi}", flush=True)
    times, outputs = measure(args.kernels)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"root": ROOT, "smi": smi, "times": times}, f, indent=1)
    if args.save:
        torch.save(outputs, args.save)


if __name__ == "__main__":
    main()
