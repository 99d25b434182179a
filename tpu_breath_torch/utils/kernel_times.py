"""Kernels A, B, B', B'', C, D, E and F of this checkout on the card: their
times on two timers, and their outputs kept for comparing two checkouts bit
for bit.

    python -m tpu_breath_torch.utils.kernel_times --out T.json [--save O.pt]
        [--kernels D "B'" F]
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
card runs the calls back to back: the card's time alone). Kernel F (a
ConvBlock's BatchNorm and activation) is timed apart, at every distinct
ConvBlock shape of CNN8 and VGG at B = 512 in bf16 (the training step's),
primed (bn_act_times): a training forward and backward of the kernels and
of the plain version (torch's BatchNorm and activation), and each of the
kernels' four passes beside its bound by ops/cuda/work.py.
Copied into the
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


def convblock_shapes(arch: str) -> list[tuple]:
    """(C, H, W, order, conv bias) of each ConvBlock output of `arch` on the
    features' 9 x 128 x 63, in the body's order (a forward at B = 1 on the
    CPU)."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.models.layers import ConvBlock

    model = registry.build(arch, 36).eval()
    seen = []
    for m in model.modules():
        if isinstance(m, ConvBlock):
            m.register_forward_hook(lambda m, i, o: seen.append(
                (*o.shape[1:], m.order, m.conv.bias is not None)))
    with torch.no_grad():
        model(torch.zeros(1, 9, SPEC.n_mels, SPEC.t_fixed),
              torch.zeros(1, 36))
    return seen


def bn_act_inputs(c: int, h: int, w: int, b: int, dtype: torch.dtype,
                  conv_bias: bool, seed: int) -> dict:
    """Seeded inputs of a ConvBlock's BatchNorm and activation on the card:
    x [b, c, h, w] channels-last in dtype (a convolution's output: normal,
    std 2, mean 0.3), dz likewise (std 1), the f32 parameters (the conv
    bias if asked) and running statistics."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cl = torch.channels_last

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    return {"x": (randn(b, c, h, w) * 2 + 0.3).to(dtype).contiguous(
                memory_format=cl),
            "dz": randn(b, c, h, w).to(dtype).contiguous(memory_format=cl),
            "conv_bias": randn(c) * 0.3 if conv_bias else None,
            "weight": torch.rand(c, generator=g, device="cuda") + 0.5,
            "bias": randn(c) * 0.2,
            "running_mean": randn(c) * 0.1,
            "running_var": torch.rand(c, generator=g, device="cuda") + 0.5}


def bn_act_step(fn, v: dict, order: str, training: bool = True):
    """One forward and backward of fn (bn_act or bn_act_plain) on inputs v
    (the running statistics updated in place in training): z and the
    gradients of x and the parameters (conv bias if any, gamma, beta) by
    dz."""
    x = v["x"].detach().requires_grad_()
    params = [p.requires_grad_() for p in (v["conv_bias"], v["weight"],
                                           v["bias"]) if p is not None]
    z = fn(x, v["conv_bias"], v["weight"], v["bias"], v["running_mean"],
           v["running_var"], order, training)
    return (z, *torch.autograd.grad(z, [x, *params], v["dz"]))


def bn_act_errors(v: dict, order: str, training: bool) -> dict:
    """Kernel F against its plain version in float64 on copies of inputs
    v: {output: (max abs error, its largest share of the tolerance)} for z,
    dx, the conv bias's (if any), gamma's and beta's gradients and the
    running statistics after the step; a share above 1 is a failure.
    Tolerances: z and dx are rounded to their dtype once (bf16 2^-8 of the
    value, f32 1e-5) beside f32 arithmetic in the kernel (1e-4 of the
    largest value: the sums' errors over up to 4.1M rows reach dx through
    its two coefficients); the parameter gradients are f32 sums of up to
    4.1M products (1e-3 of the value and of the largest); the statistics
    f32 Welford and Chan merges (1e-5 of the value and 1e-6)."""
    from tpu_breath_torch.ops.cuda import bn_act_kernel as bk

    runs = []
    for fn, dtype in ((bk.bn_act, None), (bk.bn_act_plain, torch.float64)):
        u = {k: None if t is None else t.detach().clone().to(dtype or t.dtype)
             for k, t in v.items()}
        runs.append([t.detach() for t in bn_act_step(fn, u, order, training)]
                    + [u["running_mean"], u["running_var"]])
    rel = 2.0 ** -8 if v["x"].dtype == torch.bfloat16 else 1e-5
    names = ["z", "dx"] + (["d_conv_bias"] if v["conv_bias"] is not None
                           else []) + ["d_gamma", "d_beta", "running_mean",
                                       "running_var"]
    out = {}
    for name, a, ref in zip(names, *runs):
        a, ref = a.double(), ref.double()
        top = float(ref.abs().max())
        if name in ("z", "dx"):
            bound = rel * ref.abs() + 1e-4 * top
        elif name.startswith("running"):
            bound = 1e-5 * ref.abs() + 1e-6
        else:
            bound = 1e-3 * ref.abs() + 1e-3 * top
        err = (a - ref).abs()
        # 0 / 0 is within the tolerance, x / 0 past it
        out[name] = (float(err.max()),
                     float((err / bound).nan_to_num(nan=0.0).max()))
    return out


def bn_act_times(b: int = 512, dtype: torch.dtype = torch.bfloat16
                 ) -> list[dict]:
    """Kernel F at each distinct ConvBlock shape of CNN8 and VGG: primed ms
    of a training forward and backward (ms) and of the plain version
    (plain_ms: torch's BatchNorm and activation, the library's time too);
    each pass's primed ms beside its bound (bytes over HBM) and its share
    of it; the least time of the whole step (bound_ms)."""
    from tpu_breath_torch.ops.cuda import bn_act_kernel as bk
    from tpu_breath_torch.ops.cuda import work

    def ms(fn):
        return device_ms(fn, "cuda", LAUNCHES, warmup=WARMUP, primed=True)[0]

    rows = []
    shapes = {}
    for arch in ("cnn8", "vgg"):
        for shape in convblock_shapes(arch):
            shapes.setdefault(shape, []).append(arch)
    for (c, h, w, order, cb), archs in shapes.items():
        v = bn_act_inputs(c, h, w, b, dtype, cb, seed=c * h)
        x, dz = v["x"], v["dz"]
        stream = torch.cuda.current_stream().cuda_stream
        m = x.numel() // c
        mean, var = bk.stats_pass(x, v["conv_bias"], v["running_mean"],
                                  v["running_var"], order, 0.1, stream)
        passes = {
            "stats": lambda: bk.stats_pass(
                x, v["conv_bias"], v["running_mean"], v["running_var"],
                order, 0.1, stream),
            "apply": lambda: bk.apply_pass(x, v["conv_bias"], mean, var,
                                           v["weight"], v["bias"], order,
                                           1e-5, stream),
            "reduce": lambda: bk.reduce_pass(dz, x, v["conv_bias"], mean,
                                             var, v["weight"], v["bias"],
                                             order, True, 1e-5, stream),
        }
        sums = passes["reduce"]()
        passes["elemt"] = lambda: bk.elemt_pass(
            dz, x, v["conv_bias"], mean, var, v["weight"], v["bias"], sums,
            order, 1e-5, stream)
        row = {"shape": [b, c, h, w], "order": order, "conv_bias": cb,
               "models": archs, "dtype": str(dtype).split(".")[-1],
               "ms": ms(lambda: bn_act_step(bk.bn_act, v, order)),
               "plain_ms": ms(lambda: bn_act_step(bk.bn_act_plain, v,
                                                  order)),
               "passes": {}}
        bound = 0.0
        for name, run in passes.items():
            lo = work.bn_act(m, c, x.element_size(), name, order,
                             cb).bound_ms()[0]
            t = ms(run)
            row["passes"][name] = {"ms": t, "bound_ms": lo,
                                   "roofline": lo / t}
            bound += lo
        row["bound_ms"] = bound
        print(f"[kernel_times] F {b}x{c}x{h}x{w} {order}: {row['ms']:.4f} "
              f"ms (plain {row['plain_ms']:.4f}, bound {bound:.4f}); passes "
              + ", ".join(f"{k} {p['ms']:.4f} ({100 * p['roofline']:.1f}%)"
                          for k, p in row["passes"].items()), flush=True)
        rows.append(row)
    return rows


def measure(kernels=None) -> tuple[dict, dict]:
    """Times {kernel: {B: {ms, plain_ms, primed_ms, plain_primed_ms}}} (F:
    bn_act_times' rows) and outputs {"kernel B=b": tensor or tuple of
    tensors, on the CPU}, of the kernels named (all if None)."""
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
    if kernels is None or "F" in kernels:
        times["F"] = bn_act_times()
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
                         "C, 'C dense', D, E; F)")
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
