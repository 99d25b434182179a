"""Chip smoke test of the PyTorch/CUDA port (tpu_breath_torch) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):
  1. environment: torch/CUDA versions, the card's name and power limit;
     fails without a CUDA device;
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the time;
  3. each kernel against its plain PyTorch version on the card, at the
     serving shapes with B = 8 and B = 128 (golden wavs + seeded noise,
     silence, an impulse, quantized plateaus);
  4. extract_features on the card for the golden wavs, against the golden
     npz and against the port's CPU result;
  5. serve: seeded CNN8 checkpoint, `predict --from-wav --archs cnn8` through
     cli.main on cuda; every kernel's launch count must be > 0;
  6. timings (CUDA events): kernels vs plain versions, extract_features and
     one serve call, per micro-batch of 8 and per chunk of 128;
  7. the last line: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 16000
MICRO = 8
CHUNK = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def kernel_inputs(y: torch.Tensor) -> dict:
    """The kernels' inputs as the main path builds them from clips y."""
    from tpu_breath_torch.ops import chroma, dft, peaks, spectral

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
    return {"p12": p12, "m12": m12, "p36": p36, "m36": m36, "mag": s512,
            "fb": fb, "scores": scores}


def phase_kernels() -> dict:
    """Kernel vs plain on the card; returns errors and times per kernel."""
    import scipy.signal
    from tpu_breath_torch.ops import dft
    from tpu_breath_torch.ops.cuda import (epilogue_kernel as ek,
                                           peaks_kernel as pk,
                                           tuning_kernel as tk)

    rounds = SR // (SR // 10) + 2
    res = {"A": {"err": 0.0}, "B": {"err": 0.0}, "C": {"err": 0.0}}
    for b in (MICRO, CHUNK):
        y = torch.from_numpy(clip_set(b, seed=b)).cuda()
        x = kernel_inputs(y)
        # kernel -> (kernel call, plain call) at this batch's main-path shapes
        calls = {
            "A": tuple(lambda f=f: (f(x["p12"], x["m12"], 12),
                                    f(x["p36"], x["m36"], 36))
                       for f in (tk.estimate_tuning_index,
                                 tk.estimate_tuning_index_plain)),
            "B": tuple(lambda f=f: f(x["mag"], x["fb"])
                       for f in (ek.fused_epilogue, ek.fused_epilogue_plain)),
            "C": tuple(lambda f=f: f(x["scores"], SR // 10, rounds)
                       for f in (pk.suppress_peaks, pk.suppress_peaks_plain)),
        }
        out = {k: (run(), plain()) for k, (run, plain) in calls.items()}
        torch.cuda.synchronize()
        for (got, ref), bpo in zip(zip(*out["A"]), (12, 36)):
            if not torch.equal(got, ref):
                raise AssertionError(f"kernel A bpo {bpo} B {b}: "
                                     f"{got.tolist()} != {ref.tolist()}")
        got, ref = out["B"]
        err_b = float((got - ref).abs().max())
        if not err_b <= 1e-5:
            raise AssertionError(f"kernel B B {b}: max abs err {err_b}")
        (vals, kept), (rvals, rkept) = out["C"]
        err_c = float((vals - rvals).abs().max())
        if not torch.equal(kept, rkept) or not err_c <= 1e-5:
            raise AssertionError(f"kernel C B {b}: kept equal "
                                 f"{torch.equal(kept, rkept)}, err {err_c}")
        env = dft.hilbert_envelope(y).cpu().numpy()
        for i in range(b):
            peaks, _ = scipy.signal.find_peaks(
                env[i], height=float(env[i].mean()), distance=SR // 10)
            if int(kept[i].sum()) != len(peaks):
                raise AssertionError(f"kernel C clip {i}: "
                                     f"{int(kept[i].sum())} != {len(peaks)}")
        res["B"]["err"] = max(res["B"]["err"], err_b)
        res["C"]["err"] = max(res["C"]["err"], err_c)
        log(f"[kernels] B={b}: A exact at bpo 12/36, B err {err_b:.3g}, "
            f"C kept exact (= scipy counts), vals err {err_c:.3g}")
        for k, (run, plain) in calls.items():
            res[k][b] = (cuda_ms(run), cuda_ms(plain))
            log(f"[time] kernel {k} B={b}: {res[k][b][0]:.4f} ms, plain "
                f"{res[k][b][1]:.4f} ms")
    return res


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
    from tpu_breath_torch.ops.cuda import (epilogue_kernel, peaks_kernel,
                                           tuning_kernel)
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
    mods = (tuning_kernel, epilogue_kernel, peaks_kernel)
    for m in mods:
        m.LAUNCHES = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {m.__name__.rsplit(".", 1)[-1]: m.LAUNCHES for m in mods}
    log(f"[serve] predict --from-wav ({len(paths)} clips) in {serve_s:.2f} s "
        f"(first call, includes model load); launches {launches}")
    if min(launches.values()) <= 0:
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


def phase_times(serve: dict) -> None:
    from tpu_breath_torch import ensemble
    from tpu_breath_torch.features import extract_features

    for b in (MICRO, CHUNK):
        y = torch.from_numpy(clip_set(b, seed=b)).cuda()
        ms = cuda_ms(lambda: extract_features(y), iters=5, warmup=2)
        log(f"[time] extract_features B={b}: {ms:.3f} ms "
            f"({ms / b:.3f} ms/clip)")
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


def main() -> int:
    env = phase_env()
    phase_build()
    ker = phase_kernels()
    phase_features()
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(tmp)
        phase_times(serve)
    src = "tpu_breath_torch/csrc"
    table = [
        ("tuning_index", "tuning_kernel", "tuning_kernel.cu",
         "tpu_breath/ops/pallas/tuning_kernel.py:125", "A"),
        ("fused_epilogue", "epilogue_kernel", "epilogue_kernel.cu",
         "tpu_breath/ops/pallas/epilogue_kernel.py:160", "B"),
        ("suppress_peaks", "peaks_kernel", "peaks_kernel.cu",
         "tpu_breath/ops/pallas/peaks_kernel.py:78", "C"),
    ]
    kernels = [{"name": name, "route": "cuda", "source": f"{src}/{f}",
                "replaces": rep, "launches": serve["launches"][mod],
                "max_abs_err": ker[k]["err"], "ms": ker[k][MICRO][0],
                "plain_ms": ker[k][MICRO][1]}
               for name, mod, f, rep, k in table]
    print(env["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
